"""Device time of the extractor's kernels per traced upload: the kernels
launched from the serving thread between each ``detect.preprocess`` range
and the end of the next ``detect.host_copy`` range (the program's own
ranges), summed per image, mean over the traced images."""


def per_image_s(tr):
    """Device seconds of each traced image's extraction kernels."""
    t = tr["obj"]
    starts = t.range_spans("detect.preprocess")
    ends = t.range_spans("detect.host_copy")
    out = []
    for s, _ in starts:
        after = [e for _, e in ends if e >= s]
        if not after:
            continue
        ops = t.launched_by(t.range_tid("detect.preprocess"),
                            [(s, min(after))])
        ks = [k for k in ops if k.get("cat") == "kernel"]
        if ks:
            out.append(sum(float(k["dur"]) for k in ks) / 1e6)
    return out


def read(run):
    tr = run.records.get("trace")
    if tr is None:
        return None
    times = per_image_s(tr)
    return sum(times) / len(times) * 1e3 if times else None
