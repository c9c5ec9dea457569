"""Device time of a chunk's forward in the traced window, from the trace:
the union of the device operations launched from inside the program's
``engine.replay`` ranges (the static pack's copy, the graph's kernels or
the eager forward's, the bundle's copy), over the ranges, in ms. The
host's launch, which the profiler slows while the card waits, is not in
it."""

from portbench.bounds import union_s


def read(run):
    tr = run.records.get("trace")
    if tr is None:
        return None
    t = tr["obj"]
    ranges = t.range_spans("engine.replay")
    if not ranges:
        return None
    ops = t.launched_by(t.range_tid("engine.replay"), ranges)
    busy = [(max(float(e["ts"]), t.t0),
             min(float(e["ts"]) + float(e["dur"]), t.t1)) for e in ops]
    busy = [(a, b) for a, b in busy if b > a]
    return union_s(busy) / 1e3 / len(ranges) if busy else None
