"""Model FLOPs of the image rows answered in the window (not of the padded
rows the buckets add), over the window's seconds times the card's dense
bf16 peak, in percent (in a traced run, up to the moment the profiler
starts). The FLOPs are the frozen count of ``portbench/bounds.py``."""

from portbench.bounds import PEAK_BF16_FLOPS, serving_forward_flops


def read(run):
    rec = run.records.get("untraced", run.records)
    if not rec.get("rows"):
        return None
    flops = serving_forward_flops(run.config["model"], run.config["engine"],
                                  rec["rows"])
    return 100.0 * flops / (rec["window_s"] * PEAK_BF16_FLOPS)
