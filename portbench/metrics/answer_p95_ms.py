"""95th percentile over every gallery question due in the window, from its
due time to its decoded answer; a question that failed or never came is
missing (infinite)."""

import math

from portbench.harness import quantile


def read(run):
    lat = run.records.get("answer_latency_s")
    if not lat:
        return None
    v = quantile(lat, 0.95)
    return v * 1e3 if math.isfinite(v) else None
