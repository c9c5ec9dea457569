"""95th percentile over every upload due in the window, from its due time
to its decoded answer; an upload that failed or never came is missing
(infinite). In a traced run only the uploads due before the profiler
starts count: the profiler slows the host, and the queue behind it."""

import math

from portbench.harness import quantile


def due_before_trace(run, key="upload_latency_s"):
    """The run's per-upload times under ``key``; of a traced run only
    those of the uploads due before its profiler started."""
    times = run.records.get(key) or []
    start = run.records.get("trace_start")
    if start is not None:
        dues = run.records["upload_due_s"]
        times = [x for x, d in zip(times, dues) if d < start]
    return times


def read(run):
    lat = due_before_trace(run)
    if not lat:
        return None
    v = quantile(lat, 0.95)
    return v * 1e3 if math.isfinite(v) else None
