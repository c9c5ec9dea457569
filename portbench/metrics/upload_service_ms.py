"""Mean service time of an upload: from the moment the worker takes it up
(its due time, or the previous upload's answer where it queued) to its
decoded answer, over every upload due in the window: what an upload
costs when no other waits before it. An upload that failed or never came
is missing (infinite). In a traced run only the uploads due before the
profiler starts count."""

import math

from portbench.harness import load_module


def read(run):
    times = load_module("metrics", "upload_p95_ms").due_before_trace(
        run, "upload_service_s")
    if not times or not all(math.isfinite(t) for t in times):
        return None
    return sum(times) / len(times) * 1e3
