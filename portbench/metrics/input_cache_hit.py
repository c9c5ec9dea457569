"""The device input cache's hits over its lookups in the window, from
``InferenceEngine.input_cache_stats`` before and after, in percent (in a
traced run, up to the moment the profiler starts)."""


def read(run):
    rec = run.records.get("untraced", run.records)
    h, m = rec.get("cache_hits"), rec.get("cache_misses")
    if h is None or h + m == 0:
        return None
    return 100.0 * h / (h + m)
