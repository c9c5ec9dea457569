"""Host preparation per question: the benchmark's clock around the
``prepare_from_store`` calls of the question thread (tokenize, feature
file, region encode), over the questions they prepared. In a traced run
only the calls begun before the profiler starts count: the profiler slows
the host."""


def read(run):
    preps = run.records.get("preps")
    start = run.records.get("trace_start")
    if start is not None:
        preps = [p for p in preps or [] if p[0] < start]
    n = sum(k for _, _, k in preps or [])
    if not n:
        return None
    return sum(s for _, s, _ in preps) / n * 1e3
