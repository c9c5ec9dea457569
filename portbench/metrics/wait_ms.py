"""Mean wait of a gallery question for the engine: from its due time to the
``run_many`` call that carries it (its preparation included). In a traced
run only the questions due before the profiler starts count: the
profiler slows the host, and the waits with it."""


def read(run):
    waits = run.records.get("waits")
    start = run.records.get("trace_start")
    if start is not None:
        waits = [w for w in waits or [] if w[0] < start]
    if not waits:
        return None
    return sum(w for _, w in waits) / len(waits) * 1e3
