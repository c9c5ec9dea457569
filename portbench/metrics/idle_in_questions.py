"""The share of the traced window in which the device sat idle while the
question thread (``questions``) was inside the program's
``engine.prepare`` or ``engine.run_many`` spans, in percent. The
profiler records host ranges of the upload thread only, so the question
thread's spans are placed on the trace's clock by the offset calibrated
on the upload thread's (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    got = spans.window(run)
    if got is None:
        return None
    trace = run.records["trace"]["obj"]
    cal = spans.calibrate(trace, got)
    held = spans.named(got, "engine.prepare", "engine.run_many",
                       thread="questions")
    if cal is None or not held or not trace.window_s:
        return None
    offset = cal[0]
    placed = [(s.start_s * 1e6 + offset, (s.start_s + s.dur_s) * 1e6
               + offset) for s in held]
    return 100.0 * spans.idle_inside(trace, placed) / trace.window_s
