"""Host time the detector's forward takes to enqueue its work, per traced
upload: the mean length of the program's ``detect.enqueue`` spans in the
traced window (the profiler's own cost included)."""

from portbench import spans


def read(run):
    got = spans.window(run)
    if got is None:
        return None
    ms = [s.dur_s * 1e3 for s in spans.named(got, "detect.enqueue")]
    return sum(ms) / len(ms) if ms else None
