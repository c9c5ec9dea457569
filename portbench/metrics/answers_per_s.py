"""Decoded answers completed inside the window, over the window's seconds
(the benchmark's clock)."""


def read(run):
    if "answers" not in run.records:
        return None
    return run.records["answers"] / run.records["window_s"]
