"""The share of the traced sub-window in which no operation (kernel, copy
or set) ran on the device, in percent."""


def read(run):
    tr = run.records.get("trace")
    if tr is None or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
