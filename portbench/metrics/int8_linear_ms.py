"""Device time of a chunk's ``int8_linear`` launches in the traced window,
from the trace: the union of the int8 GEMM's kernels among the device
operations launched from inside the program's ``engine.replay`` ranges,
over the ranges, in ms (``chunk_device_ms`` is the same over every
operation)."""

from portbench.bounds import union_s
from portbench.int8_bounds import KERNEL_NAME


def read(run):
    tr = run.records.get("trace")
    if tr is None:
        return None
    t = tr["obj"]
    ranges = t.range_spans("engine.replay")
    if not ranges:
        return None
    ops = t.launched_by(t.range_tid("engine.replay"), ranges)
    busy = [(max(float(e["ts"]), t.t0),
             min(float(e["ts"]) + float(e["dur"]), t.t1)) for e in ops
            if e.get("cat") == "kernel" and KERNEL_NAME in str(e["name"])]
    busy = [(a, b) for a, b in busy if b > a]
    return union_s(busy) / 1e3 / len(ranges) if busy else None
