"""The int8 GEMM's share of its roofline in the traced sub-window, in
percent: the least time of every ``int8_linear`` launch (its bytes at the
HBM rate or its operations at the bf16 peak, whichever is longer; the
bytes and operations of ``portbench/int8_bounds.py``) summed, over the
device time the trace gives those launches.

The shapes come from the configuration and the buckets the traced
``run_many`` calls dispatched, not from the program's plan; the bound is
scaled by the launches the trace shows over those the forwards should have
made, as ``kernels_roofline`` scales each family."""

from portbench.int8_bounds import KERNEL_NAME, forward_int8_bound


def read(run):
    tr = run.records.get("trace")
    buckets = run.records.get("traced_buckets")
    if tr is None or not buckets:
        return None
    m, e = run.config["model"], run.config["engine"]
    launches, bound = 0, 0.0
    for b in buckets:
        n, t = forward_int8_bound(m, e, b)
        launches += n
        bound += t
    ks = [k for k in tr["obj"].kernels() if KERNEL_NAME in str(k["name"])]
    spent = sum(float(k["dur"]) for k in ks) / 1e6
    if not ks or not launches or spent == 0.0:
        return None
    return 100.0 * bound * len(ks) / launches / spent
