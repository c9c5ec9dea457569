"""The hand-written kernels' share of their roofline in the traced
sub-window, in percent: the least time of every ``flash_attn``,
``dense_attention`` and ``add_layer_norm`` launch (its bytes at the HBM
rate or its operations at the peak, whichever is longer, from the launch's
shapes) summed, over the device time the trace gives those launches.

The shapes come from the buckets the traced ``run_many`` calls
dispatched; each family's bound is scaled by the launches the trace shows
over those the forwards should have made, so a kernel taken off the path
leaves its family out rather than counting work that did not run."""

from portbench.bounds import KERNEL_NAMES, forward_kernel_bounds


def read(run):
    tr = run.records.get("trace")
    buckets = run.records.get("traced_buckets")
    if tr is None or not buckets:
        return None
    m, e = run.config["model"], run.config["engine"]
    expected = {f: [0, 0.0] for f in KERNEL_NAMES}
    for b in buckets:
        for f, (n, t) in forward_kernel_bounds(m, e, b).items():
            expected[f][0] += n
            expected[f][1] += t
    bound = spent = 0.0
    for f, key in KERNEL_NAMES.items():
        ks = [k for k in tr["obj"].kernels() if key in str(k["name"])]
        if not ks or not expected[f][0]:
            continue
        bound += expected[f][1] * len(ks) / expected[f][0]
        spent += sum(float(k["dur"]) for k in ks) / 1e6
    if spent == 0.0:
        return None
    return 100.0 * bound / spent
