"""``torch.cuda.max_memory_allocated`` over set-up and window, in MiB: the
card memory one replica needs."""


def read(run):
    return run.memory_peak / 2 ** 20 if run.memory_peak else None
