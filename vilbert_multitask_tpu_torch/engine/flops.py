"""Byte counts of the served weights.

Counterpart of ``param_tree_bytes`` in ``vilbert_multitask_tpu/engine/flops.py``
(:139-152). The rest of that module (FLOP counts, rooflines, peak rates)
waits for the port's benchmark.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def param_tree_bytes(params: Any) -> int:
    """Total bytes of a state dict (nested dicts of tensors or arrays): the
    weight-read term of the serving roofline, every forward reading every
    parameter once. It sums what the tree stores, so an int8 tree (1-byte
    values plus their f32 scales, quant.py) reports its own footprint."""
    if isinstance(params, Mapping):
        return sum(param_tree_bytes(v) for v in params.values())
    if torch.is_tensor(params):
        return params.numel() * params.element_size()
    return int(np.asarray(params).nbytes)
