"""Which calls of the model take a hand-written kernel that has no backward.

``csrc/layer_norm.cu``, ``csrc/softmax.cu`` and ``csrc/dense_attention.cu``
compute the forward only. The model's sites (``ops/layer_norm.py:
layer_norm``, ``ops/softmax.py:attention_probs``, the dense core's gate in
``ops/attention.py:cross_attention``) route each call by
:func:`records_gradient`:

- a call that autograd records (gradients enabled, and an input or a
  parameter requires grad: the trainer's step) takes a torch composition
  that autograd follows (``F.layer_norm``; the softmax's plain version
  inside ``multi_head_attention``);
- any other call takes the kernel's wrapper: the card's inference calls
  (the served engine and its graphs, ``EvalHook``, a forward under
  ``torch.no_grad``) launch the kernel, and CPU tensors take the plain
  version there.

The wrappers themselves raise on a CUDA tensor that needs a gradient
(:func:`refuse_gradient`), as ``ops/coattention.py:check_no_gradient``
does for the flash kernel, so a lost gradient cannot pass silently.
"""

from __future__ import annotations

from typing import Optional

import torch


def records_gradient(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd records a call on ``tensors`` (``None`` entries
    are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_gradient(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` when autograd would need a gradient through
    ``kernel``, which has none: its output would carry no ``grad_fn``."""
    if records_gradient(*tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad with "
            f"gradients enabled. The model's sites route such a call to the "
            f"plain version (ops/routes.py); call the kernel's wrapper under "
            f"torch.no_grad()")
