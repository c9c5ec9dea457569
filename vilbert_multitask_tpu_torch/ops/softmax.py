"""The dense attention's scaled, masked softmax: the hand-written CUDA
kernel, its wrapper and its plain PyTorch version.

Stands for no TPU kernel: it is the fusion XLA makes of
``vilbert_multitask_tpu/ops/attention.py:49-59`` (``multi_head_attention``:
the scale, the bias in the compute dtype, the f32 softmax and the cast
back), which every text self-attention runs (head_dim 64 fails the flash
kernel's ``% 128`` gate), and every bridge direction whose maps are
collected. For scores ``s (B, H, Nq, Nk)`` in the compute dtype c, the
scale ``c_scale = 1 / sqrt(D)`` rounded to c (``ops/attention.py:
_inv_sqrt``) and the additive mask bias ``b (B, 1, 1, Nk)``::

    p = round_c(softmax_f32(round_c(round_c(s * c_scale) + round_c(b))))

- :func:`attention_probs` is what ``multi_head_attention`` calls: a call
  autograd records takes the plain version, any other the wrapper
  (``ops/routes.py``).
- :func:`scaled_masked_softmax` is the wrapper. On CUDA tensors it
  launches ``csrc/softmax.cu`` (built by :mod:`.._build` at first use) or
  raises (a gradient it would lose, a dtype it does not take, a key axis
  that is not contiguous); on CPU tensors it calls the plain version.
- :func:`scaled_masked_softmax_plain` is the reference's steps in torch
  ops: the CPU path, the route of a recorded call, and what the kernel is
  held against on the card. f64 keeps f64 (the f64 parity tests).

The probabilities are the output: the bridges' attention maps
(``collect_attention``) are read from them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.ops import routes

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(scores, bias) -> None:
    if scores.dim() != 4:
        raise ValueError(f"scores must be (B, H, Nq, Nk), got "
                         f"{tuple(scores.shape)}")
    B, _, _, Nk = scores.shape
    if bias is not None and tuple(bias.shape) != (B, 1, 1, Nk):
        raise ValueError(f"bias must be (B, 1, 1, Nk) = {(B, 1, 1, Nk)}, got "
                         f"{tuple(bias.shape)}")


def scaled_masked_softmax_plain(scores: torch.Tensor,
                                bias: Optional[torch.Tensor],
                                scale: float) -> torch.Tensor:
    """``softmax(scores * scale + bias)`` over the keys with the
    reference's roundings: the product and the sum in the scores' dtype,
    the softmax at ``promote(dtype, float32)``, the result cast back."""
    _check_shapes(scores, bias)
    dt = scores.dtype
    x = scores * scale
    if bias is not None:
        x = x + bias.to(dt)
    sd = torch.promote_types(dt, torch.float32)
    return torch.softmax(x.to(sd), dim=-1).to(dt)


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_scaled_masked_softmax
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, p, i, i, i, i, i64, i64, i64, i64,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_launchable(scores, bias) -> None:
    """Raise unless the kernel takes these tensors as they lie. Needs no
    card."""
    if scores.dtype not in _DTYPE_CODES or (
            bias is not None and bias.dtype not in _DTYPE_CODES):
        raise TypeError(
            "scaled_masked_softmax takes float32 or bfloat16 scores and "
            f"bias, got {scores.dtype} and "
            f"{None if bias is None else bias.dtype}")
    if min(scores.shape) < 1:
        raise ValueError(f"empty scores {tuple(scores.shape)}")
    if scores.stride(3) != 1 or (bias is not None and bias.shape[3] > 1
                                 and bias.stride(3) != 1):
        raise ValueError("scaled_masked_softmax reads the key axis of scores "
                         "and bias contiguously")


def _launch(scores, bias, scale, *, lib: ctypes.CDLL = None
            ) -> torch.Tensor:
    """Launch the kernel (from ``lib``, by default the built
    ``csrc/softmax.cu``) on CUDA tensors already checked; counts
    nothing."""
    _check_launchable(scores, bias)
    B, H, Nq, Nk = scores.shape
    out = torch.empty((B, H, Nq, Nk), dtype=scores.dtype,
                      device=scores.device)
    fn = _bind(lib or _build.load("softmax"))
    rc = fn(_DTYPE_CODES[scores.dtype],
            -1 if bias is None else _DTYPE_CODES[bias.dtype],
            scores.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, H, Nq, Nk, *scores.stride()[:3],
            0 if bias is None else bias.stride(0), float(scale),
            torch.cuda.current_stream(scores.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"softmax kernel launch failed: cudaError {rc}")
    return out


@routes.kernel_wrapper("softmax")
def scaled_masked_softmax(scores: torch.Tensor, bias: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """Attention probabilities ``(B, H, Nq, Nk)`` in the scores' dtype.
    CUDA tensors go to the kernel (counted in
    ``scaled_masked_softmax.launches``), CPU tensors to the plain version
    (``ops/routes.py``)."""
    _check_shapes(scores, bias)
    return routes.launch_or_plain(
        "softmax", (scores, bias),
        lambda: scaled_masked_softmax_plain(scores, bias, scale),
        lambda: _launch(scores, bias, scale))


def attention_probs(scores: torch.Tensor, bias: Optional[torch.Tensor],
                    scale: float) -> torch.Tensor:
    """The dense attention's site: the plain version for a call autograd
    records (the kernel has no backward), :func:`scaled_masked_softmax`
    otherwise."""
    if routes.records_gradient(scores, bias):
        return scaled_masked_softmax_plain(scores, bias, scale)
    return scaled_masked_softmax(scores, bias, scale)
