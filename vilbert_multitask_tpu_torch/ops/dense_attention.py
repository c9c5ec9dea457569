"""The dense attention's core in one kernel: the hand-written CUDA kernel,
its wrapper, its plain PyTorch version and its gate.

Stands for no TPU kernel: it is the fusion XLA makes of the whole of
``vilbert_multitask_tpu/ops/attention.py:36-66`` (``multi_head_attention``
without dropout: both einsums, the scale, the mask bias, the f32 softmax
and the casts), which every text self-attention of the served forward runs
(head_dim 64 fails the flash kernel's ``% 128`` gate). For ``q (B, Nq, H,
D)``, ``k`` and ``v (B, Nk, H, D)`` in bf16, the additive mask bias ``b
(B, 1, 1, Nk)`` and the scale ``c = 1 / sqrt(D)`` rounded to bf16
(``ops/attention.py:_inv_sqrt``)::

    s   = round(q · kᵀ)                       # f32 sums
    x   = round(round(s · c) + round(b))
    p   = round(softmax_f32(x))
    ctx = round(p · v)                        # f32 sums, as (B, Nq, H·D)

- :func:`fits` is the gate by shape and type (``ops/attention.py:
  cross_attention`` also asks for no dropout, no probabilities and a call
  autograd does not record): bf16, ``head_dim % 16 == 0`` and at most
  128, at most 128 keys.
- :func:`dense_attention` is the wrapper. On CUDA tensors it launches
  ``csrc/dense_attention.cu`` (built by :mod:`.._build` at first use) or
  raises (a gradient it would lose, a dtype or shape it does not take, a
  stride it cannot read 16 bytes at a time); on CPU tensors it calls the
  plain version.
- :func:`dense_attention_plain` is the composition the port ran before
  the kernel, in torch ops: an einsum, the softmax's plain version
  (``ops/softmax.py``), an einsum. The CPU path and what the kernel is held
  against on the card.

No probabilities come out: the self-attention's are never surfaced
(``models/encoder.py`` drops them); a call that needs them keeps
``multi_head_attention``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.ops import routes
from vilbert_multitask_tpu_torch.ops.softmax import (
    scaled_masked_softmax_plain,
)

HEAD_DIM_STEP = 16  # the mma depth: head_dim % 16 == 0
MAX_HEAD_DIM = 128
MAX_KEYS = 128  # the whole key row in one pass
_BIAS_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fits(head_dim: int, keys: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes an attention of this head width, key count
    and dtype."""
    return (dtype == torch.bfloat16 and head_dim % HEAD_DIM_STEP == 0
            and 0 < head_dim <= MAX_HEAD_DIM and 0 < keys <= MAX_KEYS)


def _check_shapes(q, k, v, bias) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) != (
                k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"q (B, Nq, H, D), k and v (B, Nk, H, D) do not "
                         f"match: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Nk = k.shape[0], k.shape[1]
    if bias is not None and tuple(bias.shape) != (B, 1, 1, Nk):
        raise ValueError(f"bias must be (B, 1, 1, Nk) = {(B, 1, 1, Nk)}, got "
                         f"{tuple(bias.shape)}")


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """``softmax(q · kᵀ · scale + bias) · v`` as ``(B, Nq, H·D)`` with the
    reference's roundings: both products in q's dtype, the softmax as
    :func:`~.softmax.scaled_masked_softmax_plain`."""
    _check_shapes(q, k, v, bias)
    B, Nq, H, D = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    probs = scaled_masked_softmax_plain(scores, bias, scale)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Nq, H * D)


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_dense_attention
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i] + [i64] * 10 + [
            ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_launchable(q, k, v, bias) -> None:
    """Raise unless the kernel takes these tensors as they lie. Needs no
    card."""
    _check_shapes(q, k, v, bias)
    routes.refuse_gradient("dense_attention", q, k, v, bias)
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16} or (
            bias is not None and bias.dtype not in _BIAS_CODES):
        raise TypeError(
            "dense_attention takes bfloat16 q, k, v and a float32 or "
            f"bfloat16 bias; got {q.dtype}, {k.dtype}, {v.dtype} and "
            f"{None if bias is None else bias.dtype}")
    D, Nk = q.shape[3], k.shape[1]
    if not fits(D, Nk, q.dtype) or min(q.shape) < 1:
        raise ValueError(
            f"dense_attention takes head_dim a multiple of {HEAD_DIM_STEP} "
            f"up to {MAX_HEAD_DIM} and 1 to {MAX_KEYS} keys; got "
            f"{tuple(q.shape)} queries and {Nk} keys")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"dense_attention reads {name} 16 bytes at a time: it needs "
                f"a contiguous head_dim axis, strides in multiples of 8 "
                f"elements and a 16-byte-aligned start; got strides "
                f"{t.stride()} at {t.data_ptr()}")
    if bias is not None and Nk > 1 and bias.stride(3) != 1:
        raise ValueError("dense_attention reads the bias's key axis "
                         "contiguously")


def _launch(q, k, v, bias, scale, *, lib: ctypes.CDLL = None
            ) -> torch.Tensor:
    """Launch the kernel (from ``lib``, by default the built
    ``csrc/dense_attention.cu``) on CUDA tensors; counts nothing."""
    _check_launchable(q, k, v, bias)
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    out = torch.empty((B, Nq, H * D), dtype=q.dtype, device=q.device)
    fn = _bind(lib or _build.load("dense_attention"))
    rc = fn(-1 if bias is None else _BIAS_CODES[bias.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, Nq, Nk, H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], 0 if bias is None else bias.stride(0),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dense_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out


@routes.kernel_wrapper("dense_attention")
def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    scale: float) -> torch.Tensor:
    """The attention's context ``(B, Nq, H·D)`` in q's dtype. CUDA tensors
    go to the kernel (counted in ``dense_attention.launches``), CPU
    tensors to the plain version (``ops/routes.py``)."""
    _check_shapes(q, k, v, bias)
    return routes.launch_or_plain(
        "dense_attention", (q, k, v, bias),
        lambda: dense_attention_plain(q, k, v, bias, scale),
        lambda: _launch(q, k, v, bias, scale))
