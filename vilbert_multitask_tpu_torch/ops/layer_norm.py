"""Residual add + LayerNorm: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

Stands for no TPU kernel: it is the fusion XLA makes of every
post-LayerNorm of the JAX forward, flax ``nn.LayerNorm(dtype=compute)(h +
r)`` (``vilbert_multitask_tpu/models/layers.py:44-50``, ``:68-76``, the
bridges' outputs ``:185-215``, ``models/embeddings.py:63`` and ``:98``) and
the heads' ``fused_layer_norm`` (``models/heads.py:134``; the port's
``models/vilbert.py:fused_head_output`` calls :func:`layer_norm` there).
The numerics are flax's (``use_fast_variance=True``)::

    s    = round_out(h + r)                  # r optional
    mean = E[s];  var = max(0, E[s²] - mean²)  # promote(out, f32)
    mul  = rsqrt(var + eps) * gamma
    y    = (s - mean) * mul + beta           # in the output dtype

The output dtype is ``h + r``'s: bf16 for two bf16 rows (the sum rounded
to bf16 first, as the JAX code adds two bf16 arrays), f32 for the
trainer's autocast pair (a bf16 ``h`` onto an f32 ``r``), h's without r.
gamma and beta are ``(W,)`` or ``(G, W)``, row ``i`` of the flattened
input taking group ``i % G`` (the fused label head's ``(B, 2, W)``), in
f32 or bf16 (the int8 mode's rounded parameters).

- :func:`layer_norm` is what the model's sites call: a call autograd
  records takes :func:`layer_norm_recorded`, any other the wrapper
  (``ops/routes.py``).
- :func:`add_layer_norm` is the wrapper. On CUDA tensors it launches
  ``csrc/layer_norm.cu`` (built by :mod:`.._build` at first use) or raises
  (a gradient it would lose, a dtype pair it does not take, a width that
  is not a multiple of 8, a row that is not contiguous); on CPU tensors it
  calls the plain version.
- :func:`add_layer_norm_plain` is the formula in torch ops: the CPU path
  and what the kernel is held against on the card. f64 inputs keep f64
  statistics (the f64 parity tests).
- :func:`layer_norm_recorded` is the route of a recorded call (the
  trainer's step): torch's ``F.layer_norm``, as the trunk ran it before
  the kernel. The kernel has no backward yet, and the formula's dozen
  autograd ops a site made a full-width training step 1.4x slower than
  ``F.layer_norm``'s one fused forward and backward (PERF.md §6);
  the two differ by f32 rounding (two-pass against fast variance).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.ops import routes

CHUNK = 8  # elements a lane reads at once (16 bytes of bf16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (h, residual) dtypes the kernel takes (None: no residual).
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32), (torch.bfloat16, None),
          (torch.float32, None)}


def _check_shapes(h, residual, weight, bias) -> int:
    """The number of parameter groups; raises on mismatched shapes."""
    if residual is not None and residual.shape != h.shape:
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"{tuple(h.shape)}")
    W = h.shape[-1]
    if weight.shape != bias.shape or weight.dim() not in (1, 2) \
            or weight.shape[-1] != W:
        raise ValueError(f"weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} must be (W,) or (G, W) with "
                         f"W = {W}")
    groups = weight.shape[0] if weight.dim() == 2 else 1
    if (h.numel() // max(W, 1)) % groups:
        raise ValueError(f"{h.numel() // max(W, 1)} rows do not split into "
                         f"{groups} parameter groups")
    return groups


def add_layer_norm_plain(h: torch.Tensor, residual: Optional[torch.Tensor],
                         weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm``'s formula over the last axis of ``h +
    residual``, in torch ops."""
    groups = _check_shapes(h, residual, weight, bias)
    s = h if residual is None else h + residual
    dt = s.dtype
    st = torch.promote_types(dt, torch.float32)
    x = s.to(st).reshape(-1, groups, s.shape[-1])
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          0.0)
    mul = torch.rsqrt(var + eps) * weight.to(st)
    return ((x - mean) * mul + bias.to(st)).to(dt).reshape(s.shape)


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_add_layer_norm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, p, p, p, p, p, ctypes.c_longlong, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_launchable(h, residual, weight, bias) -> None:
    """Raise unless the kernel takes these tensors as they lie. Needs no
    card."""
    pair = (h.dtype, None if residual is None else residual.dtype)
    if pair not in _PAIRS or weight.dtype not in _DTYPE_CODES \
            or bias.dtype != weight.dtype:
        raise TypeError(
            "add_layer_norm takes (h, residual) of (bf16, bf16), (bf16, f32), "
            "(f32, f32) or h alone in bf16 or f32, and f32 or bf16 weight and "
            f"bias of one dtype; got h {h.dtype}, residual "
            f"{pair[1]}, weight {weight.dtype}, bias {bias.dtype}")
    W = h.shape[-1]
    if W < CHUNK or W % CHUNK:
        raise ValueError(f"add_layer_norm takes widths that are multiples of "
                         f"{CHUNK}, got {W}")
    for name, t in (("h", h), ("residual", residual), ("weight", weight),
                    ("bias", bias)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"add_layer_norm reads whole contiguous rows: "
                             f"{name} has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"add_layer_norm reads 16 bytes at a time: "
                             f"{name} starts at {t.data_ptr()}")


def _launch(h, residual, weight, bias, eps, groups, *,
            lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch the kernel (from ``lib``, by default the built
    ``csrc/layer_norm.cu``) on CUDA tensors already checked; counts
    nothing."""
    _check_launchable(h, residual, weight, bias)
    dt = h.dtype if residual is None else torch.promote_types(
        h.dtype, residual.dtype)
    out = torch.empty(h.shape, dtype=dt, device=h.device)
    fn = _bind(lib or _build.load("layer_norm"))
    rc = fn(_DTYPE_CODES[h.dtype],
            -1 if residual is None else _DTYPE_CODES[residual.dtype],
            _DTYPE_CODES[weight.dtype], h.data_ptr(),
            None if residual is None else residual.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            h.numel() // h.shape[-1], h.shape[-1], groups, float(eps),
            torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {rc}")
    return out


@routes.kernel_wrapper("layer_norm")
def add_layer_norm(h: torch.Tensor, residual: Optional[torch.Tensor],
                   weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm of ``h + residual`` (or of ``h``) over the last axis with
    flax's numerics. CUDA tensors go to the kernel (counted in
    ``add_layer_norm.launches``), CPU tensors to the plain version
    (``ops/routes.py``)."""
    groups = _check_shapes(h, residual, weight, bias)
    return routes.launch_or_plain(
        "layer_norm", (h, residual, weight, bias),
        lambda: add_layer_norm_plain(h, residual, weight, bias, eps),
        lambda: _launch(h, residual, weight, bias, eps, groups))


def layer_norm_recorded(h: torch.Tensor, residual: Optional[torch.Tensor],
                        weight: torch.Tensor, bias: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """LayerNorm of ``h + residual`` for a call autograd records:
    ``F.layer_norm`` at ``promote(dtype, float32)``, the result in the
    sum's dtype. Grouped parameters (the fused heads, which no step runs)
    take the plain formula, as they did before the kernel."""
    if weight.dim() == 2:
        return add_layer_norm_plain(h, residual, weight, bias, eps)
    s = h if residual is None else h + residual
    dt = torch.promote_types(s.dtype, torch.float32)
    return F.layer_norm(s.to(dt), s.shape[-1:], weight.to(dt), bias.to(dt),
                        eps).to(s.dtype)


def layer_norm(h: torch.Tensor, residual: Optional[torch.Tensor],
               weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The model's LayerNorm sites: :func:`layer_norm_recorded` for a call
    autograd records (the kernel has no backward), :func:`add_layer_norm`
    otherwise."""
    if routes.records_gradient(h, residual, weight, bias):
        return layer_norm_recorded(h, residual, weight, bias, eps)
    return add_layer_norm(h, residual, weight, bias, eps)
