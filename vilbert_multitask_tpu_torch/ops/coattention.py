"""Flash attention: the hand-written CUDA kernel, its wrapper and its plain
PyTorch version.

Counterpart of ``vilbert_multitask_tpu/ops/coattention.py`` (the Pallas
kernel ``_flash_kernel`` behind ``flash_cross_attention``). The function is
``softmax(q·kᵀ/√D + bias)·v`` for each (batch, head), with an online softmax
over key tiles whose running max, sum and accumulator are f32, and the
output ``acc / max(l, 1e-30)`` in q's dtype.

- :func:`flash_cross_attention` is the wrapper the model calls. On a CUDA
  tensor it launches ``csrc/flash_attn.cu`` (built by :mod:`.._build` at
  first use): bf16 goes to the tensor-core kernel, f32 to the CUDA-core
  one. Anything else raises; there is no fallback on the card. On a CPU
  tensor it calls the plain version.
- :func:`flash_cross_attention_plain` is the same recurrence in torch ops,
  over the bf16 kernel's 64-key tiles: the CPU path, and what the kernel is
  held against on the card. It does not round P to bf16 as the bf16 kernel
  does before P·V.

Inputs use the model's ``(B, N, H, D)`` layout; the kernel reads them in
place through their strides (the head_dim axis must be contiguous, which the
``Linear`` outputs viewed as ``(B, N, H, D)`` are). The bf16 kernel copies
16 bytes at a time, so it also needs ``D % 8 == 0`` and 16-byte aligned
bases and strides (:func:`_check_launchable`). The bias is the
``(B, 1, 1, Nk)`` additive row from :func:`.attention.mask_to_bias`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.ops import routes

# Keys per tile, shared by the bf16 kernel (BLOCK_K in csrc/flash_attn.cu)
# and the plain version, so both run the same recurrence over the same tiles.
BLOCK_K = 64
MAX_HEAD_DIM = 128
_COPY_BYTES = 16  # the bf16 kernel's cp.async piece
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, N, H, D)")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(bias.shape) != (B, 1, 1, k.shape[1]):
        raise ValueError(f"bias must be (B, 1, 1, Nk) = {(B, 1, 1, k.shape[1])}"
                         f", got {tuple(bias.shape)}")


def flash_cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor
                                ) -> torch.Tensor:
    """The kernel's recurrence in torch ops: context ``(B, Nq, H, D)``.

    State dtype is ``promote(q.dtype, float32)``: f32 for f32 and bf16
    inputs, as in the kernel; f64 inputs keep f64 (the f64 parity tests).
    """
    _check_shapes(q, k, v, bias)
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    sdt = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(D)
    qt = q.permute(0, 2, 1, 3).to(sdt)  # (B, H, Nq, D)
    kt = k.permute(0, 2, 1, 3).to(sdt)
    vt = v.permute(0, 2, 1, 3).to(sdt)
    brow = bias.reshape(B, 1, 1, Nk).to(sdt)
    m = torch.full((B, H, Nq, 1), -math.inf, dtype=sdt, device=q.device)
    l = torch.zeros((B, H, Nq, 1), dtype=sdt, device=q.device)
    acc = torch.zeros((B, H, Nq, D), dtype=sdt, device=q.device)
    for k0 in range(0, Nk, BLOCK_K):
        s = (qt @ kt[:, :, k0:k0 + BLOCK_K].transpose(-1, -2) * scale
             + brow[..., k0:k0 + BLOCK_K])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vt[:, :, k0:k0 + BLOCK_K]
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_flash_attn
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, p, p, p, p, p, i, i, i, i, i] + [i64] * 14
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _check_launchable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel for q's dtype can read q, k, v
    and write ``out`` as they lie in memory. Needs no card."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if min(B, Nq, Nk, H, D) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, Nk {Nk}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and D % 8:
        raise ValueError(f"the bf16 kernel takes head_dim % 8 == 0, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        stride = t.stride()
        if stride[3] != 1:
            raise ValueError(f"the head_dim axis of {name} must be contiguous")
        if not bf16:
            continue
        # 16-byte copies: the base and every (B, N, H) stride that is
        # stepped (the axis is longer than 1) on 16-byte bounds.
        shape, step = t.shape, _COPY_BYTES // t.element_size()
        if (t.data_ptr() % _COPY_BYTES
                or (shape[0] > 1 and stride[0] % step)
                or (shape[1] > 1 and stride[1] % step)
                or (shape[2] > 1 and stride[2] % step)):
            raise ValueError(
                f"the bf16 kernel copies {_COPY_BYTES} bytes at a time: {name}"
                f" must start and stride (B, N, H) on {_COPY_BYTES}-byte "
                f"bounds, got address {t.data_ptr()} and strides "
                f"{stride[:3]} in elements of {t.element_size()} bytes")


def _launch(q, k, v, bias, *, lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch the kernel for q's dtype (from ``lib``, by default the built
    ``csrc/flash_attn.cu``) on CUDA tensors already checked by
    :func:`flash_cross_attention`; counts nothing."""
    B, Nq, H, D = q.shape
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    _check_launchable(q, k, v, out)
    fn = _bind(lib or _build.load("flash_attn"))
    rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, Nq, k.shape[1], H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            bias.stride(0), bias.stride(3), *out.stride()[:3],
            1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: cudaError {rc}")
    return out


@routes.kernel_wrapper("flash_attn")
def flash_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Blockwise attention; returns the context ``(B, Nq, H, D)`` in q's
    dtype. CUDA tensors go to the kernel (counted in
    ``flash_cross_attention.launches``), CPU tensors to the plain version,
    whose torch ops autograd follows (``ops/routes.py``)."""
    _check_shapes(q, k, v, bias)

    def launch():
        if q.dtype not in _DTYPE_CODES or any(
                t.dtype != q.dtype for t in (k, v, bias)):
            raise TypeError("flash_cross_attention takes float32 or "
                            "bfloat16 q, k, v and bias of one dtype, got "
                            f"{[str(t.dtype) for t in (q, k, v, bias)]}")
        return _launch(q, k, v, bias)

    return routes.launch_or_plain(
        "flash_attn", (q, k, v, bias),
        lambda: flash_cross_attention_plain(q, k, v, bias), launch)
