"""Weight-only int8 GEMM: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

The int8 serving mode's product (``EngineConfig.param_dtype="int8"``).
In the JAX package the engine dequantizes every ``{"int8", "scale"}`` pair
inside the jitted forward (``vilbert_multitask_tpu/quant.py:94``, called
from ``engine/runtime.py:684-705``) and XLA fuses the dequantization into
the matmul that reads it. Here the fusion is ``csrc/int8_linear.cu``. For x
``(M, K)`` in bf16 or f32, q ``(N, K)`` int8 (torch's Linear layout), an f32
scale ``s (N,)`` and a bias ``b (N,)`` in x's dtype::

    W[n, k] = round(float(q[n, k]) * s[n])     # rounded to x's dtype
    y       = round(x @ W.T)                   # f32 accumulation
    y       = round(y + b)

flax ``Dense``'s two roundings, the product and then the bias. A batch of
products (``q (B, N, K)``, ``x (B, M, K)``, ``s``/``b (B, N)``) is one
launch.

- :func:`int8_linear` is the wrapper the models call. On a CUDA tensor it
  launches the kernel (built by :mod:`.._build` at first use): bf16 goes to
  the tensor-core kernel, f32 to the CUDA-core one; anything else raises,
  and there is no fallback on the card. On a CPU tensor it calls the plain
  version.
- :func:`int8_linear_plain` is the same steps in torch ops: the CPU path,
  and what the kernel is held against on the card.

The bf16 kernel copies 16 bytes at a time: q's rows (and batch entries)
must start on 16-byte bounds, so a weight whose K is not a multiple of 16
is stored in rows padded to one (:func:`padded_rows`), and x is copied 16
bytes at a time when ``K % 8 == 0`` (its row stride then a multiple of 8
elements). For other K the kernel loads x one element at a time.
:func:`_check_launchable` raises on anything else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from vilbert_multitask_tpu_torch import _build

W_ROW_ALIGN = 16  # bytes: the bf16 kernel's cp.async piece of an int8 row
_X_PIECE = 8  # bf16 elements in one 16-byte copy of x
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_BLOCK_M = 64  # rows of x per block (BM and F_BM in csrc/int8_linear.cu)


def padded_width(k: int) -> int:
    """The row stride, in int8 elements, of a weight with K = ``k``: ``k``
    rounded up to :data:`W_ROW_ALIGN`."""
    return -(-k // W_ROW_ALIGN) * W_ROW_ALIGN


def padded_rows(q: torch.Tensor) -> torch.Tensor:
    """``q`` (..., N, K) int8 copied into rows padded with zeros to
    :func:`padded_width`; returns the ``[..., :K]`` view (its storage holds
    the padding)."""
    k = q.shape[-1]
    buf = torch.zeros(*q.shape[:-1], padded_width(k), dtype=torch.int8,
                      device=q.device)
    buf[..., :k] = q
    return buf[..., :k]


def _check_shapes(x, q, scale, bias):
    if q.dtype != torch.int8 or q.dim() not in (2, 3):
        raise TypeError(f"q must be int8 (N, K) or (B, N, K), got "
                        f"{q.dtype} {tuple(q.shape)}")
    if x.dim() != q.dim() or x.shape[-1] != q.shape[-1] or (
            q.dim() == 3 and x.shape[0] != q.shape[0]):
        raise ValueError(f"x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != tuple(
            q.shape[:-1]):
        raise ValueError(f"scale must be f32 {tuple(q.shape[:-1])}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if bias is not None and (bias.dtype != x.dtype or tuple(bias.shape)
                             != tuple(q.shape[:-1])):
        raise ValueError(f"bias must be {x.dtype} {tuple(q.shape[:-1])}, "
                         f"got {bias.dtype} {tuple(bias.shape)}")


def int8_linear_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor = None) -> torch.Tensor:
    """The kernel's steps in torch ops (x, q, scale, bias as for
    :func:`int8_linear`, x already 2-D or batched)."""
    _check_shapes(x, q, scale, bias)
    w = (q.to(torch.float32) * scale.unsqueeze(-1)).to(x.dtype)
    y = torch.matmul(x, w.transpose(-1, -2))
    if bias is not None:
        y = y + bias.unsqueeze(-2)
    return y


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_int8_linear
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, p, p, p, p, p, i, i, i, i] + [i64] * 8 + [i, p])
        fn.restype = ctypes.c_int
    return fn


def _rows(t: torch.Tensor) -> tuple:
    """(batch stride, row stride) of a 2-D or batched 3-D operand."""
    return (t.stride(0), t.stride(1)) if t.dim() == 3 else (0, t.stride(0))


def _check_launchable(x, q, scale, bias, out) -> bool:
    """Raise ``ValueError`` unless the kernel for x's dtype can read the
    operands as they lie in memory; return whether x goes by 16-byte
    copies. Needs no card."""
    M, K = x.shape[-2:]
    N = q.shape[-2]
    if min(M, N, K) < 1:
        raise ValueError(f"empty product: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}")
    if -(-M // _BLOCK_M) > _MAX_GRID_Y:
        raise ValueError(f"M = {M} rows exceeds the kernel's grid")
    for name, t in (("x", x), ("q", q), ("scale", scale), ("bias", bias),
                    ("out", out)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"the last axis of {name} must be contiguous")
    if x.dtype != torch.bfloat16:
        return False
    q_sb, ldw = _rows(q)
    if q.data_ptr() % W_ROW_ALIGN or ldw % W_ROW_ALIGN or (
            q.dim() == 3 and q.shape[0] > 1 and q_sb % W_ROW_ALIGN):
        raise ValueError(
            f"the bf16 kernel copies int8 rows {W_ROW_ALIGN} bytes at a "
            f"time: q must start and stride on {W_ROW_ALIGN}-byte bounds "
            f"(padded_rows), got address {q.data_ptr()} and strides "
            f"{q.stride()}")
    if K % _X_PIECE:
        return False  # the kernel's element-wise edge path for x
    x_sb, lda = _rows(x)
    if x.data_ptr() % 16 or (M > 1 and lda % _X_PIECE) or (
            x.dim() == 3 and x.shape[0] > 1 and x_sb % _X_PIECE):
        raise ValueError(
            f"the bf16 kernel copies x 16 bytes at a time when K % 8 == 0: "
            f"x must start and stride on 16-byte bounds, got address "
            f"{x.data_ptr()} and strides {x.stride()}")
    return True


def _launch(x, q, scale, bias, *, lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch the kernel for x's dtype (from ``lib``, by default the built
    ``csrc/int8_linear.cu``) on CUDA operands already checked by
    :func:`int8_linear`; counts nothing."""
    out = torch.empty((*x.shape[:-1], q.shape[-2]), dtype=x.dtype,
                      device=x.device)
    vec_x = _check_launchable(x, q, scale, bias, out)
    batch = q.shape[0] if q.dim() == 3 else 1
    (x_sb, lda), (w_sb, ldw), (y_sb, ldy) = _rows(x), _rows(q), _rows(out)
    s_sb = scale.stride(0) if q.dim() == 3 else 0
    b_sb = bias.stride(0) if bias is not None and q.dim() == 3 else 0
    fn = _bind(lib or _build.load("int8_linear"))
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(),
            scale.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), batch, x.shape[-2], q.shape[-2], q.shape[-1],
            lda, ldw, ldy, x_sb, w_sb, s_sb, b_sb, y_sb, int(vec_x),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_linear kernel launch failed: cudaError {rc}")
    return out


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor = None) -> torch.Tensor:
    """``x @ (q * scale).T + bias`` with int8 weights; returns x's dtype.

    ``q`` (N, K) takes any x (..., K) (its leading axes flattened into rows)
    and returns (..., N); ``q`` (B, N, K) takes x (B, M, K) and returns
    (B, M, N). CUDA tensors go to the kernel (counted in
    ``int8_linear.launches``), CPU tensors to the plain version."""
    lead = x.shape[:-1]
    if q.dim() == 2 and x.dim() != 2:
        x = x.reshape(-1, x.shape[-1])
    _check_shapes(x, q, scale, bias)
    tensors = (x, q, scale) + ((bias,) if bias is not None else ())
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"x, q, scale, bias on different devices: {devices}")
    if x.device.type == "cpu":
        out = int8_linear_plain(x, q, scale, bias)
    elif x.device.type != "cuda":
        raise ValueError(f"no int8 linear for device {x.device}")
    else:
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"int8_linear takes float32 or bfloat16 x, got "
                            f"{x.dtype}")
        out = _launch(x, q, scale, bias)
        if torch.cuda.is_current_stream_capturing():
            rec = int8_linear.recorded
            rec.n = getattr(rec, "n", 0) + 1
        else:
            int8_linear.launches += 1
    return out.reshape(*lead, q.shape[-2]) if q.dim() == 2 else out


# Kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after); CPU calls never count.
int8_linear.launches = 0
# Calls recorded into a CUDA graph by this thread's capture: they launch
# nothing now, and engine/graphs.py adds them to ``launches`` per replay.
int8_linear.recorded = threading.local()
