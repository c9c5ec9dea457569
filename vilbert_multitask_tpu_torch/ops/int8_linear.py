"""Weight-only int8 GEMM: the hand-written CUDA kernels, their launch
planner, the wrapper and the plain PyTorch version.

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
  launches a kernel (built by :mod:`.._build` at first use): bf16 goes to
  the kernel :func:`plan_launch` picks for the shape, f32 to the CUDA-core
  one; anything else raises, and there is no fallback on the card. On a
  CPU tensor it calls the plain version.
- :func:`plan_launch` is the bf16 launch planner, a function of the shape
  alone: the weight-streaming kernel with a split count for small M (every
  launch of buckets 1 to 4 and the heads), the ``wgmma`` kernel for large M
  (the throughput buckets). Eager runs and graph replays of one shape take
  the same plan, so they give the same bits.
- :func:`int8_linear_plain` is the same steps in torch ops: the CPU path,
  and what the kernels are held against on the card.

The kernels copy 16 bytes at a time: q's rows (and batch entries) must
start on 16-byte bounds (also what the ``wgmma`` kernel's TMA loads need),
so a weight whose K is not a multiple of 16 is stored in rows padded to one
(:func:`padded_rows`), and x is copied 16 bytes at a time when
``K % 8 == 0`` (its row stride then a multiple of 8 elements). For other K
the stream kernel loads x one element at a time. :func:`_check_launchable`
raises on anything else.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
from typing import List, Tuple

import torch

from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.ops import routes

W_ROW_ALIGN = 16  # bytes: a 16-byte copy of an int8 row; TMA's stride unit
_X_PIECE = 8  # bf16 elements in one 16-byte copy of x
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_F32_BLOCK_M = 64  # rows of x per block of the f32 kernel (F_BM)

# The planner's constants (csrc/int8_linear.cu's tiles).
SMS = 132  # streaming multiprocessors of an H100 SXM
TILE_K = 64  # depth of a K tile, both regimes (S_BK, G_BK)
STREAM_TILE = 64  # weight rows and x rows per stream block (S_BW, S_BX)
# S_SMEM: the ring of 4 weight and padded x tiles, and the partials a block
# receives from its cluster: 71,552 bytes.
STREAM_SMEM = 4 * (64 * 64 + 64 * 72 * 2) + 32 * (128 + 15) * 4
WGMMA_TILE = 128  # x rows and weight rows per wgmma block (G_BM, G_BN)
# G_SMEM: 6 stages of x tiles, 6 of int8 weight tiles, and their mbarriers:
# 148,672 bytes.
WGMMA_SMEM = 1024 + 6 * 128 * 64 * 2 + 6 * 128 * 64 + 2 * (6 + 6) * 8
WGMMA_MIN_M = 512  # x rows from which the wgmma kernel takes a launch
MAX_SPLITS = 16  # the splits of a tile are one cluster (at most 16 blocks)
# Partials a stream block receives from its cluster (S_RECV): 32 elements of
# ceil(128 / splits) thread slots from each of the splits.
STREAM_RECV = 32 * (128 + MAX_SPLITS - 1) * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """One bf16 launch: which kernel, its tile, its split count (the
    cluster of blocks that sum one output tile) and its grid."""

    regime: str  # "stream" or "wgmma"
    tile_n: int  # weight rows (output columns) per block
    tile_m: int  # x rows per block
    splits: int  # K ranges of whole 64-deep tiles, summed in order
    grid: Tuple[int, int, int]
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def regime_code(self) -> int:
        return 1 if self.regime == "wgmma" else 0


def split_ranges(K: int, splits: int) -> List[Tuple[int, int]]:
    """The K element ranges of the splits: split ``s`` covers the 64-deep
    tiles ``[s·n/S, (s+1)·n/S)`` of the ``n = ceil(K / 64)`` tiles, as the
    stream kernel computes them (every split non-empty for S <= n)."""
    n = -(-K // TILE_K)
    if not 1 <= splits <= n:
        raise ValueError(f"{splits} splits of {n} K tiles")
    bounds = [s * n // splits for s in range(splits + 1)]
    return [(a * TILE_K, min(K, b * TILE_K))
            for a, b in zip(bounds, bounds[1:])]


def plan_launch(M: int, N: int, K: int, batch: int = 1) -> Plan:
    """The bf16 kernel, tile and split count for x (batch, M, K) times q
    (batch, N, K); a function of the shape alone. Raises ``ValueError``
    for a shape no kernel serves."""
    if min(M, N, K, batch) < 1:
        raise ValueError(f"empty product: M={M} N={N} K={K} batch={batch}")
    if batch > _MAX_GRID_YZ:
        raise ValueError(f"a batch of {batch} exceeds the kernel's grid")
    if batch == 1 and K % _X_PIECE == 0 and M >= WGMMA_MIN_M:
        grid = (-(-N // WGMMA_TILE), -(-M // WGMMA_TILE), 1)
        if grid[1] > _MAX_GRID_YZ:
            raise ValueError(f"M = {M} rows exceeds the wgmma kernel's grid")
        return Plan("wgmma", WGMMA_TILE, WGMMA_TILE, 1, grid, WGMMA_SMEM)
    x_tiles = -(-M // STREAM_TILE)
    if x_tiles > _MAX_GRID_YZ:
        raise ValueError(f"M = {M} rows exceeds the stream kernel's grid")
    n_tiles = -(-N // STREAM_TILE)
    base = n_tiles * x_tiles * batch
    nkt = -(-K // TILE_K)
    # As many splits as keep about 1.5 K tiles a split (a split's cost is
    # mostly the wait for its first tile and the cluster's reduction), every
    # tile its own split for the head products (M <= 8), and at most two
    # blocks a multiprocessor: measured on an H100 at the serving shapes
    # (chip_smoke.py phase 3 prints each launch's plan and time).
    per_split = nkt if M <= 8 else 2 * nkt // 3
    splits = max(1, min(MAX_SPLITS, per_split, 2 * SMS // base))
    return Plan("stream", STREAM_TILE, STREAM_TILE, splits,
                (n_tiles * splits, x_tiles, batch), STREAM_SMEM)


def kernel_label(dtype: torch.dtype, M: int, N: int, K: int,
                 batch: int = 1) -> str:
    """The kernel a launch of x (batch, M, K) in ``dtype`` times q (batch,
    N, K) takes, from the shape alone: ``"wgmma"``, ``"stream_s<splits>"``
    (bf16, by :func:`plan_launch`) or ``"f32"``."""
    if dtype != torch.bfloat16:
        return "f32"
    plan = plan_launch(M, N, K, batch)
    return ("wgmma" if plan.regime == "wgmma"
            else f"stream_s{plan.splits}")


class planned_kernels:
    """Tally, by :func:`kernel_label`, the products :func:`int8_linear`
    makes on this thread while the context is open (on the card and on the
    CPU alike): ``with planned_kernels() as tally: ...`` leaves a
    ``{label: calls}`` dict in ``tally.counts``."""

    def __enter__(self) -> "planned_kernels":
        self.counts: dict = {}
        self._outer = getattr(_TALLY, "counts", None)
        _TALLY.counts = self.counts
        return self

    def __exit__(self, *exc) -> bool:
        _TALLY.counts = self._outer
        return False


_TALLY = threading.local()


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


def _dequantized(x, q, scale) -> torch.Tensor:
    return (q.to(torch.float32) * scale.unsqueeze(-1)).to(x.dtype)


def int8_linear_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor = None) -> torch.Tensor:
    """The kernels' steps in torch ops (x, q, scale, bias as for
    :func:`int8_linear`, x already 2-D or batched)."""
    _check_shapes(x, q, scale, bias)
    y = torch.matmul(x, _dequantized(x, q, scale).transpose(-1, -2))
    if bias is not None:
        y = y + bias.unsqueeze(-2)
    return y


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_int8_linear
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, p, p, p, p, p, i, i, i, i] + [i64] * 8
                       + [i, i, i, i, p, p, p])
        fn.restype = ctypes.c_int
        enc = lib.vmt_int8_tensor_map
        enc.argtypes = [p, p, i, i, i, i, i64, i64, i]
        enc.restype = ctypes.c_int
    return fn


def _rows(t: torch.Tensor) -> tuple:
    """(batch stride, row stride) of a 2-D or batched 3-D operand."""
    return (t.stride(0), t.stride(1)) if t.dim() == 3 else (0, t.stride(0))


def _check_launchable(x, q, scale, bias, out, plan: Plan = None) -> bool:
    """Raise ``ValueError`` unless the kernel for x's dtype (and, in bf16,
    ``plan``'s regime, by default :func:`plan_launch` of the shape) can
    read the operands as they lie in memory; return whether x goes by
    16-byte copies. Needs no card."""
    M, K = x.shape[-2:]
    N = q.shape[-2]
    batch = q.shape[0] if q.dim() == 3 else 1
    if min(M, N, K) < 1:
        raise ValueError(f"empty product: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}")
    for name, t in (("x", x), ("q", q), ("scale", scale), ("bias", bias),
                    ("out", out)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"the last axis of {name} must be contiguous")
    if x.dtype != torch.bfloat16:
        if -(-M // _F32_BLOCK_M) > _MAX_GRID_YZ:
            raise ValueError(f"M = {M} rows exceeds the kernel's grid")
        return False
    plan = plan or plan_launch(M, N, K, batch)
    q_sb, ldw = _rows(q)
    if q.data_ptr() % W_ROW_ALIGN or ldw % W_ROW_ALIGN or (
            batch > 1 and q_sb % W_ROW_ALIGN):
        how = ("reads int8 rows through a TMA tensor map"
               if plan.regime == "wgmma" else
               f"copies int8 rows {W_ROW_ALIGN} bytes at a time")
        raise ValueError(
            f"the {plan.regime} kernel {how}: q must start and stride on "
            f"{W_ROW_ALIGN}-byte bounds (padded_rows), got address "
            f"{q.data_ptr()} and strides {q.stride()}")
    if K % _X_PIECE:
        if plan.regime == "wgmma":
            raise ValueError("the wgmma kernel reads x through a TMA tensor "
                             "map: K must be a multiple of 8")
        return False  # the stream kernel's element-wise edge path for x
    x_sb, lda = _rows(x)
    if x.data_ptr() % 16 or (M > 1 and lda % _X_PIECE) or (
            batch > 1 and x_sb % _X_PIECE):
        raise ValueError(
            f"the bf16 kernels read x 16 bytes at a time (the wgmma kernel "
            f"through a TMA tensor map) when K % 8 == 0: x must start and "
            f"stride on 16-byte bounds, got address {x.data_ptr()} and "
            f"strides {x.stride()}")
    return True


# TMA tensor maps the bf16 kernels read through, encoded once per operand
# layout (kind, device, address, shape, strides, box): a weight's address is
# stable, so a served model encodes each weight's maps once, and a captured
# graph's x buffers are fixed; eager calls reuse the caching allocator's
# addresses, so a steady stream of forwards finds its maps cached.
_MAPS: "collections.OrderedDict[tuple, bytes]" = collections.OrderedDict()
_MAPS_LOCK = threading.Lock()
_MAPS_MAX = 4096


def _tensor_map(lib: ctypes.CDLL, t: torch.Tensor, box_rows: int) -> bytes:
    """The TMA tensor map of ``t``, an int8 weight or a bf16 x, (rows, K)
    or (batch, rows, K), in boxes of ``box_rows`` rows x 64 (cached)."""
    rows, K = t.shape[-2:]
    batch, bstride = (t.shape[0], t.stride(0)) if t.dim() == 3 else (1, 0)
    ld = t.stride(-2)
    kind = 0 if t.dtype == torch.int8 else 1
    key = (kind, t.device.index, t.data_ptr(), batch, rows, K, ld, bstride,
           box_rows)
    with _MAPS_LOCK:
        got = _MAPS.get(key)
        if got is not None:
            _MAPS.move_to_end(key)
            return got
    buf = ctypes.create_string_buffer(128)
    rc = lib.vmt_int8_tensor_map(buf, t.data_ptr(), kind, batch, rows, K,
                                 ld, bstride, box_rows)
    if rc != 0:
        raise RuntimeError(f"int8_linear: encoding a TMA tensor map failed "
                           f"(CUresult {rc})")
    with _MAPS_LOCK:
        _MAPS[key] = buf.raw
        while len(_MAPS) > _MAPS_MAX:
            _MAPS.popitem(last=False)
    return buf.raw


def _launch(x, q, scale, bias, *, scale_bf16: bool = False,
            lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch the kernel for x's dtype (from ``lib``, by default the built
    ``csrc/int8_linear.cu``; in bf16 the one :func:`plan_launch` picks) on
    CUDA operands already checked by :func:`int8_linear`; counts nothing."""
    out = torch.empty((*x.shape[:-1], q.shape[-2]), dtype=x.dtype,
                      device=x.device)
    batch = q.shape[0] if q.dim() == 3 else 1
    M, N, K = x.shape[-2], q.shape[-2], q.shape[-1]
    plan = (plan_launch(M, N, K, batch) if x.dtype == torch.bfloat16
            else None)
    vec_x = _check_launchable(x, q, scale, bias, out, plan)
    (x_sb, lda), (w_sb, ldw), (y_sb, ldy) = _rows(x), _rows(q), _rows(out)
    s_sb = scale.stride(0) if q.dim() == 3 else 0
    b_sb = bias.stride(0) if bias is not None and q.dim() == 3 else 0
    lib = lib or _build.load("int8_linear")
    fn = _bind(lib)
    regime, splits, xmap, wmap = 0, 1, None, None
    if plan is not None:
        regime, splits = plan.regime_code, plan.splits
        if plan.regime == "wgmma":
            xmap = _tensor_map(lib, x, plan.tile_m)
            wmap = _tensor_map(lib, q, plan.tile_n)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(),
            scale.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), batch, M, N, K, lda, ldw, ldy, x_sb, w_sb, s_sb,
            b_sb, y_sb, int(vec_x), int(scale_bf16), regime, splits, xmap,
            wmap,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_linear kernel launch failed: cudaError {rc}")
    return out


@routes.kernel_wrapper("int8_linear")
def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor = None, *,
                scale_bf16: bool = False) -> torch.Tensor:
    """``x @ (q * scale).T + bias`` with int8 weights; returns x's dtype.

    ``q`` (N, K) takes any x (..., K) (its leading axes flattened into rows)
    and returns (..., N); ``q`` (B, N, K) takes x (B, M, K) and returns
    (B, M, N). ``scale_bf16`` says every scale is exact in bf16 (the trunk
    passes it so rounded), which lets the bf16 kernels dequantize with one
    packed bf16 multiply; the f32 path they take otherwise is right for
    either. CUDA tensors go to a kernel (counted in
    ``int8_linear.launches``), CPU tensors to the plain version."""
    lead = x.shape[:-1]
    if q.dim() == 2 and x.dim() != 2:
        x = x.reshape(-1, x.shape[-1])
    _check_shapes(x, q, scale, bias)
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        label = kernel_label(x.dtype, x.shape[-2], q.shape[-2], q.shape[-1],
                             q.shape[0] if q.dim() == 3 else 1)
        tally[label] = tally.get(label, 0) + 1

    def launch():
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"int8_linear takes float32 or bfloat16 x, got "
                            f"{x.dtype}")
        return _launch(x, q, scale, bias, scale_bf16=scale_bf16)

    out = routes.launch_or_plain("int8_linear", (x, q, scale, bias),
                                 lambda: int8_linear_plain(x, q, scale, bias),
                                 launch)
    return out.reshape(*lead, q.shape[-2]) if q.dim() == 2 else out
