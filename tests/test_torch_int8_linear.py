"""The int8 GEMM's plain version against the JAX package's int8 product,
and the wrapper's checks, on the CPU.

The JAX side is what its int8 engine computes for one Dense layer:
``quant.dequantize_leaf`` of the pair, then ``flax.linen.Dense``. Two
call sites are held: the trunk's (dequantized in the compute dtype, so the
port passes the scale rounded to it) and the head slabs' (dequantized in
f32, then cast, so the port passes the f32 scale). Tolerances: f32 within
1e-6 relative (summation order only); bf16 bit-equal, as the products are
rounded once from f32 sums on both sides at these depths.

The kernel itself runs only on the card: chip_smoke.py holds it against
this plain version at every serving shape.
"""

from __future__ import annotations

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vilbert_multitask_tpu import quant as jquant
from vilbert_multitask_tpu_torch.ops import int8_linear as il

# (M, K, N): K = 5 (the box coordinates), N = 1, 4 and 3129 (the heads),
# M = 1 (one request's pooled row), and a few wider ones.
SHAPES = [(1, 5, 1), (1, 5, 4), (1, 5, 3129), (1, 48, 1), (1, 48, 4),
          (1, 48, 3129), (7, 48, 3129), (38, 64, 48), (101, 32, 128)]


def _operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32) / np.sqrt(K)
    w[:, 0] = 0.0  # a zero column: scale 1.0
    pair = jquant.quantize_leaf(w)  # JAX layout: (in, out), scale (out,)
    x = rng.normal(size=(M, K)).astype(np.float32)
    b = (0.02 * rng.normal(size=(N,))).astype(np.float32)
    return pair, x, b


def _jax_dense(pair, x, b, dtype, head_slab: bool):
    dt = jnp.dtype(dtype)
    if head_slab:  # fused_head_output: dequantized in f32, then cast
        kernel = jquant.dequantize_leaf(pair, jnp.float32).astype(dt)
    else:  # the trunk: dequantize_tree(params, compute dtype)
        kernel = jquant.dequantize_leaf(pair, dt)
    dense = fnn.Dense(kernel.shape[1], dtype=dt)
    y = dense.apply({"params": {"kernel": kernel, "bias": jnp.asarray(
        b).astype(dt)}}, jnp.asarray(x).astype(dt))
    return np.asarray(y.astype(jnp.float32))


def _port(pair, x, b, dtype, head_slab: bool):
    dt = getattr(torch, dtype)
    q = torch.from_numpy(np.ascontiguousarray(pair["int8"].T))
    s = torch.from_numpy(pair["scale"])
    if not head_slab:
        s = s.to(dt).float()  # QuantLinear.kernel_scale
    y = il.int8_linear(torch.from_numpy(x).to(dt), q, s,
                       torch.from_numpy(b).to(dt))
    assert y.dtype == dt
    return y.float().numpy()


@pytest.mark.parametrize("head_slab", [False, True], ids=["trunk", "slab"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_jax_dense_f32(M, K, N, head_slab):
    pair, x, b = _operands(M, K, N)
    want = _jax_dense(pair, x, b, "float32", head_slab)
    got = _port(pair, x, b, "float32", head_slab)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("head_slab", [False, True], ids=["trunk", "slab"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_jax_dense_bf16(M, K, N, head_slab):
    pair, x, b = _operands(M, K, N, seed=1)
    want = _jax_dense(pair, x, b, "bfloat16", head_slab)
    got = _port(pair, x, b, "bfloat16", head_slab)
    np.testing.assert_array_equal(got, want)


def test_the_two_scale_roundings_differ_somewhere():
    """The trunk's bf16 scale and the slabs' f32 scale are two functions:
    on the same pair they give other bf16 weights (so the tests above hold
    each call site to its own)."""
    pair, _, _ = _operands(1, 48, 3129)
    trunk = np.asarray(jquant.dequantize_leaf(pair, jnp.bfloat16)
                       .astype(jnp.float32))
    slab = np.asarray(jquant.dequantize_leaf(pair, jnp.float32)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    assert (trunk != slab).any()


def test_batched_plain_equals_one_product_per_entry():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 5, 48)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (2, 7, 48), dtype=np.int8))
    s = torch.from_numpy(rng.random((2, 7)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 7)).astype(np.float32))
    got = il.int8_linear(x.transpose(0, 1).contiguous().transpose(0, 1),
                         q, s, b)
    for i in range(2):
        torch.testing.assert_close(got[i], il.int8_linear(x[i], q[i], s[i],
                                                          b[i]),
                                   rtol=0, atol=0)


def test_leading_axes_flatten_into_rows_and_come_back():
    x = torch.randn(3, 4, 16)
    q = torch.randint(-127, 128, (5, 16), dtype=torch.int8)
    s = torch.rand(5)
    y = il.int8_linear(x, q, s)
    assert y.shape == (3, 4, 5)
    torch.testing.assert_close(y.reshape(12, 5),
                               il.int8_linear(x.reshape(12, 16), q, s))


def test_wrapper_on_cpu_uses_plain_and_counts_no_launch():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    q = torch.randint(-127, 128, (5, 16), dtype=torch.int8)
    s, b = torch.rand(5), torch.randn(5, dtype=torch.bfloat16)
    before = il.int8_linear.launches
    torch.testing.assert_close(il.int8_linear(x, q, s, b),
                               il.int8_linear_plain(x, q, s, b),
                               rtol=0, atol=0)
    assert il.int8_linear.launches == before


@pytest.mark.parametrize("bad", [
    "q float", "q 1-D", "K differs", "batch differs", "scale f64",
    "scale shape", "bias dtype", "bias shape", "meta device",
    "devices differ"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.randn(3, 16)
    q = torch.randint(-127, 128, (5, 16), dtype=torch.int8)
    s, b = torch.rand(5), torch.randn(5)
    err = ValueError
    if bad == "q float":
        q, err = q.float(), TypeError
    elif bad == "q 1-D":
        q, err = q[0], TypeError
    elif bad == "K differs":
        x = torch.randn(3, 17)
    elif bad == "batch differs":
        x, q = torch.randn(2, 3, 16), q.expand(3, 5, 16)
        s, b = s.expand(3, 5), b.expand(3, 5)
    elif bad == "scale f64":
        s = s.double()
    elif bad == "scale shape":
        s = torch.rand(4)
    elif bad == "bias dtype":
        b = b.to(torch.bfloat16)
    elif bad == "bias shape":
        b = torch.randn(6)
    elif bad == "meta device":
        x, q, s, b = (t.to("meta") for t in (x, q, s, b))
    elif bad == "devices differ":
        s = s.to("meta")
    with pytest.raises(err):
        il.int8_linear(x, q, s, b)


def _launch_args(M, K, N, dtype=torch.bfloat16, *, pad=True):
    x = torch.randn(M, K).to(dtype)
    q = torch.randint(-127, 128, (N, K), dtype=torch.int8)
    if pad:
        q = il.padded_rows(q)
    s, b = torch.rand(N), torch.randn(N).to(dtype)
    out = torch.empty(M, N, dtype=dtype)
    return x, q, s, b, out


@pytest.mark.parametrize("bad", [
    "unpadded K = 5 rows", "misaligned q base", "x row stride",
    "x misaligned base", "x last axis strided", "q last axis strided"])
def test_launch_check_rejects_what_the_kernel_cannot_read(bad):
    x, q, s, b, out = _launch_args(4, 64, 8)
    if bad == "unpadded K = 5 rows":
        x, q, s, b, out = _launch_args(4, 5, 8, pad=False)
    elif bad == "misaligned q base":
        q = il.padded_rows(torch.randint(-127, 128, (9, 64),
                                         dtype=torch.int8)).reshape(-1)[
            1:1 + 8 * 64].view(8, 64)
    elif bad == "x row stride":
        x = torch.randn(4, 68).to(torch.bfloat16)[:, :64]
    elif bad == "x misaligned base":
        x = torch.randn(4 * 64 + 1).to(torch.bfloat16)[1:].view(4, 64)
    elif bad == "x last axis strided":
        x = torch.randn(64, 4).to(torch.bfloat16).t()
    elif bad == "q last axis strided":
        q = torch.randint(-127, 128, (64, 8), dtype=torch.int8).t()
    with pytest.raises(ValueError):
        il._check_launchable(x, q, s, b, out)


@pytest.mark.parametrize("M,K,N,dtype,vec", [
    (4, 64, 8, torch.bfloat16, True),
    (1, 768, 3, torch.bfloat16, True),
    (101, 5, 1024, torch.bfloat16, False),  # the element-wise x path
    (3, 37, 33, torch.bfloat16, False),
    (3, 37, 33, torch.float32, False),  # the f32 kernel reads any stride
])
def test_launch_check_accepts_what_the_kernel_reads(M, K, N, dtype, vec):
    assert il._check_launchable(*_launch_args(M, K, N, dtype)) is vec


def test_a_launch_without_the_card_raises():
    """On this machine there is no nvcc and no card: a launch raises at the
    build, it never runs the plain version in the kernel's place."""
    x, q, s, b, _ = _launch_args(4, 64, 8)
    with pytest.raises(RuntimeError):
        il._launch(x, q, s, b)


def test_padded_rows_keeps_values_and_pads_with_zeros():
    q = torch.randint(-127, 128, (3, 5), dtype=torch.int8)
    p = il.padded_rows(q)
    assert p.stride() == (16, 1) and torch.equal(p, q)
    assert il.padded_width(5) == 16 and il.padded_width(32) == 32


# ----------------------------------------------------------- the planner
def _plan_shapes():
    """(M, N, K, batch) of every int8_linear launch of a full-width forward
    at buckets 1, 2, 4, 16 and 32 (chip_smoke.py's table), and its edge
    shapes."""
    import chip_smoke

    from vilbert_multitask_tpu_torch.config import ViLBertConfig

    shapes = {(M, N, K, b) for rows in (1, 2, 4, 16, 32)
              for M, N, K, b, _, _ in chip_smoke.int8_forward_shapes(
                  ViLBertConfig(), rows)}
    shapes |= {(M, N, K, b) for M, N, K, b, _ in chip_smoke.INT8_EDGES}
    return sorted(shapes)


SMEM_PER_BLOCK = 232448  # an H100 block's largest dynamic shared memory
PLAN_SHAPES = _plan_shapes()


@pytest.mark.parametrize("M,N,K,batch", PLAN_SHAPES)
def test_plan_serves_each_forward_shape(M, N, K, batch):
    """The planner is a function of the shape; its splits partition the K
    tiles exactly once; its grid, cluster and shared memory are within the
    card's limits; the cluster's partials fit the receiving buffer."""
    plan = il.plan_launch(M, N, K, batch)
    assert plan == il.plan_launch(M, N, K, batch)
    gx, gy, gz = plan.grid
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    assert plan.blocks == gx * gy * gz
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    nkt = -(-K // il.TILE_K)
    if plan.regime == "wgmma":
        assert batch == 1 and K % 8 == 0 and M >= il.WGMMA_MIN_M
        assert plan.splits == 1
        assert plan.grid == (-(-N // 128), -(-M // 128), 1)
        return
    assert plan.regime == "stream"
    assert M < il.WGMMA_MIN_M or batch > 1 or K % 8
    assert 1 <= plan.splits <= min(il.MAX_SPLITS, nkt)
    assert plan.grid == (-(-N // 64) * plan.splits, -(-M // 64), batch)
    assert gx % plan.splits == 0  # the splits of a tile are one cluster
    ranges = il.split_ranges(K, plan.splits)
    tiles = [set(range(a // il.TILE_K, -(-b // il.TILE_K))) for a, b in ranges]
    assert all(tiles) and sum(map(len, tiles)) == nkt
    assert set().union(*tiles) == set(range(nkt))
    assert ranges[0][0] == 0 and ranges[-1][1] == K and all(
        a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if plan.splits > 1:
        elements = 4 * -(-min(64, M) // 8)  # a thread's partial sums
        slots = -(-128 // plan.splits)
        assert plan.splits * elements * slots * 4 <= il.STREAM_RECV


def test_plan_routes_the_throughput_buckets_to_wgmma():
    assert il.plan_launch(101 * 32, 1024, 1024).regime == "wgmma"
    assert il.plan_launch(38 * 16, 768, 768).regime == "wgmma"
    assert il.plan_launch(101 * 4, 1024, 1024).regime == "stream"
    assert il.plan_launch(3232, 1024, 5).regime == "stream"  # K % 8
    assert il.plan_launch(3232, 3129, 2048, 2).regime == "stream"  # batch


@pytest.mark.parametrize("bad", [dict(M=0), dict(batch=70000),
                                 dict(M=64 * 70000, K=5)])
def test_plan_raises_on_what_no_kernel_serves(bad):
    args = dict(M=38, N=768, K=768, batch=1) | bad
    with pytest.raises(ValueError):
        il.plan_launch(**args)


@pytest.mark.parametrize("K,splits", [(64, 1), (768, 8), (1000, 3),
                                      (3072, 16), (5, 1)])
def test_split_ranges_cover_k_in_whole_tiles(K, splits):
    ranges = il.split_ranges(K, splits)
    assert len(ranges) == splits
    assert all(a % il.TILE_K == 0 and a < b for a, b in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == K


# (M, K, N, splits): K over several 64-deep tiles, ragged K, a head width.
SPLIT_SHAPES = [(1, 192, 8, 3), (38, 300, 40, 2), (7, 256, 3129, 4),
                (101, 130, 16, 3), (5, 640, 33, 10)]


def _split_plain(x, q, scale, bias=None, *, splits):
    """The stream kernel's order in torch ops, on x (M, K) or (B, M, K) in
    bf16 or f32: W rounded per element to x's dtype, one f32 partial
    product per split over its whole 64-deep K tiles (``split_ranges``),
    the partials summed in split order 0..S-1, then the product rounded to
    x's dtype and the bias added and rounded."""
    w = (q.float() * scale.unsqueeze(-1)).to(x.dtype).float()
    xf = x.float()
    acc = None
    for k0, k1 in il.split_ranges(x.shape[-1], splits):
        p = torch.matmul(xf[..., k0:k1], w[..., k0:k1].transpose(-1, -2))
        acc = p if acc is None else acc + p
    y = acc.to(x.dtype)
    if bias is not None:
        y = (y.float() + bias.float().unsqueeze(-2)).to(x.dtype)
    return y


@pytest.mark.parametrize("head_slab", [False, True], ids=["trunk", "slab"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,splits", SPLIT_SHAPES)
def test_split_order_matches_jax_dense(M, K, N, splits, dtype, head_slab):
    """The stream kernel's order (f32 partials over whole K tiles, summed in
    split order, then the two roundings) against the JAX Dense: f32 within
    2e-5 (the JAX package's kernel tolerance; only the summation order
    differs), bf16 within atol 1e-2 + rtol 1e-2 (what the kernel is held to
    on the card: a reordered f32 sum can move one bf16 rounding)."""
    pair, x, b = _operands(M, K, N, seed=3)
    want = _jax_dense(pair, x, b, dtype, head_slab)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(np.ascontiguousarray(pair["int8"].T))
    s = torch.from_numpy(pair["scale"])
    if not head_slab:
        s = s.to(dt).float()
    got = _split_plain(torch.from_numpy(x).to(dt), q, s,
                       torch.from_numpy(b).to(dt), splits=splits)
    assert got.dtype == dt
    tol = 2e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_split_order_batched_equals_one_product_per_entry():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 5, 200)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (2, 7, 200), dtype=np.int8))
    s = torch.from_numpy(rng.random((2, 7)).astype(np.float32))
    got = _split_plain(x, q, s, splits=3)
    for i in range(2):
        torch.testing.assert_close(
            got[i], _split_plain(x[i], q[i], s[i], splits=3),
            rtol=0, atol=0)


def _wgmma_args(K=64, N=8):
    M = il.WGMMA_MIN_M
    args = _launch_args(M, K, N)
    return args, il.plan_launch(M, N, max(K, 64))


@pytest.mark.parametrize("bad", ["misaligned q base", "q row stride",
                                 "x row stride", "x misaligned base",
                                 "K % 8 != 0"])
def test_launch_check_rejects_what_the_wgmma_kernel_cannot_read(bad):
    """TMA reads both operands through tensor maps: 16-byte bases and row
    strides, and K a multiple of 8 (bf16 rows in 16-byte pieces)."""
    (x, q, s, b, out), plan = _wgmma_args()
    assert plan.regime == "wgmma"
    M = x.shape[0]
    if bad == "misaligned q base":
        q = il.padded_rows(torch.randint(-127, 128, (9, 64),
                                         dtype=torch.int8)).reshape(-1)[
            1:1 + 8 * 64].view(8, 64)
    elif bad == "q row stride":
        q = torch.randint(-127, 128, (8, 72), dtype=torch.int8)[:, :64]
    elif bad == "x row stride":
        x = torch.randn(M, 68).to(torch.bfloat16)[:, :64]
    elif bad == "x misaligned base":
        x = torch.randn(M * 64 + 1).to(torch.bfloat16)[1:].view(M, 64)
    else:
        (x, q, s, b, out), _ = _wgmma_args(K=60)
    with pytest.raises(ValueError):
        il._check_launchable(x, q, s, b, out, plan)


def test_launch_check_accepts_the_wgmma_regime():
    args, plan = _wgmma_args()
    assert il._check_launchable(*args, plan) is True


def test_bf16_scale_flag_changes_nothing_on_the_cpu():
    x = torch.randn(3, 40).to(torch.bfloat16)
    q = torch.randint(-127, 128, (5, 40), dtype=torch.int8)
    s = torch.rand(5).to(torch.bfloat16).float()
    torch.testing.assert_close(il.int8_linear(x, q, s, scale_bf16=True),
                               il.int8_linear(x, q, s), rtol=0, atol=0)


# ------------------------------------------------- the phase-stamp reader
def test_stream_phase_stamps_decode_into_their_phases():
    from vilbert_multitask_tpu_torch.ops import int8_phases

    stamps = [0] * int8_phases.N_STAMPS
    stamps[0:6] = [100, 150, 170, 200, 260, 300]  # prologue, two tiles
    stamps[40:43] = [350, 420, 500]
    got = int8_phases.stream_phases(stamps, splits=4)
    assert got == {"prologue": 50, "tile0_wait": 20, "tile0_products": 30,
                   "tile1_wait": 60, "tile1_products": 40,
                   "cluster_started": 50, "partials_stored": 70,
                   "sum_and_store": 80, "total": 400}
    stamps[40:42] = [0, 0]
    assert int8_phases.stream_phases(stamps, splits=1)["store"] == 200


def test_wgmma_phase_stamps_decode_per_warpgroup_and_tile():
    from vilbert_multitask_tpu_torch.ops import int8_phases

    stamps = [0] * int8_phases.N_STAMPS
    stamps[0] = 1000
    for wg in range(2):
        t = 1000 + 7 * wg
        for it in range(int8_phases.WGMMA_TILES):
            for p, step in enumerate((10, 50, 5, 80)):
                t += step
                stamps[8 + 32 * wg + 4 * it + p] = t
        stamps[88 + wg] = t + 300
    stamps[72:74] = [1003, 1004]
    got = int8_phases.wgmma_phases(stamps)
    assert got["wg1_tile0"] == {"weight_wait": 17, "dequantize": 50,
                                "x_wait": 5, "products": 80}
    assert got["steady_tile_mean"] == {"weight_wait": 10, "dequantize": 50,
                                       "x_wait": 5, "products": 80}
    assert got["wg0_rest_and_epilogue"] == 300
    assert got["tma_x_issued"] == [3, 4] and got["tma_w_issued"] == []
    assert got["total"] == 7 + 8 * 145 + 300
