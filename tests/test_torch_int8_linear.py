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
