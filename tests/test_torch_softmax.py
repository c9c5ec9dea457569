"""The dense attention's scaled, masked softmax: its plain version against
the probabilities the JAX package's ``multi_head_attention`` returns, its
wrapper's checks and its route, on the CPU.

Both sides get the same scores: JAX's own ``einsum`` of seeded q and k in
the compute dtype (``preferred_element_type``), so the comparison holds the
softmax step alone (the scale, the bias in the compute dtype, the f32
softmax, the cast back). Shapes: the text self-attention's (12 heads × 38 ×
38, head_dim 64) and the bridge directions' (8 heads × 38 × 101 and 101 ×
38, head_dim 128), at batch 1 and 2 with masked keys. Tolerances are the
kernels' own (PERF.md §2): f32 within 2e-5·max(1, |ref|), bf16 within
atol 1e-2 + rtol 1e-2.

The kernel itself runs only on the card: chip_smoke.py holds it against
this plain version at the served shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vilbert_multitask_tpu.ops.attention import (
    mask_to_bias as jax_mask_to_bias,
)
from vilbert_multitask_tpu.ops.attention import (
    multi_head_attention as jax_mha,
)
from vilbert_multitask_tpu_torch.ops import softmax as softmax_ops
from vilbert_multitask_tpu_torch.ops.attention import (
    _inv_sqrt,
    mask_to_bias,
    multi_head_attention,
)

F32_TOL = 2e-5
BF16_ATOL = BF16_RTOL = 1e-2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (H, Nq, Nk, D): the text self-attention, the two bridge directions.
SHAPES = {"text": (12, 38, 38, 64), "bridge_t2v": (8, 38, 101, 128),
          "bridge_v2t": (8, 101, 38, 128)}


def _case(shape: str, batch: int, seed: int = 0):
    H, Nq, Nk, D = SHAPES[shape]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, Nq, H, D)).astype(np.float32)
    k = rng.normal(size=(batch, Nk, H, D)).astype(np.float32)
    v = rng.normal(size=(batch, Nk, H, D)).astype(np.float32)
    mask = np.ones((batch, Nk), np.int32)
    mask[-1, Nk - Nk // 4:] = 0  # the last row's tail of keys masked
    return q, k, v, mask


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_attention_probs(shape, batch, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, mask = _case(shape, batch)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jbias = jax_mask_to_bias(jnp.asarray(mask), jdt)
    _, jprobs = jax_mha(jq, jk, jv, jbias, dtype=jdt)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jq, jk, preferred_element_type=jdt)
    ts = torch.from_numpy(np.array(scores.astype(jnp.float32))).to(tdt)
    got = softmax_ops.scaled_masked_softmax_plain(
        ts, mask_to_bias(torch.from_numpy(mask), tdt),
        _inv_sqrt(q.shape[-1], tdt))
    assert got.dtype == tdt and got.shape == ts.shape
    got = got.double().numpy()
    want = np.asarray(jprobs.astype(jnp.float32)).astype(np.float64)
    if dtype == "float32":
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= F32_TOL, err.max()
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
    # A masked key takes no weight; every row sums to 1.
    Nk = SHAPES[shape][2]
    assert got[-1, ..., Nk - Nk // 4:].max() < 1e-30
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-2 if dtype ==
                               "bfloat16" else 1e-5)


def test_f32_bias_on_bf16_scores_rounds_the_bias_first():
    """The trainer's no-grad forward under autocast hands bf16 scores an
    f32 bias: the bias is rounded to bf16 before the add, as the JAX code's
    ``bias.astype(dtype)``."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.normal(size=(1, 2, 3, 40)).astype(
        np.float32)).bfloat16()
    b32 = torch.from_numpy(rng.normal(size=(1, 1, 1, 40)).astype(np.float32))
    got = softmax_ops.scaled_masked_softmax_plain(s, b32, 0.125)
    want = softmax_ops.scaled_masked_softmax_plain(s, b32.bfloat16(), 0.125)
    assert torch.equal(got, want) and got.dtype == torch.bfloat16


def test_no_bias_is_a_plain_scaled_softmax():
    s = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 5, 7)).astype(np.float32))
    got = softmax_ops.scaled_masked_softmax_plain(s, None, 0.5)
    torch.testing.assert_close(got, torch.softmax(s * 0.5, -1), rtol=0,
                               atol=0)


def test_f64_keeps_f64():
    q, k, v, mask = _case("text", 1, seed=4)
    s = torch.einsum("bqhd,bkhd->bhqk", torch.from_numpy(q).double(),
                     torch.from_numpy(k).double())
    bias = mask_to_bias(torch.from_numpy(mask), torch.float64)
    got = softmax_ops.scaled_masked_softmax_plain(s, bias, 0.125)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, torch.softmax(s * 0.125 + bias, -1),
                               rtol=1e-15, atol=1e-15)


# ------------------------------------------------------------- the wrapper
def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    s = torch.randn(1, 2, 3, 9, generator=torch.Generator().manual_seed(0))
    bias = torch.zeros(1, 1, 1, 9)
    before = softmax_ops.scaled_masked_softmax.launches
    got = softmax_ops.scaled_masked_softmax(s, bias, 0.25)
    assert torch.equal(got, softmax_ops.scaled_masked_softmax_plain(
        s, bias, 0.25))
    assert softmax_ops.scaled_masked_softmax.launches == before


def _launch_case(case: str):
    s = torch.zeros(2, 3, 5, 7)
    bias = torch.zeros(2, 1, 1, 7)
    bf = torch.bfloat16
    return {
        "bf16_bf16_bias": (s.to(bf), bias.to(bf)),
        "bf16_f32_bias": (s.to(bf), bias),
        "f32_no_bias": (s, None),
        "strided_heads": (torch.zeros(2, 5, 3, 7).transpose(1, 2), bias),
        "bias_view_of_a_mask_row": (s, torch.zeros(2, 7)[:, None, None, :]),
        "one_key": (torch.zeros(2, 3, 5, 1), torch.zeros(2, 1, 1, 1)),
        # rejected
        "f16": (s.half(), None),
        "f64": (s.double(), bias),
        "f64_bias": (s, bias.double()),
        "keys_strided": (torch.zeros(2, 3, 5, 14)[..., ::2], bias),
        "bias_keys_strided": (s, torch.zeros(2, 1, 1, 14)[..., ::2]),
    }[case]


@pytest.mark.parametrize("case", ["bf16_bf16_bias", "bf16_f32_bias",
                                  "f32_no_bias", "strided_heads",
                                  "bias_view_of_a_mask_row", "one_key"])
def test_launch_check_accepts_what_the_kernel_reads(case):
    softmax_ops._check_launchable(*_launch_case(case))


@pytest.mark.parametrize("case,error", [
    ("f16", TypeError), ("f64", TypeError), ("f64_bias", TypeError),
    ("keys_strided", ValueError), ("bias_keys_strided", ValueError)])
def test_launch_check_rejects_what_the_kernel_cannot_read(case, error):
    with pytest.raises(error):
        softmax_ops._check_launchable(*_launch_case(case))


@pytest.mark.parametrize("bad", ["three_dims", "bias_per_query", "devices"])
def test_wrapper_rejects_bad_shapes(bad):
    s = torch.zeros(2, 3, 5, 7)
    args = {"three_dims": (s[0], None),
            "bias_per_query": (s, torch.zeros(2, 1, 5, 7)),
            "devices": (s, torch.zeros(2, 1, 1, 7, device="meta"))}[bad]
    with pytest.raises(ValueError):
        softmax_ops.scaled_masked_softmax(*args, 0.5)


def test_a_recorded_attention_takes_the_plain_version(monkeypatch):
    """With gradients recorded the dense attention never calls the
    kernel's entry point, and its probabilities carry a gradient; under
    no_grad it calls it once."""
    calls = []
    real = softmax_ops.scaled_masked_softmax
    monkeypatch.setattr(softmax_ops, "scaled_masked_softmax",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v, mask = (torch.from_numpy(a) for a in _case("text", 1))
    q.requires_grad_(True)
    bias = mask_to_bias(mask)
    ctx, probs = multi_head_attention(q, k, v, bias)
    assert not calls and probs.grad_fn is not None
    ctx.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with torch.no_grad():
        ctx2, probs2 = multi_head_attention(q, k, v, bias)
    assert len(calls) == 1
    assert torch.equal(probs2, probs.detach())
    assert torch.equal(ctx2, ctx.detach())
