"""The port's flash attention (plain version, as its wrapper runs it on the
CPU) against the JAX package's Pallas kernel and its dense attention.

The five cases of tests/test_pallas_coattention.py, and the edges of the
plain version's 64-key tiles (the bf16 kernel's), on the same numpy inputs
fed to both packages, at the JAX package's own kernel tolerance (atol/rtol
2e-5 in f32; 1e-9 in f64 against JAX's dense path). The JAX kernel runs in
interpret mode on the CPU. The CUDA kernel itself is held against this plain
version on the card by chip_smoke.py; what the wrapper checks before a
launch is tested here.
"""

from __future__ import annotations

import contextlib
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tests import torch_port_helpers  # noqa: F401  (caps torch threads)
from vilbert_multitask_tpu.ops.attention import (
    mask_to_bias as jax_mask_to_bias,
    multi_head_attention as jax_mha,
)
from vilbert_multitask_tpu.ops.coattention import (
    flash_cross_attention as jax_flash,
)
from vilbert_multitask_tpu_torch.ops import coattention
from vilbert_multitask_tpu_torch.ops.attention import (
    mask_to_bias,
    multi_head_attention,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, B, Nq, Nk, H, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Nq, H, D)).astype(np.float32),
            rng.normal(size=(B, Nk, H, D)).astype(np.float32),
            rng.normal(size=(B, Nk, H, D)).astype(np.float32))


def _copied(x):
    """``x`` with every tensor in it (through tuples, lists, dicts) copied."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(y) for y in x)
    if isinstance(x, dict):
        return {key: _copied(y) for key, y in x.items()}
    return x


class _OpRecorder(TorchFunctionMode):
    """Keeps every torch call of the run it is entered around: the function,
    copies of its arguments taken before the call, and a copy of its tensor
    result. It computes nothing itself: each call runs as it would without
    it. Inside ``__torch_function__`` the mode is off, so the copies are not
    recorded."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = _copied((args, kwargs))
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            self.calls.append((func, before, out.detach().clone()))
        return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.numpy(), b.numpy(), equal_nan=a.is_floating_point())


def _first_run_report(rec: _OpRecorder, case: str) -> str:
    """What a failing first run looked like: each recorded call rerun on its
    recorded arguments (a call whose result differs from its first run is
    the first-call fault), the f32 matmul modes, torch's threads and the
    process's live threads. With ``VMT_C1_DUMP`` set, the recorded calls go
    to ``<VMT_C1_DUMP>/<case>-<pid>.pt`` as well."""
    lines = [f"first run of the plain version, {len(rec.calls)} torch calls"]
    for i, (func, (args, kwargs), out) in enumerate(rec.calls):
        again = func(*args, **kwargs)
        if isinstance(again, torch.Tensor) and not _same_bits(again, out):
            diff = (again.double() - out.double()).abs()
            lines.append(f"  call {i} {getattr(func, '__name__', func)}: rerun "
                         f"differs in {int((diff > 0).sum())} of "
                         f"{diff.numel()}, max {diff.max().item():.4e}")
    mkldnn = getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)
    lines.append(
        f"  float32 matmul precision {torch.get_float32_matmul_precision()}, "
        f"mkldnn fp32 precision "
        f"{getattr(mkldnn, 'fp32_precision', 'n/a')}, torch threads "
        f"{torch.get_num_threads()}, live threads "
        f"{sorted(t.name for t in threading.enumerate())}")
    dump = os.environ.get("VMT_C1_DUMP")
    if dump:
        os.makedirs(dump, exist_ok=True)
        path = os.path.join(dump, f"{case}-{os.getpid()}.pt")
        torch.save([(getattr(f, "__name__", str(f)), a, o)
                    for f, a, o in rec.calls], path)
        lines.append(f"  recorded calls saved to {path}")
    return "\n".join(lines)


def _both(q, k, v, mask, *, recorder: _OpRecorder = None, **jax_kw):
    """(port plain, JAX Pallas, JAX dense) on the same inputs; the port's
    call runs inside ``recorder`` when one is given."""
    bias = mask_to_bias(torch.from_numpy(mask))
    with recorder if recorder is not None else contextlib.nullcontext():
        port = coattention.flash_cross_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), bias).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jbias = jax_mask_to_bias(jnp.asarray(mask))
    pallas = np.asarray(jax_flash(jq, jk, jv, jbias, **jax_kw))
    dense = np.asarray(jax_mha(jq, jk, jv, jbias)[0])
    return port, pallas, dense


CASES = {
    # 38 text tokens x 101 regions — the serving geometry.
    "serving_2x38x101x8x128": dict(seed=0, shape=(2, 38, 101, 8, 128),
                                   keep=0.9),
    # Nk spanning several key tiles: the online-softmax recurrence.
    "several_kv_blocks_1x16x300x2x64": dict(
        seed=1, shape=(1, 16, 300, 2, 64), keep=1.0,
        jax_kw=dict(block_q=8, block_k=64)),
    # The visual self-attention geometry: 101 x 101 regions, 8 x 128.
    "visual_2x101x101x8x128": dict(seed=11, shape=(2, 101, 101, 8, 128),
                                   keep=0.8),
    # Nk on either side of one and two 64-key tiles.
    **{f"tile_edge_1x20x{nk}x2x64": dict(seed=20 + nk, shape=(1, 20, nk, 2, 64),
                                          keep=0.9)
       for nk in (63, 64, 65, 128, 129)},
    # The serving geometry with 90% of the keys masked.
    "masked90_2x38x101x4x128": dict(seed=12, shape=(2, 38, 101, 4, 128),
                                    keep=0.1),
    # q x 8: peaky rows, where the running max moves between tiles.
    "peaky_q8_1x38x129x4x64": dict(seed=13, shape=(1, 38, 129, 4, 64),
                                   keep=0.9, q_scale=8.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_dense(case):
    c = CASES[case]
    B, Nq, Nk, H, D = c["shape"]
    q, k, v = _qkv(c["seed"], B, Nq, Nk, H, D)
    q = q * np.float32(c.get("q_scale", 1.0))
    rng = np.random.default_rng(c["seed"] + 1)
    mask = (rng.random((B, Nk)) < c["keep"]).astype(np.int32)
    mask[:, 0] = 1
    # The run under test is recorded as it happens (no warm-up, which would
    # hide a fault of a first call): ROADMAP C1's first-run deviation.
    rec = _OpRecorder()
    port, pallas, dense = _both(q, k, v, mask, recorder=rec,
                                **c.get("jax_kw", {}))
    assert port.shape == (B, Nq, H, D) and port.dtype == np.float32
    try:
        np.testing.assert_allclose(port, pallas, **TOL)
        np.testing.assert_allclose(port, dense, **TOL)
    except AssertionError as e:
        raise AssertionError(f"{e}\n{_first_run_report(rec, case)}") from None


def test_plain_f64_matches_jax_dense():
    """f64 on both sides over three 64-key tiles with a ragged last one: the
    plain version keeps f64 state and matches JAX's dense path at 1e-9."""
    B, Nq, Nk, H, D = 2, 21, 150, 2, 32
    rng = np.random.default_rng(14)
    q, k, v = (rng.normal(size=(B, n, H, D)) for n in (Nq, Nk, Nk))
    mask = (rng.random((B, Nk)) < 0.7).astype(np.int32)
    mask[:, 0] = 1
    port = coattention.flash_cross_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask_to_bias(torch.from_numpy(mask), torch.float64))
    assert port.dtype == torch.float64
    with jax.enable_x64(True):
        jq, jk, jv = (jnp.asarray(a, jnp.float64) for a in (q, k, v))
        dense = np.asarray(jax_mha(
            jq, jk, jv, jax_mask_to_bias(jnp.asarray(mask), jnp.float64),
            dtype=jnp.float64)[0])
    assert dense.dtype == np.float64
    np.testing.assert_allclose(port.numpy(), dense, atol=1e-9, rtol=1e-9)


def test_masked_keys_do_not_leak():
    """Garbage in a fully masked key tail leaves the context unchanged, and
    both packages agree on it."""
    q, k, v = _qkv(2, 1, 8, 40, 2, 32)
    mask = np.concatenate([np.ones((1, 25), np.int32),
                           np.zeros((1, 15), np.int32)], axis=1)
    port, pallas, dense = _both(q, k, v, mask)
    k2, v2 = k.copy(), v.copy()
    k2[:, 25:] = 1e3
    v2[:, 25:] = -1e3
    port2, pallas2, _ = _both(q, k2, v2, mask)
    np.testing.assert_allclose(port2, port, atol=1e-5)
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(port2, pallas2, **TOL)
    np.testing.assert_allclose(port, dense, **TOL)


def test_all_masked_row_guard():
    """A batch row whose keys are ALL masked: the -10000 bias shifts every
    score equally, so the row is a plain softmax over its raw scores, and
    the ``max(l, 1e-30)`` guard leaves it finite in both packages."""
    q, k, v = _qkv(3, 2, 8, 37, 2, 128)
    mask = np.ones((2, 37), np.int32)
    mask[0] = 0
    port, pallas, dense = _both(q, k, v, mask)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, pallas, **TOL)
    np.testing.assert_allclose(port, dense, **TOL)


def test_dense_attention_matches_jax_with_probs():
    """The port's dense path (text self-attention, and the bridges when
    attention maps are requested) against JAX's, probabilities included."""
    q, k, v = _qkv(5, 2, 38, 38, 12, 64)
    mask = np.ones((2, 38), np.int32)
    mask[1, 30:] = 0
    ctx, probs = multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask_to_bias(torch.from_numpy(mask)))
    jctx, jprobs = jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                           jax_mask_to_bias(jnp.asarray(mask)))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)


def test_bf16_mask_bias_is_made_in_the_compute_dtype():
    """(1 - mask) * -10000 in bf16 is -9984 in both packages."""
    mask = np.array([[1, 0, 1]], np.int32)
    port = mask_to_bias(torch.from_numpy(mask), torch.bfloat16)
    jax_b = jax_mask_to_bias(jnp.asarray(mask), jnp.bfloat16)
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(jax_b, np.float32))
    assert port.float()[0, 0, 0, 1].item() == -9984.0


def test_wrapper_on_cpu_uses_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 5, 7, 2, 16))
    bias = torch.zeros(1, 1, 1, 7)
    before = coattention.flash_cross_attention.launches
    out = coattention.flash_cross_attention(q, k, v, bias)
    assert coattention.flash_cross_attention.launches == before
    torch.testing.assert_close(
        out, coattention.flash_cross_attention_plain(q, k, v, bias),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["bias_shape", "kv_mismatch", "devices"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 5, 7, 2, 16))
    bias = torch.zeros(1, 1, 1, 7)
    if bad == "bias_shape":
        bias = torch.zeros(1, 7)
    elif bad == "kv_mismatch":
        v = v[:, :6]
    else:
        q = q.to("meta")
    with pytest.raises(ValueError):
        coattention.flash_cross_attention(q, k, v, bias)


def _bf16_qkv_out(D=16, *, pad=0, offset=0):
    """bf16 q, k, v, out of shape (1, 5, 2, D), q a view into a wider
    buffer: ``pad`` extra elements per head row, ``offset`` skipped first."""
    buf = torch.zeros(1, 5, 2, D + pad + offset, dtype=torch.bfloat16)
    q = buf[..., offset:offset + D]
    k, v, out = (torch.zeros(1, 7 if i < 2 else 5, 2, D, dtype=torch.bfloat16)
                 for i in range(3))
    return q, k, v, out


@pytest.mark.parametrize("bad", ["width_12", "width_136", "offset_2_bytes",
                                 "head_stride_40_bytes", "f32_width_136"])
def test_launch_check_rejects_what_the_kernel_cannot_read(bad):
    """The checks the CUDA branch runs before any launch: bf16 head_dim a
    multiple of 8 up to 128, 16-byte bases and (B, N, H) strides."""
    q, k, v, out = {
        "width_12": lambda: _bf16_qkv_out(12),
        "width_136": lambda: _bf16_qkv_out(136),
        "offset_2_bytes": lambda: _bf16_qkv_out(16, pad=7, offset=1),
        "head_stride_40_bytes": lambda: _bf16_qkv_out(16, pad=4),
        "f32_width_136": lambda: tuple(
            t.float() for t in _bf16_qkv_out(136)),
    }[bad]()
    with pytest.raises(ValueError):
        coattention._check_launchable(q, k, v, out)


@pytest.mark.parametrize("case", ["bf16_d16", "bf16_d24_strided_view",
                                  "f32_d12_offset"])
def test_launch_check_accepts_what_the_kernel_reads(case):
    """bf16 at any D % 8 == 0 on 16-byte bounds, views included; f32 copies
    scalars, so any width up to 128 and any alignment."""
    q, k, v, out = {
        "bf16_d16": lambda: _bf16_qkv_out(16),
        "bf16_d24_strided_view": lambda: _bf16_qkv_out(24, pad=8, offset=8),
        "f32_d12_offset": lambda: tuple(
            t.float() for t in _bf16_qkv_out(12, pad=1, offset=1)),
    }[case]()
    coattention._check_launchable(q, k, v, out)
