"""The dense attention's core as one kernel (``ops/dense_attention.py``):
its plain version against the JAX package's ``multi_head_attention``, its
wrapper's checks, its gate and its wiring into the served forward, on the
CPU.

Both sides get the same seeded numpy q, k, v and mask. Shapes: the text
self-attention (12 heads × 38 × 38, head_dim 64), a tp = 2 rank's 6 heads,
and 38 queries over 101 keys (Nq ≠ Nk), at batch 1 and 3, masked, unmasked
and with no bias, the bias in the compute dtype or in f32. Tolerances: f32
within 2e-5 · max(1, |ref|) (the JAX package's kernel tolerance: only the
summation order differs); bf16 within one bf16 ulp of max(1, |ref|),
2⁻⁷ · max(1, |ref|) (the two frameworks round at the same places, and a
score that rounds the other way moves one weight by one ulp).

The kernel itself runs only on the card: chip_smoke.py holds it against
this plain version at the served shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_port_helpers as H
from vilbert_multitask_tpu.ops.attention import (
    mask_to_bias as jax_mask_to_bias,
)
from vilbert_multitask_tpu.ops.attention import (
    multi_head_attention as jax_mha,
)
from vilbert_multitask_tpu_torch.engine.graphs import launches_per_forward
from vilbert_multitask_tpu_torch.ops import dense_attention as dense_ops
from vilbert_multitask_tpu_torch.ops.attention import (
    FusedSelfAttention,
    _inv_sqrt,
    mask_to_bias,
    multi_head_attention,
)

F32_TOL = 2e-5
BF16_ULP = 2.0 ** -7  # one bf16 ulp at magnitude 1
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (H, Nq, Nk, D)
SHAPES = {"text": (12, 38, 38, 64), "tp2_rank": (6, 38, 38, 64),
          "nq_ne_nk": (12, 38, 101, 64)}


def _case(shape: str, batch: int, seed: int = 0):
    H_, Nq, Nk, D = SHAPES[shape]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, Nq, H_, D)).astype(np.float32)
    k = rng.normal(size=(batch, Nk, H_, D)).astype(np.float32)
    v = rng.normal(size=(batch, Nk, H_, D)).astype(np.float32)
    mask = np.ones((batch, Nk), np.int32)
    mask[-1, Nk - Nk // 4:] = 0  # the last row's tail of keys masked
    return q, k, v, mask


def _close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    got, want = got.astype(np.float64), want.astype(np.float64)
    tol = F32_TOL if dtype == "float32" else BF16_ULP
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, err.max()


# (dtype, shape, batch, mask, bias dtype)
PARITY = ([(dt, shape, 1, "masked", "compute")
           for dt in DTYPES for shape in SHAPES]
          + [(dt, shape, 3, mask, bias)
             for dt in DTYPES for shape in ("text", "tp2_rank")
             for mask, bias in (("masked", "compute"), ("masked", "f32"),
                                ("unmasked", "compute"), ("none", None))]
          + [("bfloat16", "nq_ne_nk", 3, "masked", "f32")])


@pytest.mark.parametrize("dtype,shape,batch,mask,bias_dtype", PARITY)
def test_plain_matches_jax_multi_head_attention(dtype, shape, batch, mask,
                                                bias_dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, m = _case(shape, batch)
    if mask == "unmasked":
        m[:] = 1
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jbias = tbias = None
    if mask != "none":
        jbias = jax_mask_to_bias(
            jnp.asarray(m), jdt if bias_dtype == "compute" else jnp.float32)
        tbias = mask_to_bias(torch.from_numpy(m),
                             tdt if bias_dtype == "compute"
                             else torch.float32)
    ctx, _ = jax_mha(jq, jk, jv, jbias, dtype=jdt)
    B, Nq, H_, D = q.shape
    want = np.asarray(ctx.astype(jnp.float32)).reshape(B, Nq, H_ * D)
    got = dense_ops.dense_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), tbias,
        _inv_sqrt(D, tdt))
    assert got.dtype == tdt and got.shape == (B, Nq, H_ * D)
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_is_the_composition_the_port_ran_before(dtype):
    """The plain version is ``multi_head_attention``'s context, reshaped as
    the output projection reads it: the same bits."""
    tdt = DTYPES[dtype][0]
    q, k, v, m = (torch.from_numpy(a) for a in _case("text", 3, seed=5))
    q, k, v = (t.to(tdt) for t in (q, k, v))
    bias = mask_to_bias(m, tdt)
    scale = _inv_sqrt(64, tdt)
    ctx, _ = multi_head_attention(q, k, v, bias, dtype=tdt)
    assert torch.equal(dense_ops.dense_attention_plain(q, k, v, bias, scale),
                       ctx.reshape(3, 38, 12 * 64))


# ------------------------------------------------------------- the wrapper
def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v, m = (torch.from_numpy(a) for a in _case("tp2_rank", 1))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    bias = mask_to_bias(m, torch.bfloat16)
    before = dense_ops.dense_attention.launches
    got = dense_ops.dense_attention(q, k, v, bias, 0.125)
    assert torch.equal(got, dense_ops.dense_attention_plain(q, k, v, bias,
                                                            0.125))
    assert dense_ops.dense_attention.launches == before


def _launch_case(case: str):
    bf = torch.bfloat16

    def qkv(B=2, Nq=38, Nk=38, H_=12, D=64, dtype=bf):
        # The three Linear outputs' (B, N, H, D) views, as the model makes
        # them.
        return (torch.zeros(B, Nq, H_ * D, dtype=dtype).view(B, Nq, H_, D),
                torch.zeros(B, Nk, H_ * D, dtype=dtype).view(B, Nk, H_, D),
                torch.zeros(B, Nk, H_ * D, dtype=dtype).view(B, Nk, H_, D))

    def bias(B=2, Nk=38, dtype=bf):
        return mask_to_bias(torch.ones(B, Nk), dtype)

    fused = torch.zeros(2, 38, 3, 12, 64, dtype=bf)
    q, k, v = qkv()
    grad_q = torch.zeros(2, 38, 12, 64, dtype=bf, requires_grad=True)
    return {
        "served_text": (q, k, v, bias()),
        "tp2_rank_6_heads": (*qkv(H_=6), bias()),
        "f32_bias": (q, k, v, bias(dtype=torch.float32)),
        "no_bias": (q, k, v, None),
        "fused_qkv_views": (fused[:, :, 0], fused[:, :, 1], fused[:, :, 2],
                            bias()),
        "head_dim_16": (*qkv(H_=2, D=16), bias()),
        "head_dim_128": (*qkv(H_=8, D=128), bias()),
        "nq_ne_nk_128_keys": (*qkv(Nq=101, Nk=128), bias(Nk=128)),
        "one_key": (*qkv(Nk=1), bias(Nk=1)),
        # rejected
        "f32_qkv": (*qkv(dtype=torch.float32), bias()),
        "f16_qkv": (*qkv(dtype=torch.float16), bias()),
        "f32_k": (q, k.float(), v, bias()),
        "f64_bias": (q, k, v, bias(dtype=torch.float64)),
        "head_dim_24": (*qkv(H_=8, D=24), bias()),
        "head_dim_144": (*qkv(H_=4, D=144), bias()),
        "129_keys": (*qkv(Nk=129), bias(Nk=129)),
        "head_stride_not_16_bytes": (
            torch.zeros(2, 38, 12, 68, dtype=bf)[..., :64], k, v, bias()),
        "start_off_16_bytes": (
            torch.zeros(2 * 38 * 768 + 4, dtype=bf)[4:].view(2, 38, 12, 64),
            k, v, bias()),
        "head_dim_strided": (torch.zeros(2, 38, 12, 128, dtype=bf)[..., ::2],
                             k, v, bias()),
        "bias_keys_strided": (q, k, v,
                              torch.zeros(2, 1, 1, 76, dtype=bf)[..., ::2]),
        "recorded_gradient": (grad_q, k, v, bias()),
    }[case]


@pytest.mark.parametrize("case", [
    "served_text", "tp2_rank_6_heads", "f32_bias", "no_bias",
    "fused_qkv_views", "head_dim_16", "head_dim_128", "nq_ne_nk_128_keys",
    "one_key"])
def test_launch_check_accepts_what_the_kernel_reads(case):
    dense_ops._check_launchable(*_launch_case(case))


@pytest.mark.parametrize("case,error", [
    ("f32_qkv", TypeError), ("f16_qkv", TypeError), ("f32_k", TypeError),
    ("f64_bias", TypeError), ("head_dim_24", ValueError),
    ("head_dim_144", ValueError), ("129_keys", ValueError),
    ("head_stride_not_16_bytes", ValueError),
    ("start_off_16_bytes", ValueError), ("head_dim_strided", ValueError),
    ("bias_keys_strided", ValueError), ("recorded_gradient", RuntimeError)])
def test_launch_check_rejects_what_the_kernel_cannot_read(case, error):
    with pytest.raises(error):
        dense_ops._check_launchable(*_launch_case(case))


@pytest.mark.parametrize("bad", ["head_count", "values", "bias_per_query",
                                 "devices"])
def test_wrapper_rejects_bad_shapes(bad):
    q = torch.zeros(2, 5, 3, 16)
    kv = torch.zeros(2, 7, 3, 16)
    bias = torch.zeros(2, 1, 1, 7)
    args = {"head_count": (q, torch.zeros(2, 7, 2, 16),
                           torch.zeros(2, 7, 2, 16), bias),
            "values": (q, kv, torch.zeros(2, 6, 3, 16), bias),
            "bias_per_query": (q, kv, kv, torch.zeros(2, 1, 5, 7)),
            "devices": (q, kv, kv.to("meta"), bias)}[bad]
    with pytest.raises(ValueError):
        dense_ops.dense_attention(*args, 0.25)


# --------------------------------------------------------------- the gate
def _attention_calls(calls: dict) -> dict:
    return {k: calls[k] for k in ("dense_attention", "scaled_masked_softmax")}


def _text_layer(dtype, *, tokens=38, dropout=0.0):
    """One full-width text self-attention (768 wide, 12 heads of 64) on
    seeded weights, its input and mask bias."""
    torch.manual_seed(0)
    attn = FusedSelfAttention(768, 12, dropout_rate=dropout).to(dtype).eval()
    x = torch.randn(2, tokens, 768, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    mask = torch.ones(2, tokens)
    mask[1, tokens - 7:] = 0
    return attn, x, mask_to_bias(mask, dtype)


def test_a_served_text_attention_takes_the_kernel_with_the_same_bits(
        monkeypatch):
    """A bf16 call under no_grad takes the dense core's entry point once,
    and gives the bits of the composition it replaced."""
    attn, x, bias = _text_layer(torch.bfloat16)
    calls = H.spy_row_kernels(monkeypatch)
    with torch.no_grad():
        got, probs = attn(x, bias)
        shape = (2, 38, 12, 64)
        q, k, v = (p(x).view(shape) for p in (attn.query, attn.key,
                                              attn.value))
    assert _attention_calls(calls) == {"dense_attention": 1,
                                       "scaled_masked_softmax": 0}
    assert probs is None and got.dtype == torch.bfloat16
    want, _ = multi_head_attention(q, k, v, bias, dtype=torch.bfloat16)
    assert torch.equal(got, want.reshape(2, 38, 768))


def test_a_head_dim_of_48_takes_the_kernel(monkeypatch):
    """The gate asks head_dim % 16, not a power of two."""
    attn = FusedSelfAttention(96, 2, dropout_rate=0.0).bfloat16().eval()
    calls = H.spy_row_kernels(monkeypatch)
    with torch.no_grad():
        attn(torch.randn(1, 9, 96).bfloat16(),
             mask_to_bias(torch.ones(1, 9), torch.bfloat16))
    assert _attention_calls(calls) == {"dense_attention": 1,
                                       "scaled_masked_softmax": 0}


@pytest.mark.parametrize("case", ["f32", "recorded", "dropout",
                                  "129_tokens"])
def test_everything_else_keeps_the_composition(monkeypatch, case):
    """An f32 call, a call autograd records, dropout, text longer than 128
    tokens: the composition (einsum, the softmax's entry point, einsum),
    not the dense core."""
    attn, x, bias = _text_layer(
        torch.float32 if case == "f32" else torch.bfloat16,
        tokens=129 if case == "129_tokens" else 38,
        dropout=0.1 if case == "dropout" else 0.0)
    if case == "dropout":
        attn.train()
    calls = H.spy_row_kernels(monkeypatch)
    with torch.set_grad_enabled(case == "recorded"):
        out, _ = attn(x, bias)
    assert _attention_calls(calls) == {
        "dense_attention": 0,
        "scaled_masked_softmax": 0 if case == "recorded" else 1}
    if case == "recorded":
        assert out.grad_fn is not None


def test_the_full_serving_config_counts():
    """What chip_smoke.py reads on the card at full width: 12 dense cores
    and no softmax a bucket-1 forward; collected maps add the bridges' 12
    softmaxes; an f32 engine's text layers take the softmax."""
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        ViLBertConfig,
    )

    full = ViLBertConfig()
    for rows in (1, 2, 32):
        got = launches_per_forward(full, rows)
        assert (got["dense_attention"], got["scaled_masked_softmax"]) == (
            12, 0)
    got = launches_per_forward(full, 1, collect_attention=True)
    assert (got["dense_attention"], got["scaled_masked_softmax"]) == (12, 12)
    got = launches_per_forward(full, 1,
                               ecfg=EngineConfig(compute_dtype="float32"))
    assert (got["dense_attention"], got["scaled_masked_softmax"]) == (0, 12)


@pytest.fixture(scope="module")
def text_engine(tmp_path_factory):
    """A tiny CPU engine whose text heads are 16 wide, so its text
    self-attentions pass the dense core's gate as the full config's do
    (the tiny config's own are 12 wide)."""
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        FrameworkConfig,
        ViLBertConfig,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine,
        init_state_dict,
    )
    from vilbert_multitask_tpu_torch.features.store import FeatureStore

    root = tmp_path_factory.mktemp("dense_wiring")
    mcfg = ViLBertConfig().tiny(hidden_size=64)
    H.write_feature_files(str(root), mcfg.v_feature_size, ["img_a", "img_b"])
    cfg = FrameworkConfig(model=mcfg, engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2), throughput_buckets=None))
    return InferenceEngine(cfg, params=init_state_dict(mcfg, seed=0),
                           feature_store=FeatureStore(str(root)),
                           device="cpu")


@pytest.mark.parametrize("task_id,images,collect", [
    (1, ["img_a"], False), (12, ["img_a", "img_b"], False),
    (1, ["img_a"], True)], ids=["bucket1", "bucket2_nlvr2", "bucket1_maps"])
def test_the_served_forward_calls_the_dense_core_per_layer(
        text_engine, monkeypatch, task_id, images, collect):
    """Each text and visual self-attention of a served forward calls the
    dense core (4 + 2 in this config), none the softmax; collected maps
    send the bridges' 4 directions to the softmax: as
    engine/graphs.py:launches_per_forward counts them."""
    mcfg = text_engine.model_config
    calls = H.spy_row_kernels(monkeypatch)
    req = text_engine.prepare_from_store(task_id, "what is here", images)
    out = text_engine.run(req, collect_attention=collect)
    want = launches_per_forward(mcfg, req.bucket, collect_attention=collect,
                                ecfg=text_engine.cfg.engine)
    assert calls == {k: want[k] for k in calls}
    assert _attention_calls(calls) == {
        "dense_attention": (mcfg.num_hidden_layers
                            + mcfg.v_num_hidden_layers),
        "scaled_masked_softmax": 4 if collect else 0}
    assert out is not None


def test_a_training_step_calls_neither(monkeypatch):
    """The trainer's steps record gradients under bf16 autocast: no call
    reaches the dense core's entry point (nor the softmax's wrapper), and
    the losses stay finite, with attention dropout off so only the gate's
    recorded-gradient clause keeps the kernel out."""
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        FrameworkConfig,
        ViLBertConfig,
    )
    from vilbert_multitask_tpu_torch.train.loop import (
        LoopConfig,
        MultiTaskSampler,
        SyntheticTaskData,
        Trainer,
    )

    cfg = FrameworkConfig(
        model=ViLBertConfig().tiny(hidden_size=64,
                                   attention_probs_dropout_prob=0.0,
                                   v_attention_probs_dropout_prob=0.0),
        engine=EngineConfig(max_text_len=12, max_regions=9,
                            compute_dtype="bfloat16",
                            use_pallas_coattention=False,
                            use_pallas_self_attention=False))
    logs = []
    trainer = Trainer(cfg, MultiTaskSampler({"vqa": SyntheticTaskData(
        "vqa", cfg)}), LoopConfig(total_steps=2, batch_size=2, log_every=1,
                                  ckpt_every=10_000, warmup_steps=1),
        device="cpu", log_fn=logs.append)
    calls = H.spy_row_kernels(monkeypatch)
    trainer.train()
    assert calls == dict.fromkeys(calls, 0)
    assert len(logs) == 2
