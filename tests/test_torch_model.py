"""The PyTorch port's ViLBERT against the JAX package's, on the same weights.

The JAX tree (seeded init + seeded noise on every leaf) crosses over with
the port's ``from_flax_params``; inputs are seeded numpy. On the CPU the
port's kernel wrapper takes its plain version; the JAX Pallas kernel runs in
interpret mode.

Tolerances: f32 parity at atol 2e-5 / rtol 1e-5 (f32 rounding through a
4+2-layer trunk, differently ordered sums); f64 parity at 1e-9, the repo's
own conversion-oracle bound (tests/test_checkpoint_oracle.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    OUTPUT_FIELDS,
    assert_outputs_close,
    jax_forward,
    model_inputs,
    port_forward,
    port_inputs,
    port_model,
    seeded_params,
    to_port_config,
)
from vilbert_multitask_tpu.checkpoint.convert import to_torch_state_dict
from vilbert_multitask_tpu.config import ViLBertConfig
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.models.heads import build_head_slabs
from vilbert_multitask_tpu_torch.models.vilbert import (
    ViLBertForVLTasks,
    fused_head_output,
)
from vilbert_multitask_tpu_torch.ops import coattention

F32 = dict(atol=2e-5, rtol=1e-5)
F64 = dict(atol=1e-9, rtol=1e-9)

TINY = ViLBertConfig().tiny()
# A 128-wide visual head (2 x 128): the visual self-attention takes the
# kernel route too, which the tiny config's 16-wide heads never do.
WIDE_V = ViLBertConfig().tiny(v_hidden_size=256, v_num_attention_heads=2,
                              v_intermediate_size=256)


@pytest.fixture(scope="module")
def tiny():
    return TINY, seeded_params(TINY, seed=0), model_inputs(TINY, seed=1)


@pytest.fixture(scope="module")
def wide_v():
    return WIDE_V, seeded_params(WIDE_V, seed=2), model_inputs(WIDE_V,
                                                                seed=3)


@pytest.mark.parametrize("collect", [False, True],
                         ids=["kernel_routes", "attention_maps"])
def test_all_outputs_match_jax_f32(tiny, collect):
    """All ten outputs, attention maps included when collected (the bridges
    then take the dense path on both sides)."""
    cfg, params, inp = tiny
    want = jax_forward(cfg, params, inp, pallas=True, collect=collect)
    got = port_forward(port_model(cfg, params), inp, collect=collect)
    assert len(got["attn_data_list"]) == (
        cfg.num_connection_layers if collect else 0)
    assert_outputs_close(got, want, **F32)


def test_all_outputs_match_jax_f64(tiny):
    """f64 on both sides (JAX under enable_x64, dense attention: its kernel
    keeps f32 state; the port's plain kernel promotes to f64)."""
    cfg, params, inp = tiny
    want = jax_forward(cfg, params, inp, dtype=np.float64, collect=True)
    got = port_forward(port_model(cfg, params, dtype=torch.float64), inp,
                       dtype=torch.float64, collect=True)
    assert got["vil_prediction"].dtype == np.float64
    assert_outputs_close(got, want, **F64)


def test_jax_kernel_on_and_off_agree(tiny):
    """The reference itself: JAX with its Pallas kernel on and off."""
    cfg, params, inp = tiny
    assert_outputs_close(jax_forward(cfg, params, inp, pallas=True),
                         jax_forward(cfg, params, inp, pallas=False), **F32)


def test_wide_visual_head_takes_both_kernel_routes(wide_v, monkeypatch):
    """With 128-wide visual heads the port sends the visual self-attention
    AND the bridges through the kernel wrapper, and still matches JAX
    (kernel on, interpret mode)."""
    cfg, params, inp = wide_v
    calls = []
    real = coattention.flash_cross_attention

    def spy(q, k, v, bias):
        calls.append((q.shape[1], k.shape[1], q.shape[-1]))
        return real(q, k, v, bias)

    import vilbert_multitask_tpu_torch.ops.attention as attn

    monkeypatch.setattr(attn, "flash_cross_attention", spy)
    got = port_forward(port_model(cfg, params), inp)
    nv, nt = inp["image_mask"].shape[1], inp["input_mask"].shape[1] + 1
    assert calls.count((nv, nv, 128)) == cfg.v_num_hidden_layers
    assert calls.count((nt, nv, 16)) == cfg.num_connection_layers
    assert calls.count((nv, nt, 16)) == cfg.num_connection_layers
    assert len(calls) == cfg.v_num_hidden_layers + 2 * cfg.num_connection_layers
    want = jax_forward(cfg, params, inp, pallas=True)
    assert_outputs_close(got, want, **F32)


def test_text_self_attention_stays_dense_at_64_wide_heads(monkeypatch):
    """The head_dim % 128 gate: BERT-base text heads (768/12 = 64) never
    reach the kernel wrapper; the 1024/8 visual heads do."""
    from vilbert_multitask_tpu_torch.ops.attention import FusedSelfAttention

    seen = []
    import vilbert_multitask_tpu_torch.ops.attention as attn

    monkeypatch.setattr(attn, "flash_cross_attention",
                        lambda q, k, v, b: seen.append(q.shape) or q)
    x_t = torch.zeros(1, 5, 768)
    x_v = torch.zeros(1, 5, 1024)
    bias = torch.zeros(1, 1, 1, 5)
    _, probs_t = FusedSelfAttention(768, 12, use_pallas=True).eval()(x_t,
                                                                     bias)
    assert probs_t is not None and not seen
    FusedSelfAttention(1024, 8, use_pallas=True).eval()(x_v, bias)
    assert seen == [torch.Size([1, 5, 8, 128])]


def test_jax_converter_state_dict_loads_strict(tiny):
    """``load_state_dict(to_torch_state_dict(params, cfg), strict=True)``
    — the JAX package's own converter — loads, has exactly the port's keys,
    and gives the same outputs as the port's converter."""
    cfg, params, inp = tiny
    pcfg = to_port_config(cfg, use_pallas_coattention=True,
                          use_pallas_self_attention=True)
    sd_jax = to_torch_state_dict(params, cfg)
    sd_port = from_flax_params(params, pcfg)
    model = ViLBertForVLTasks(pcfg)
    assert set(sd_jax) == set(sd_port) == set(model.state_dict())
    for k in sd_jax:
        np.testing.assert_array_equal(sd_jax[k], sd_port[k], err_msg=k)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd_jax.items()}, strict=True)
    got = port_forward(model.eval(), inp)
    want = port_forward(port_model(cfg, params), inp)
    for f in OUTPUT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_swapped_bridge_direction_breaks_parity():
    """Falsifiability: swapping the biattention *1/*2 projections (shape-
    legal when both streams are equally wide) must break parity with JAX."""
    cfg = ViLBertConfig().tiny(hidden_size=32, num_attention_heads=4,
                               intermediate_size=32)
    params = seeded_params(cfg, seed=4)
    inp = model_inputs(cfg, seed=5)
    model = port_model(cfg, params)
    sd = model.state_dict()
    for i in range(cfg.num_connection_layers):
        base = f"bert.encoder.c_layer.{i}.biattention"
        for name in ("query", "key", "value"):
            for suffix in ("weight", "bias"):
                a, b = f"{base}.{name}1.{suffix}", f"{base}.{name}2.{suffix}"
                sd[a], sd[b] = sd[b].clone(), sd[a].clone()
    model.load_state_dict(sd, strict=True)
    want = jax_forward(cfg, params, inp)
    got = port_forward(model, inp)
    assert np.abs(got["vil_prediction"] - want["vil_prediction"]).max() > 1e-3


def test_fused_heads_match_per_head_and_jax(tiny):
    """The fused decode-head program against the per-head module path on a
    mixed-task batch, and against the JAX package's fused_head_output on
    the same trunk output."""
    import jax.numpy as jnp

    from vilbert_multitask_tpu.models.heads import (
        SERVING_HEAD_MODULES,
        build_head_slabs as jax_build_head_slabs,
    )
    from vilbert_multitask_tpu.models.vilbert import (
        fused_head_output as jax_fused_head_output,
    )

    cfg, params, _ = tiny
    inp = model_inputs(cfg, batch=6, seed=7)
    inp["task_ids"][:, 0] = [1, 15, 12, 12, 13, 4]
    model = port_model(cfg, params)
    args = port_inputs(inp)
    with torch.inference_mode():
        per_head = model(*args, compute_pretraining_heads=False)
        trunk = model.trunk(*args)
        slabs = build_head_slabs(model, model.config)
        fused, label_logits = fused_head_output(
            model.config, slabs, trunk, args[5], torch.float32)
    jslabs = jax_build_head_slabs(
        {n: params[n] for n in SERVING_HEAD_MODULES}, cfg)
    jtrunk = tuple(jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor)
                   else t for t in trunk)
    jfused, jlabels = jax_fused_head_output(
        cfg, jslabs, jtrunk, jnp.asarray(inp["image_mask"]), jnp.float32)
    np.testing.assert_allclose(label_logits.numpy(), np.asarray(jlabels),
                               **F32)
    for f in ("vil_prediction", "vil_prediction_gqa", "vil_logit",
              "vil_binary_prediction", "vil_tri_prediction", "vision_logit",
              "linguisic_logit"):
        a = getattr(fused, f).numpy()
        np.testing.assert_allclose(a, getattr(per_head, f).numpy(), **F32,
                                   err_msg=f)
        np.testing.assert_allclose(a, np.asarray(getattr(jfused, f)), **F32,
                                   err_msg=f)
    assert fused.vision_prediction is None
    assert fused.linguisic_prediction is None


def test_bf16_model_tracks_f32_jax(tiny):
    """bf16 compute on the port (weights cast once) stays within the repo's
    bf16 decode tolerance (rtol 0.1 / atol 0.05, tests/test_engine.py:438)
    of the JAX f32 forward."""
    cfg, params, inp = tiny
    model = port_model(cfg, params)
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Embedding)):
            mod.to(torch.bfloat16)
    got = port_forward(model, inp, dtype=torch.bfloat16)
    want = jax_forward(cfg, params, inp)
    for f in ("vil_prediction", "vil_prediction_gqa", "vil_logit",
              "vil_binary_prediction", "vil_tri_prediction",
              "vision_logit", "linguisic_logit"):
        np.testing.assert_allclose(got[f], want[f], rtol=0.1, atol=0.05,
                                   err_msg=f)


def test_config_round_trips_from_jax_config():
    """One config dump feeds both packages."""
    from vilbert_multitask_tpu.config import EngineConfig, FrameworkConfig

    from vilbert_multitask_tpu_torch.config import (
        FrameworkConfig as PortFramework,
    )

    jcfg = FrameworkConfig(model=TINY, engine=EngineConfig(
        max_text_len=12, image_buckets=(1, 2, 4), compute_dtype="float32"))
    pcfg = PortFramework.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg.model) == dataclasses.asdict(jcfg.model)
    for f in dataclasses.fields(pcfg.engine):
        assert getattr(pcfg.engine, f.name) == getattr(jcfg.engine, f.name)
    assert pcfg.serving.lowercase_questions == \
        jcfg.serving.lowercase_questions
