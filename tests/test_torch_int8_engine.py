"""The port's int8 storage mode (``EngineConfig.param_dtype="int8"``)
against the JAX package's int8 engine, on the CPU, on the same weights.

One noisy seeded f32 tree (tiny config) feeds both packages: the JAX int8
engine quantizes it host-side, the port's int8 engine quantizes its
``from_flax_params`` copy (test_torch_quant.py holds the two quantizations
bit-equal). The port's kernel routes are on and take their plain versions
on the CPU; the JAX engine runs dense attention.

Tolerances, each with its reason:
- head slabs: bit-equal (the same host operations on the same values);
- f32 compute: every decode family's head within 1e-5 and the same
  decoded answers (summation order only);
- bf16 compute: every head within ``BF16_ATOL`` = 2^-4 absolute, four
  bf16 steps at the largest head values (|v| < 4). The two bf16 engines
  round at other places (attention, LayerNorm order, GELU), and the float
  bf16 engines on the same weights differ as much
  (``test_bf16_float_engines_differ_as_much``). Where the int8 engine's
  trunk LayerNorms compute (f32 affine step on bf16-rounded parameters) is
  held exactly by ``test_rounded_layer_norm_is_flax_layer_norm_with_bf16_
  parameters``;
- int8 against f32: rtol 0.15 / atol 0.15, the JAX package's own int8
  decode gate (tests/test_engine.py:484).
"""

from __future__ import annotations

import dataclasses
import http.client

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_same_result, write_feature_files
from vilbert_multitask_tpu import quant as jquant
from vilbert_multitask_tpu.config import (
    TASK_REGISTRY,
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu.engine.runtime import InferenceEngine as JaxEngine
from vilbert_multitask_tpu.features.store import FeatureStore as JaxStore
from vilbert_multitask_tpu_torch import quant
from vilbert_multitask_tpu_torch.checkpoint import save_params
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.config import FrameworkConfig as PortFramework
from vilbert_multitask_tpu_torch.engine.flops import param_tree_bytes
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
from vilbert_multitask_tpu_torch.features.store import FeatureStore
from vilbert_multitask_tpu_torch.models.int8 import (
    QuantLinear,
    RoundedLayerNorm,
)
from vilbert_multitask_tpu_torch.serve.app import ServeApp

F32 = dict(rtol=1e-4, atol=1e-5)
INT8_VS_F32 = dict(rtol=0.15, atol=0.15)
BF16_ATOL = 2.0 ** -4
IMAGES = ("img_a", "img_b", "img_c", "img_d")
JAX_CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2, 4), compute_dtype="float32",
        throughput_buckets=None, param_dtype="int8",
        use_pallas_coattention=False, use_pallas_self_attention=False))


def _jax_cfg(**engine):
    return dataclasses.replace(JAX_CFG, engine=dataclasses.replace(
        JAX_CFG.engine, **engine))


def _port_cfg(**engine):
    cfg = PortFramework.from_dict(dataclasses.asdict(JAX_CFG))
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, use_pallas_coattention=True,
        use_pallas_self_attention=True, **engine))


def _paths(task_id):
    spec = TASK_REGISTRY[task_id]
    n = 3 if spec.decode == "ranking" else spec.min_images
    return list(IMAGES[:n])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_int8_features"))
    write_feature_files(d, JAX_CFG.model.v_feature_size, IMAGES)
    seed = JaxEngine(_jax_cfg(param_dtype="float32"), seed=0)
    noise = np.random.default_rng(1)
    host = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * noise.normal(size=x.shape).astype(np.float32),
        jax.device_get(seed.params))
    sd = from_flax_params(host, _port_cfg().model)
    store = FeatureStore(d)
    return dict(
        root=d, host=host, sd=sd,
        jax=JaxEngine(JAX_CFG, params=host, feature_store=JaxStore(d)),
        port=InferenceEngine(_port_cfg(), params=sd, feature_store=store,
                             device="cpu"),
        port32=InferenceEngine(_port_cfg(param_dtype="float32"), params=sd,
                               feature_store=store, device="cpu"))


def test_int8_engine_holds_int8_pairs_and_a_third_of_the_bytes(world):
    eng = world["port"]
    served = eng.state_dict()
    assert quant.tree_is_quantized(served)
    for key, v in served.items():
        if quant.is_quantized_leaf(v):
            assert v[quant.QVALUES].dtype == torch.int8, key
            assert v[quant.QSCALE].dtype == torch.float32, key
        else:
            assert v.dtype == torch.float32, key
    ratio = (param_tree_bytes(served)
             / param_tree_bytes(world["port32"].state_dict()))
    assert ratio < 0.35, ratio
    lin = eng.model.bert.encoder.layer[0].intermediate.dense
    assert isinstance(lin, QuantLinear)
    assert lin.qweight.dtype == torch.int8


def test_head_slabs_are_bit_equal_to_the_jax_engines(world):
    """The JAX engine dequantizes the served heads to f32, stacks them and
    quantizes every kernel slab again (one scale per output column, shared
    by the VQA and GQA heads); the port's slabs hold the same int8 values
    (in torch's (out, in) layout) and scales."""
    jslabs = jax.device_get(world["jax"].head_slabs)
    pslabs = world["port"].head_slabs
    for name, want in jslabs.items():
        if jquant.is_quantized_leaf(want):
            q = pslabs[name]
            assert q.dtype == torch.int8, name
            np.testing.assert_array_equal(
                q.transpose(-1, -2).numpy(), want["int8"], err_msg=name)
            scale = pslabs[name + "_scale"].numpy()
            for row in scale.reshape(-1, scale.shape[-1]):
                np.testing.assert_array_equal(row, want["scale"],
                                              err_msg=name)
        else:
            np.testing.assert_array_equal(pslabs[name].numpy(),
                                          np.asarray(want), err_msg=name)
    # The padded GQA columns share the VQA columns' scales.
    assert (jslabs["label_d2_kernel"]["scale"] > 0).all()


@pytest.mark.parametrize("task_id", sorted(TASK_REGISTRY))
def test_every_family_matches_the_jax_int8_engine_f32(world, task_id):
    spec = TASK_REGISTRY[task_id]
    question = spec.placeholder or "what is in the picture"
    jout, jres = world["jax"].run(world["jax"].prepare_from_store(
        task_id, question, _paths(task_id)))
    pout, pres = world["port"].run(world["port"].prepare_from_store(
        task_id, question, _paths(task_id)))
    np.testing.assert_allclose(
        getattr(pout, spec.head).float().numpy(),
        np.asarray(jax.device_get(getattr(jout, spec.head)), np.float32),
        rtol=0, atol=1e-5, err_msg=spec.head)
    assert_same_result(pres.to_json(), jres.to_json(), F32)


def _bf16_engines(world):
    jeng = JaxEngine(_jax_cfg(compute_dtype="bfloat16"), params=world["host"],
                     feature_store=JaxStore(world["root"]))
    peng = InferenceEngine(_port_cfg(compute_dtype="bfloat16"),
                           params=world["sd"],
                           feature_store=FeatureStore(world["root"]),
                           device="cpu")
    return jeng, peng


def _worst_bf16_gap(jeng, peng) -> float:
    worst = 0.0
    for task_id, spec in sorted(TASK_REGISTRY.items()):
        question = spec.placeholder or "what is in the picture"
        jout, _ = jeng.run(jeng.prepare_from_store(task_id, question,
                                                   _paths(task_id)))
        pout, _ = peng.run(peng.prepare_from_store(task_id, question,
                                                   _paths(task_id)))
        want = np.asarray(jax.device_get(getattr(jout, spec.head)),
                          np.float32)
        got = getattr(pout, spec.head).float().numpy()
        if spec.decode == "grounding":  # masked regions sit at -9984
            keep = want > -1000
            want, got = want[keep], got[keep]
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


def test_bf16_int8_engine_matches_the_jax_int8_engine_bf16(world):
    jeng, peng = _bf16_engines(world)
    worst = _worst_bf16_gap(jeng, peng)
    assert worst <= BF16_ATOL, worst


def test_bf16_float_engines_differ_as_much(world):
    """The yardstick of the bf16 tolerance: the port's and the JAX
    package's FLOAT bf16 engines on the same weights differ by about as
    much as the two int8 engines do."""
    jeng = JaxEngine(_jax_cfg(compute_dtype="bfloat16",
                              param_dtype="float32"),
                     params=world["host"],
                     feature_store=JaxStore(world["root"]))
    peng = InferenceEngine(_port_cfg(compute_dtype="bfloat16",
                                     param_dtype="float32"),
                           params=world["sd"],
                           feature_store=FeatureStore(world["root"]),
                           device="cpu")
    assert 2.0 ** -8 < _worst_bf16_gap(jeng, peng) <= BF16_ATOL


def test_rounded_layer_norm_is_flax_layer_norm_with_bf16_parameters():
    """The JAX int8 engine's trunk LayerNorms run with their parameters
    cast to bf16 (dequantize_tree casts every leaf); flax then promotes
    them back and runs the affine step in f32. The port's RoundedLayerNorm
    keeps the f32 masters and computes with them rounded: bit-equal. The
    unrounded f32 parameters give other numbers."""
    import flax.linen as fnn

    from vilbert_multitask_tpu_torch.models.layers import LayerNorm

    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 48)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    b = (0.1 * rng.normal(size=48)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(fnn.LayerNorm(epsilon=1e-12, dtype=jnp.bfloat16).apply(
        {"params": {"scale": jnp.asarray(w).astype(jnp.bfloat16),
                    "bias": jnp.asarray(b).astype(jnp.bfloat16)}}, xb
    ).astype(jnp.float32))
    norm = LayerNorm(48, eps=1e-12)
    rounded = RoundedLayerNorm(norm, torch.bfloat16)
    rounded.load_state_dict({"weight": torch.from_numpy(w),
                             "bias": torch.from_numpy(b)})
    xt = torch.from_numpy(x).to(torch.bfloat16)
    norm.load_state_dict({"weight": torch.from_numpy(w),
                          "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = rounded(xt).float().numpy()
        unrounded = norm(xt).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert (unrounded != want).mean() > 0.1


@pytest.mark.parametrize("task_id", sorted(TASK_REGISTRY))
def test_int8_engine_within_the_int8_gate_of_the_f32_engine(world, task_id):
    spec = TASK_REGISTRY[task_id]
    question = spec.placeholder or "what is in the picture"
    outs = [eng.run(eng.prepare_from_store(task_id, question,
                                           _paths(task_id)))
            for eng in (world["port"], world["port32"])]
    (qout, qres), (fout, fres) = outs
    np.testing.assert_allclose(getattr(qout, spec.head).float().numpy(),
                               getattr(fout, spec.head).float().numpy(),
                               err_msg=spec.head, **INT8_VS_F32)
    assert qres.kind == fres.kind and qres.task_id == fres.task_id


def test_load_params_requantizes_in_place_and_republishes_slabs(world):
    """JAX ``test_swap_requantizes_f32_checkpoint``: an f32 tree x1.01 is
    quantized again into the same tensors (captured graphs keep reading
    them), the slabs follow, and an already-quantized tree passes through
    unchanged."""
    eng = InferenceEngine(_port_cfg(), params=world["sd"],
                          feature_store=FeatureStore(world["root"]),
                          device="cpu")
    lin = eng.model.bert.encoder.layer[1].output.dense
    ptrs = (lin.qweight.data_ptr(), lin.scale.data_ptr(),
            eng.head_slabs["label_d2_kernel"].data_ptr())
    slab_before = eng.head_slabs["label_d2_kernel"].clone()
    bumped = {k: v * 1.01 for k, v in world["sd"].items()}
    eng.load_params(bumped)
    assert (lin.qweight.data_ptr(), lin.scale.data_ptr(),
            eng.head_slabs["label_d2_kernel"].data_ptr()) == ptrs
    want = quant.quantize_tree(bumped)["bert.encoder.layer.1.output.dense.weight"]
    np.testing.assert_array_equal(lin.qweight.numpy(), want[quant.QVALUES])
    np.testing.assert_array_equal(lin.scale.numpy(), want[quant.QSCALE])
    assert not torch.equal(eng.head_slabs["label_d2_kernel"], slab_before) \
        or not torch.equal(eng.head_slabs["label_d2_kernel_scale"],
                           world["port"].head_slabs["label_d2_kernel_scale"])
    served = {k: quant.leaf_to(v, "cpu") for k, v in
              eng.state_dict().items()}
    served = {k: ({n: t.clone() for n, t in v.items()}
                  if quant.is_quantized_leaf(v) else v.clone())
              for k, v in served.items()}
    slabs = {k: v.clone() for k, v in eng.head_slabs.items()}
    eng.load_params(served)
    again = eng.state_dict()
    for key, v in served.items():
        if quant.is_quantized_leaf(v):
            assert torch.equal(again[key][quant.QVALUES], v[quant.QVALUES])
            assert torch.equal(again[key][quant.QSCALE], v[quant.QSCALE])
        else:
            assert torch.equal(again[key], v), key
    assert all(torch.equal(eng.head_slabs[k], v) for k, v in slabs.items())
    _, res = eng.run(eng.prepare_from_store(1, "what is this", ["img_a"]))
    assert res.task_id == 1


def test_run_many_equals_run_on_the_int8_engine(world):
    eng = world["port"]
    reqs = [eng.prepare_from_store(t, f"question {k}", _paths(t))
            for k, t in enumerate((1, 12, 15, 13, 4, 1))]
    batched = eng.run_many(reqs)
    for req, got in zip(reqs, batched):
        _, want = eng.run(req)
        assert_same_result(got.to_json(), want.to_json(), F32)


def test_param_dtype_is_checked(world):
    with pytest.raises(ValueError, match="param_dtype"):
        InferenceEngine(_port_cfg(param_dtype="int4"), params=world["sd"],
                        device="cpu")
    with pytest.raises(ValueError, match="param_dtype='int8'"):
        world["port32"].load_params(world["port"].state_dict())


def _serving(cfg, tmp_path):
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, queue_db_path=str(tmp_path / "q.sqlite3"),
        results_db_path=str(tmp_path / "r.sqlite3"),
        media_root=str(tmp_path / "media"), http_port=0, ws_port=0))


def _build_info(app) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", app.http_port, timeout=30)
    conn.request("GET", "/metrics?format=prometheus")
    text = conn.getresponse().read().decode()
    return next(line for line in text.splitlines()
                if line.startswith("vmt_build_info{"))


def test_serveapp_int8_from_a_checkpoint_answers_like_jax(world, tmp_path):
    """An int8 deployment boots from an f32 checkpoint of this package
    (restored and quantized on the host), answers as the JAX int8 engine's
    predict does, and /metrics reports param_dtype="int8"."""
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, world["sd"])
    app = ServeApp(_serving(_port_cfg(), tmp_path),
                   feature_root=world["root"], checkpoint_path=ckpt,
                   device="cpu")
    try:
        eng = app.engine.replicas[0].engine
        assert eng.param_quantized and quant.tree_is_quantized(
            eng.state_dict())
        for task_id in (1, 13, 12):
            question = TASK_REGISTRY[task_id].placeholder or "what"
            images = [f"{n}.jpg" for n in _paths(task_id)]
            assert_same_result(
                eng.predict(task_id, question, images).to_json(),
                world["jax"].predict(task_id, question, images).to_json(),
                F32)
        app.start(worker=False)
        assert 'param_dtype="int8"' in _build_info(app)
    finally:
        app.stop()


def test_float_app_reports_its_param_dtype_not_its_compute_dtype(
        world, tmp_path):
    app = ServeApp(_serving(_port_cfg(param_dtype="float32",
                                      compute_dtype="bfloat16"), tmp_path),
                   engine=world["port32"], device="cpu")
    try:
        app.start(worker=False)
        line = _build_info(app)
        assert 'param_dtype="float32"' in line and "bfloat16" not in line
    finally:
        app.stop()


def test_rolling_swap_of_an_f32_checkpoint_requantizes(world, tmp_path):
    ckpt = str(tmp_path / "ckpt32")
    save_params(ckpt, {k: v * 1.01 for k, v in world["sd"].items()})
    eng = InferenceEngine(_port_cfg(), params=world["sd"],
                          feature_store=FeatureStore(world["root"]),
                          device="cpu")
    app = ServeApp(_serving(_port_cfg(), tmp_path), engine=eng, device="cpu")
    try:
        app.rolling_swap(checkpoint_path=ckpt)
    finally:
        app.stop()
    want = quant.quantize_tree({k: v * 1.01 for k, v in world["sd"].items()})
    key = "bert.v_embeddings.image_location_embeddings.weight"
    got = eng.state_dict()[key]
    np.testing.assert_array_equal(got[quant.QVALUES].numpy(),
                                  want[key][quant.QVALUES])
