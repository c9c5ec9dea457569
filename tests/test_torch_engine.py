"""The port's InferenceEngine (device="cpu") against the JAX package's, on
the same tiny weights, feature files and questions.

Both engines use buckets (1, 2, 4) (the JAX one with throughput_buckets=None,
as the serving fixtures do). The JAX engine runs dense attention; the port
runs its kernel routes, which on the CPU take the plain version (the kernel
against dense attention is held in test_torch_model.py). Tolerances: f32
engines give the same answers in the same order, with scores and
confidences at rtol 1e-4 / atol 1e-5 (f32 rounding); the port's bf16 engine
is held to the repo's bf16 decode tolerance, rtol 0.1 / atol 0.05
(tests/test_engine.py:438).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_same_result
from vilbert_multitask_tpu.config import (
    TASK_REGISTRY,
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu.engine.runtime import (
    InferenceEngine as JaxEngine,
)
from vilbert_multitask_tpu.features.pipeline import RegionFeatures
from vilbert_multitask_tpu.features.store import (
    FeatureStore as JaxStore,
    save_reference_npy,
)
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.config import (
    FrameworkConfig as PortFramework,
)
from vilbert_multitask_tpu_torch.engine.runtime import (
    InferenceEngine as PortEngine,
)
from vilbert_multitask_tpu_torch.features.store import (
    FeatureStore as PortStore,
)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.1, atol=0.05)

QUESTIONS = {
    1: "what is the man holding",
    2: "what color is the car",
    15: "is the bowl right of the mug",
    4: "which object can you eat",
    11: "the woman in the red coat",
    16: "q: is it a person? a: no q: is it red? a: yes",
    13: "two dogs are playing in the snow",
    12: "both images contain two wolves",
    7: "a man riding a horse on the beach",
}
IMAGES = ("img_a", "img_b", "img_c", "img_d")


def _paths(task_id):
    spec = TASK_REGISTRY[task_id]
    # Retrieval with 3 candidates pads to the 4-row bucket.
    n = 3 if spec.decode == "ranking" else spec.min_images
    return list(IMAGES[:n])


JAX_CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2, 4), compute_dtype="float32",
        throughput_buckets=None,
        use_pallas_coattention=False, use_pallas_self_attention=False))


def _port_cfg(**engine):
    cfg = PortFramework.from_dict(dataclasses.asdict(JAX_CFG))
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, use_pallas_coattention=True,
        use_pallas_self_attention=True, **engine))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Feature files, noisy JAX weights, and one engine of each package."""
    d = tmp_path_factory.mktemp("torch_engine_features")
    rng = np.random.default_rng(0)
    dim = JAX_CFG.model.v_feature_size
    for i, name in enumerate(IMAGES):
        n = 10 if i == 0 else 5  # img_a clips to num_features=8
        x1 = rng.uniform(0, 300, n)
        y1 = rng.uniform(0, 200, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(10, 200, n),
                          y1 + rng.uniform(10, 150, n)], 1)
        save_reference_npy(str(d / f"{name}.npy"), RegionFeatures(
            features=rng.normal(size=(n, dim)).astype(np.float32),
            boxes=boxes.astype(np.float32), image_width=640,
            image_height=480), name)
    jeng = JaxEngine(JAX_CFG, seed=0, feature_store=JaxStore(str(d)))
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * noise.normal(size=x.shape).astype(np.float32),
        jax.device_get(jeng.params))
    jeng.load_params(params)
    pcfg = _port_cfg()
    sd = from_flax_params(params, pcfg.model)
    peng = PortEngine(pcfg, params=sd, feature_store=PortStore(str(d)),
                      device="cpu")
    return dict(dir=str(d), params=params, sd=sd, jax=jeng, port=peng)


@pytest.mark.parametrize("task_id", sorted(TASK_REGISTRY))
def test_every_task_decodes_like_jax(world, task_id):
    paths = _paths(task_id)
    want = world["jax"].predict(task_id, QUESTIONS[task_id], paths)
    got = world["port"].predict(task_id, QUESTIONS[task_id], paths)
    assert got.kind == TASK_REGISTRY[task_id].decode
    assert_same_result(got.to_json(), want.to_json(), F32)


@pytest.mark.parametrize("task_id", [1, 7, 12, 16])
def test_prepare_matches_jax(world, task_id):
    """Tokenization, region encode (with clipping) and bucketing are the
    JAX package's, value for value."""
    paths = _paths(task_id)
    j = world["jax"].prepare_from_store(task_id, QUESTIONS[task_id], paths)
    p = world["port"].prepare_from_store(task_id, QUESTIONS[task_id], paths)
    assert (p.bucket, p.n_images) == (j.bucket, j.n_images)
    assert dataclasses.asdict(p.spec) == dataclasses.asdict(j.spec)
    for f in ("input_ids", "input_mask", "segment_ids"):
        np.testing.assert_array_equal(getattr(p.text, f),
                                      getattr(j.text, f))
    np.testing.assert_array_equal(p.features.numpy(), j.features)
    for f in ("spatials", "image_mask", "task_ids"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
    assert [dataclasses.asdict(m) for m in p.images] == \
        [dataclasses.asdict(m) for m in j.images]


def test_guesswhat_reformat_reaches_the_tokens(world):
    q = "q: is it a person? a: no"
    p16 = world["port"].prepare_from_store(16, q, ["img_a"])
    p11 = world["port"].prepare_from_store(11, q, ["img_a"])
    j16 = world["jax"].prepare_from_store(16, q, ["img_a"])
    assert not np.array_equal(p16.text.input_ids, p11.text.input_ids)
    np.testing.assert_array_equal(p16.text.input_ids, j16.text.input_ids)


def test_retrieval_padding_invariance(world):
    """3 candidates pad to the 4-row bucket; real rows score as in an
    unpadded 2-candidate run."""
    eng = world["port"]
    res3 = eng.predict(7, QUESTIONS[7], list(IMAGES[:3]))
    res2 = eng.predict(7, QUESTIONS[7], list(IMAGES[:2]))
    s3 = {r["image"]: r["score"] for r in res3.ranking}
    for r in res2.ranking:
        assert s3[r["image"]] == pytest.approx(r["score"], abs=1e-5)


def test_nlvr2_needs_two_images(world):
    with pytest.raises(ValueError, match="task 12"):
        world["port"].predict(12, QUESTIONS[12], ["img_a"])


def test_attention_maps_match_jax(world):
    """run(collect_attention=True): the bridges take the dense path and
    surface the same per-bridge maps as the JAX engine."""
    req_j = world["jax"].prepare_from_store(1, QUESTIONS[1], ["img_b"])
    req_p = world["port"].prepare_from_store(1, QUESTIONS[1], ["img_b"])
    out_j, res_j = world["jax"].run(req_j, collect_attention=True)
    out_p, res_p = world["port"].run(req_p, collect_attention=True)
    assert len(out_p.attn_data_list) == JAX_CFG.model.num_connection_layers
    for (pt, pv), (jt, jv) in zip(out_p.attn_data_list, out_j.attn_data_list):
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), **F32)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **F32)
    assert_same_result(res_p.to_json(), res_j.to_json(), F32)


def test_per_head_engine_matches_fused(world):
    """fused_task_heads=False (the per-head module path) decodes every task
    like the fused default on the same weights."""
    per_head = PortEngine(_port_cfg(fused_task_heads=False),
                          params=world["sd"],
                          feature_store=PortStore(world["dir"]), device="cpu")
    assert per_head.head_slabs is None and world["port"].head_slabs
    for task_id in (1, 15, 12, 13, 7, 4):
        paths = _paths(task_id)
        assert_same_result(
            per_head.predict(task_id, QUESTIONS[task_id], paths).to_json(),
            world["port"].predict(task_id, QUESTIONS[task_id],
                                  paths).to_json(), F32)


def test_bf16_engine_tracks_jax_f32(world):
    """bf16 compute (weights cast once at load, LayerNorm kept f32) against
    the JAX f32 engine, head by head, for every task id."""
    eng = PortEngine(_port_cfg(compute_dtype="bfloat16"), params=world["sd"],
                     feature_store=PortStore(world["dir"]), device="cpu")
    assert eng.transfer_dtype == torch.bfloat16
    assert eng.model.bert.encoder.layer[0].output.dense.weight.dtype \
        == torch.bfloat16
    assert eng.model.bert.encoder.layer[0].output.LayerNorm.weight.dtype \
        == torch.float32
    for task_id, spec in sorted(TASK_REGISTRY.items()):
        paths = _paths(task_id)
        out_p, res_p = eng.run(eng.prepare_from_store(
            task_id, QUESTIONS[task_id], paths))
        out_j, res_j = world["jax"].run(world["jax"].prepare_from_store(
            task_id, QUESTIONS[task_id], paths))
        np.testing.assert_allclose(
            getattr(out_p, spec.head).float().numpy(),
            np.asarray(getattr(out_j, spec.head), np.float32),
            err_msg=f"task {task_id} head {spec.head}", **BF16)
        assert res_p.kind == res_j.kind == spec.decode


def test_cuda_engine_raises_without_a_card(monkeypatch):
    """Asking for the card where there is none raises; it never carries on
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        PortEngine(_port_cfg(), device="cuda")
