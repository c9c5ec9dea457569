"""Ring attention in the port (``vilbert_multitask_tpu_torch/parallel/
ring.py``) against dense attention and the JAX package's ring.

The JAX tests' cases (tests/test_ring_attention.py, tests/test_ring_model.py)
run on 8 gloo ranks: the primitive against dense softmax attention at atol
2e-5 for sp in {2, 4, 8}, with a key mask, at region scale, composed with
dp, and its two rejections; the model with ``ring_v`` against the dense
model at atol 3e-5 / rtol 1e-4 under dp × sp and tp × sp, staying dense
below the threshold or when the region count does not divide sp. Each is
also held against the JAX ring on the 8-device virtual mesh, on the same
inputs and, for the model, on weights from ``from_flax_params`` of the JAX
tree. The rotation's backward passes an f64 gradcheck.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import to_port_config
from vilbert_multitask_tpu.config import MeshConfig, ViLBertConfig
from vilbert_multitask_tpu.models.vilbert import ViLBertForVLTasks
from vilbert_multitask_tpu.ops.attention import (
    mask_to_bias,
    multi_head_attention,
)
from vilbert_multitask_tpu.parallel import build_mesh
from vilbert_multitask_tpu.parallel.ring import (
    RingContext,
    make_ring_attention,
)
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.parallel.launch import spawn_ranks

RING = dict(atol=2e-5)
MODEL = dict(atol=3e-5, rtol=1e-4)
N_REGIONS, BATCH = 16, 4
HEADS = ("vil_prediction", "vil_logit", "vision_logit",
         "vil_binary_prediction", "linguisic_logit")


def _qkv(b=2, nq=16, nk=16, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return mk(b, nq, h, d), mk(b, nk, h, d), mk(b, nk, h, d)


def _mask(b, n, seed):
    mask = (np.random.default_rng(seed).random((b, n)) > 0.4).astype(
        np.int32)
    mask[:, 0] = 1
    return mask


# name → (dp, sp, batch_axis, q/k/v, mask)
CASES = {
    "sp2": (4, 2, False, _qkv(), None),
    "sp4": (2, 4, False, _qkv(), None),
    "sp8": (1, 8, False, _qkv(), None),
    "kv_mask": (2, 4, False, _qkv(nq=8, nk=32, seed=3), _mask(2, 32, 4)),
    "region_scale": (1, 8, False, _qkv(b=1, nq=64, nk=512, h=2, d=16,
                                       seed=7), None),
    "dp_x_sp": (2, 4, True, _qkv(b=4, nq=16, nk=64, seed=9),
                _mask(4, 64, 10)),
    "indivisible_seq": (1, 8, False, _qkv(nq=12, nk=12), None),
    "indivisible_batch": (2, 4, True, _qkv(b=3, nq=16, nk=16), None),
}


def _jax_ring(dp, sp, batch_axis, qkv, mask):
    devices = np.asarray(jax.devices()[:dp * sp])
    if batch_axis:
        mesh = Mesh(devices.reshape(dp, sp), ("dp", "sp"))
    else:
        mesh = Mesh(devices[:sp].reshape(sp), ("sp",))
    ring = make_ring_attention(mesh, batch_axis="dp" if batch_axis else None)
    q, k, v = (jnp.asarray(a) for a in qkv)
    return np.asarray(ring(q, k, v, None if mask is None
                           else jnp.asarray(mask)))


def _jax_dense(qkv, mask):
    q, k, v = (jnp.asarray(a) for a in qkv)
    bias = None if mask is None else mask_to_bias(jnp.asarray(mask))
    return np.asarray(multi_head_attention(q, k, v, bias,
                                           dtype=jnp.float32)[0])


def _model_inputs(cfg, n_regions=N_REGIONS, batch=BATCH, n_text=9, seed=3):
    """tests/test_ring_model.py's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return dict(
        input_ids=rng.integers(0, cfg.vocab_size, (batch, n_text)).astype(
            np.int32),
        features=rng.normal(size=(batch, n_regions, cfg.v_feature_size)
                            ).astype(np.float32),
        spatials=rng.random((batch, n_regions, 5)).astype(np.float32),
        segment_ids=np.zeros((batch, n_text), np.int32),
        input_mask=np.ones((batch, n_text), np.int32),
        image_mask=(rng.integers(0, 2, (batch, n_regions))
                    | np.eye(1, n_regions, dtype=np.int64)[0]).astype(
                        np.int32),
        task_ids=rng.integers(0, cfg.num_task_tokens, (batch, 1)).astype(
            np.int32),
    )


def _jax_apply(model, params, inp):
    out = jax.jit(lambda p, i: model.apply(
        {"params": p}, i["input_ids"], i["features"], i["spatials"],
        i["segment_ids"], i["input_mask"], i["image_mask"], None,
        i["task_ids"], deterministic=True))(params, inp)
    return {h: np.asarray(getattr(out, h)) for h in HEADS}


@pytest.fixture(scope="module")
def world():
    cases, want = {}, {}
    for name, (dp, sp, batch_axis, qkv, mask) in CASES.items():
        cases[name] = dict(dp=dp, sp=sp, batch_axis=batch_axis,
                           q=qkv[0], k=qkv[1], v=qkv[2], mask=mask)
        if not name.startswith("indivisible"):
            want[name] = (_jax_ring(dp, sp, batch_axis, qkv, mask),
                          _jax_dense(qkv, mask))

    cfg = dataclasses.replace(ViLBertConfig().tiny(),
                              use_pallas_self_attention=False,
                              use_pallas_coattention=False)
    inputs = {"16": _model_inputs(cfg), "15": _model_inputs(cfg,
                                                          n_regions=15)}
    # the first pair of rows: their outputs are rows 0-1 of the batch of 4
    inputs["16b2"] = {k: v[:2] for k, v in inputs["16"].items()}
    dense = ViLBertForVLTasks(cfg, dtype=jnp.float32)
    j16 = {k: jnp.asarray(v) for k, v in inputs["16"].items()}
    params = jax.device_get(jax.jit(lambda key, i: dense.init(
        key, i["input_ids"], i["features"], i["spatials"], i["segment_ids"],
        i["input_mask"], i["image_mask"], None, i["task_ids"],
        deterministic=True)["params"])(jax.random.PRNGKey(0), j16))
    jax_out = {key: _jax_apply(dense, params, {k: jnp.asarray(v) for k, v in
                                                inputs[key].items()})
               for key in ("16", "15")}
    jax_out["16b2"] = _rows(jax_out["16"], (0, 2))
    ring = ViLBertForVLTasks(cfg, dtype=jnp.float32, ring_v=RingContext(
        build_mesh(MeshConfig(dp=2, tp=1, sp=4)), sp_axis="sp",
        batch_axis="dp", min_seq=N_REGIONS))
    jax_out["ring_dp2_sp4"] = _jax_apply(ring, params, j16)
    pcfg = to_port_config(cfg)
    sd = {k: np.asarray(v) for k, v in from_flax_params(params, pcfg).items()}
    model_case = dict(cfg=pcfg, sd=sd, inputs=inputs, runs={
        "dp2_sp4": (2, 1, 4, N_REGIONS, "16"),
        "tp2_sp4": (1, 2, 4, N_REGIONS, "16b2"),
        "below_threshold": (2, 1, 4, N_REGIONS * 4, "16"),
        "indivisible_regions": (2, 1, 4, 8, "15"),
    })
    got = spawn_ranks(ranks.ring_rank, 8, args=(cases, model_case),
                      timeout_s=300)
    return dict(got=got, want=want, jax=jax_out)


@pytest.mark.parametrize("name", ["sp2", "sp4", "sp8", "kv_mask",
                                  "region_scale", "dp_x_sp"])
def test_ring_matches_dense_and_the_jax_ring(world, name):
    jax_ring, dense = world["want"][name]
    for r in world["got"]:  # every rank holds the global result
        got = r["ring"][name]
        assert got.shape == dense.shape
        np.testing.assert_allclose(got, dense, **RING)
        np.testing.assert_allclose(got, jax_ring, **RING)


@pytest.mark.parametrize("name", ["indivisible_seq", "indivisible_batch"])
def test_ring_rejects_shapes_that_do_not_divide(world, name):
    for r in world["got"]:
        assert r["ring"][name].startswith("ValueError: length")


def test_ring_rotation_passes_gradcheck(world):
    assert all(r["gradcheck"] for r in world["got"])


def test_ring_self_attention_gradients_are_dense_ones(world):
    """In f64: the model's entry sums each rank's block gradients over
    sp, so every rank holds the dense attention's q/k/v gradients."""
    assert all(r["self_attention_grad_gap"] < 1e-12 for r in world["got"])


def _rows(want: dict, rows) -> dict:
    out = {}
    for h, v in want.items():
        a, b = rows
        out[h] = v[a // 2:b // 2] if h == "vil_binary_prediction" else v[a:b]
    return out


@pytest.mark.parametrize("rank", [0, 3, 7])
def test_port_model_runs_sequence_parallel_like_dense(world, rank):
    r = world["got"][rank]["dp2_sp4"]
    assert r["engages"] and r["calls"] == 2  # the tiny model's 2 v-layers
    for source in (world["jax"]["16"], world["jax"]["ring_dp2_sp4"]):
        want = _rows(source, r["rows"])
        for h in HEADS:
            np.testing.assert_allclose(r["out"][h], want[h], err_msg=h,
                                       **MODEL)


def test_dense_port_model_matches_jax(world):
    for h in HEADS:
        np.testing.assert_allclose(world["got"][0]["dense"][h],
                                   world["jax"]["16"][h], err_msg=h, **MODEL)


@pytest.mark.parametrize("rank", [0, 1, 6])
def test_model_ring_composes_with_tensor_parallel(world, rank):
    """tp × sp: each tp rank runs its ring on its own heads."""
    r = world["got"][rank]["tp2_sp4"]
    assert r["calls"] == 2
    for h in HEADS:
        np.testing.assert_allclose(r["out"][h], world["jax"]["16b2"][h],
                                   err_msg=h, **MODEL)


@pytest.mark.parametrize("run", ["below_threshold", "indivisible_regions"])
def test_threshold_and_divisibility_keep_dense(world, run):
    for r in world["got"]:
        assert not r[run]["engages"] and r[run]["calls"] == 0
    want = _rows(world["jax"]["15" if run.startswith("indiv") else "16"],
                 world["got"][0][run]["rows"])
    for h in HEADS:
        np.testing.assert_allclose(world["got"][0][run]["out"][h], want[h],
                                   err_msg=h, **MODEL)
