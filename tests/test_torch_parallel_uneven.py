"""The port's tensor parallelism where tp does not divide an attention's
heads, against the JAX engine on its 8-device virtual mesh.

The JAX rules shard a leaf whenever its dimension divides the tp axis and
XLA re-lays head-misaligned shards out; the port keeps such an attention
whole on every rank, with the products that read its context
(``parallel.tp.parallelize``), and slices state dicts by the model's own
layout (``parallel.tp.layout``). Checked here:

- which modules stay whole, at the tiny width (tp = 4: 2 visual and 2
  bridge heads) and at ``ViLBertConfig()`` (tp = 3: 8 visual and bridge
  heads; tp = 8: 12 text heads), on the meta device;
- ``restore_params(..., cfg=, mesh=)`` hands the whole layers whole
  tensors and slices the rest;
- eight gloo ranks serve the tiny config at dp 2 × tp 4 in f32, in int8
  and from a mesh restore, each within atol 1e-4 of the JAX engine at
  ``MeshConfig(dp=2, tp=4)`` and of the port's single-device engine, with
  the same answers; at tp 4 × sp 2 the ring runs inside the whole visual
  attentions and matches the dense engine.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel_engine import _jax_cfg, _port_cfg, _serve
from vilbert_multitask_tpu.config import MeshConfig
from vilbert_multitask_tpu.engine.runtime import InferenceEngine as JaxEngine
from vilbert_multitask_tpu.parallel import build_mesh
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.checkpoint.store import (
    restore_params,
    save_params,
)
from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.engine.runtime import (
    InferenceEngine as PortEngine,
)
from vilbert_multitask_tpu_torch.models.vilbert import ViLBertForVLTasks
from vilbert_multitask_tpu_torch.parallel.launch import spawn_ranks
from vilbert_multitask_tpu_torch.parallel.sharding import param_specs
from vilbert_multitask_tpu_torch.parallel.tp import (
    layout,
    layout_for,
    parallelize,
)

ATOL = 1e-4
MESH = MeshConfig(dp=2, tp=4)


class _Mesh:
    """The DeviceMesh surface ``parallel.mesh.axis`` reads: rank ``index``
    of a 1 x ``tp`` mesh, with no groups (nothing here communicates)."""

    mesh_dim_names = ("dp", "tp")

    def __init__(self, tp: int, index: int = 1):
        self.mesh = torch.arange(tp).reshape(1, tp)
        self._index = index

    def get_coordinate(self):
        return [0, self._index]

    def get_group(self, name):
        return None


def _attentions(model) -> dict:
    """Each attention's module name → its heads on this rank."""
    from vilbert_multitask_tpu_torch.models.layers import BiAttention
    from vilbert_multitask_tpu_torch.ops.attention import FusedSelfAttention

    return {n: m.num_heads for n, m in model.named_modules()
            if isinstance(m, (FusedSelfAttention, BiAttention))}


@pytest.mark.parametrize("width,tp,whole,split", [
    ("tiny", 4, ("v_layer", "c_layer"), ("layer",)),
    ("full", 3, ("v_layer", "c_layer"), ("layer",)),
    ("full", 8, ("layer",), ("v_layer", "c_layer")),
])
def test_attentions_whose_heads_tp_does_not_divide_stay_whole(
        width, tp, whole, split):
    cfg = ViLBertConfig().tiny() if width == "tiny" else ViLBertConfig()
    heads = {"layer": cfg.num_attention_heads,
             "v_layer": cfg.v_num_attention_heads,
             "c_layer": cfg.bi_num_attention_heads}
    mesh = _Mesh(tp)
    with torch.device("meta"):
        model = parallelize(ViLBertForVLTasks(cfg), mesh)
    dims = layout(model)
    for name, n in _attentions(model).items():
        stream = name.split(".")[2]
        assert n == (heads[stream] if stream in whole
                     else heads[stream] // tp), name
    for stream in whole:
        pre = f"bert.encoder.{stream}.0."
        own = ([pre + f"attention.self.{p}.weight"
                for p in ("query", "key", "value")]
               + [pre + "attention.output.dense.weight"]
               if stream != "c_layer" else
               [pre + f"biattention.{p}{i}.weight"
                for p in ("query", "key", "value") for i in (1, 2)]
               + [pre + f"biOutput.dense{i}.weight" for i in (1, 2)])
        assert not any(k in dims for k in own), stream
    for stream in split:
        pre = f"bert.encoder.{stream}.0."
        if stream == "c_layer":
            assert dims[pre + "biattention.query1.weight"] == 0
            assert dims[pre + "biOutput.dense2.weight"] == 1
        else:
            assert dims[pre + "attention.self.query.weight"] == 0
            assert dims[pre + "attention.self.query.bias"] == 0
            assert dims[pre + "attention.output.dense.weight"] == 1
    # The feed-forwards shard as before, whole attention or not (the text
    # FFN's 64 and 3072 divide by 3, 4 and 8).
    assert dims["bert.encoder.layer.0.intermediate.dense.weight"] == 0
    assert dims["bert.encoder.layer.0.output.dense.weight"] == 1
    # The specs of a state dict follow the model's layout.
    sd = {k: torch.empty(v.shape, device="meta")
          for k, v in ViLBertForVLTasks(cfg).state_dict().items()} \
        if width == "tiny" else None
    if sd is not None:
        specs = param_specs(sd, mesh, dims)
        assert specs["bert.encoder.v_layer.0.attention.self.query.weight"] \
            == ()
        assert specs["bert.encoder.layer.0.attention.self.query.weight"] \
            == ("tp", None)


def test_mesh_restore_hands_whole_layers_whole(tmp_path):
    """``restore_params(..., mesh=)`` slices by the config's layout: rank
    1 of tp 4 holds the whole visual and bridge attentions and a quarter
    of the text ones (f32 and int8 pairs, values and scales)."""
    cfg = ViLBertConfig().tiny()
    with torch.device("meta"):
        full = {k: tuple(v.shape)
                for k, v in ViLBertForVLTasks(cfg).state_dict().items()}
    from vilbert_multitask_tpu_torch.engine.runtime import init_state_dict

    weights = init_state_dict(cfg, seed=1)
    save_params(str(tmp_path / "ckpt"), weights)
    mesh = _Mesh(4)
    for dtype in (None, "int8"):
        got = restore_params(str(tmp_path / "ckpt"), dtype=dtype, cfg=cfg,
                             mesh=mesh)
        dims = layout_for(cfg, mesh)
        for key, value in got.items():
            pair = isinstance(value, dict)
            shape = tuple((value["int8"] if pair else value).shape)
            want = list(full[key])
            if key in dims:
                want[dims[key]] //= 4
            assert shape == tuple(want), (dtype, key)
        v = got["bert.encoder.v_layer.0.attention.self.query.weight"]
        w = weights["bert.encoder.v_layer.0.attention.self.query.weight"]
        if dtype is None:
            np.testing.assert_array_equal(v.numpy(), w.numpy())
        else:
            assert tuple(v["scale"].shape) == (w.shape[0],)
        t = got["bert.encoder.layer.0.attention.self.query.weight"]
        t = t["int8"] if dtype else t
        assert t.shape[0] == cfg.hidden_size // 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg = dataclasses.replace(_jax_cfg(), mesh=MESH)
    jax_single = JaxEngine(jcfg, seed=3)
    jax_mesh = JaxEngine(jcfg, seed=3, mesh=build_mesh(MESH))
    pcfg = _port_cfg(jcfg)
    sd = {k: np.asarray(v) for k, v in from_flax_params(
        jax.device_get(jax_single.params), pcfg.model).items()}
    int8_cfg = _port_cfg(jcfg, param_dtype="int8")
    ring_cfg = _port_cfg(_jax_cfg(max_regions=16), ring_min_regions=8)
    ckpt = str(tmp_path_factory.mktemp("uneven_ckpt") / "ckpt")
    save_params(ckpt, sd)
    single = PortEngine(pcfg, params=sd, device="cpu")
    regs = ranks.regions(2, feat_dim=pcfg.model.v_feature_size)
    maps, _ = single.run(single.prepare(12, "both images contain wolves",
                                        regs), collect_attention=True)
    want = {
        "jax_mesh": _serve(jax_mesh), "jax": _serve(jax_single),
        "f32": _serve(single), "maps": ranks.attention_maps(maps),
        "int8": _serve(PortEngine(int8_cfg, params=sd, device="cpu")),
        "ring": _serve(PortEngine(ring_cfg, params=sd, device="cpu")),
    }
    got = spawn_ranks(ranks.uneven_heads_rank, 8, args=(
        pcfg, sd, int8_cfg, {"cfg": ring_cfg, "seed": 5}, ckpt),
        timeout_s=300)
    return dict(got=got[0], ring_calls=[g["ring_calls"] for g in got],
                want=want, cfg=pcfg)


def _same(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["binary"], want["binary"], atol=ATOL)
    np.testing.assert_allclose(got["vision_logit"], want["vision_logit"],
                               atol=ATOL)
    assert got["answers"] == want["answers"]
    assert got["many"] == want["many"]


@pytest.mark.parametrize("ref", ["jax_mesh", "jax", "f32"])
def test_dp2_tp4_engine_matches_jax_mesh_and_single_device(world, ref):
    _same(world["got"]["f32"], world["want"][ref])


def test_dp2_tp4_engine_keeps_the_visual_and_bridge_attentions_whole(world):
    cfg = world["cfg"].model
    shapes = world["got"]["f32"]["state_shapes"]
    hv, bi, h = cfg.v_hidden_size, cfg.bi_hidden_size, cfg.hidden_size
    assert shapes["bert.encoder.v_layer.0.attention.self.query.weight"] == (
        hv, hv)
    assert shapes["bert.encoder.c_layer.0.biattention.key2.weight"] == (
        bi, h)
    assert shapes["bert.encoder.c_layer.0.biOutput.dense1.weight"] == (
        hv, bi)
    assert shapes["bert.encoder.layer.0.attention.self.query.weight"] == (
        h // 4, h)
    assert shapes["bert.encoder.v_layer.0.intermediate.dense.weight"] == (
        cfg.v_intermediate_size // 4, hv)


def test_whole_bridges_attention_maps_are_not_gathered_again(world):
    """``collect_attention`` on the mesh: a whole bridge's maps hold every
    head already (gathering them over tp would repeat them)."""
    got, want = world["got"]["f32"]["maps"], world["want"]["maps"]
    assert len(got) == len(want) == world["cfg"].model.num_connection_layers
    for g_maps, w_maps in zip(got, want):
        for g, w in zip(g_maps, w_maps):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize("ref", ["int8", "jax_mesh"])
def test_dp2_tp4_int8_engine_matches(world, ref):
    got = world["got"]["int8"]
    if ref == "int8":
        _same(got, world["want"]["int8"])
    else:  # int8 against the f32 JAX engine: the JAX int8 decode gate
        np.testing.assert_allclose(got["binary"],
                                   world["want"][ref]["binary"],
                                   rtol=0.15, atol=0.15)
    shapes = got["state_shapes"]
    assert shapes["bert.encoder.v_layer.0.attention.self.query.weight"] == (
        world["cfg"].model.v_hidden_size, world["cfg"].model.v_hidden_size)


def test_dp2_tp4_mesh_restore_serves_the_same(world):
    got = world["got"]
    np.testing.assert_array_equal(got["restored"]["binary"],
                                  got["f32"]["binary"])
    assert got["restored"]["many"] == got["f32"]["many"]
    assert got["restored_shapes"] == got["restored"]["state_shapes"]


def test_ring_inside_a_whole_visual_attention(world):
    # 2 visual layers per forward on every rank: run() and 2 chunks
    assert all(c >= 2 * 3 for c in world["ring_calls"])
    _same(world["got"]["ring"], world["want"]["ring"])
