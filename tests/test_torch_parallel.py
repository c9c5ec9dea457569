"""The port's process mesh, partition rules and tp operators
(``vilbert_multitask_tpu_torch/parallel/``) against the JAX package's
(``vilbert_multitask_tpu/parallel/``).

- the mesh arithmetic and its errors are the JAX ``build_mesh``'s;
- every port key maps (``checkpoint/convert.py``) to a Flax path whose JAX
  spec shards the same axis, at the tiny width and at ``ViLBertConfig()``
  (shapes only), for tp 2, 4 and 8;
- the tp operators pass f64 gradchecks on 2 gloo ranks in their Megatron
  pairings, and the tp = 2 model (weights from ``from_flax_params`` of a
  JAX tree) gives the single-device model's outputs and gradients, and the
  JAX model's outputs, at the f32 parity tolerance (atol 2e-5 / rtol
  1e-5);
- the launcher tears a launch down when one rank fails.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import (
    jax_forward,
    model_inputs,
    seeded_params,
    to_port_config,
)
from vilbert_multitask_tpu.config import MeshConfig as JaxMeshConfig
from vilbert_multitask_tpu.config import ViLBertConfig
from vilbert_multitask_tpu.models.vilbert import ViLBertForVLTasks
from vilbert_multitask_tpu.parallel import build_mesh as jax_build_mesh
from vilbert_multitask_tpu.parallel import param_specs as jax_param_specs
from vilbert_multitask_tpu_torch import quant
from vilbert_multitask_tpu_torch.checkpoint.store import cast_params
from vilbert_multitask_tpu_torch.checkpoint.convert import (
    build_name_map,
    from_flax_params,
)
from vilbert_multitask_tpu_torch.config import MeshConfig
from vilbert_multitask_tpu_torch.parallel import distributed
from vilbert_multitask_tpu_torch.parallel.launch import launch, spawn_ranks
from vilbert_multitask_tpu_torch.parallel.mesh import mesh_shape
from vilbert_multitask_tpu_torch.parallel.sharding import (
    param_specs,
    shard_dim,
    shard_state_dict,
    shards_batch,
)

F32 = dict(atol=2e-5, rtol=1e-5)
REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- the mesh
@pytest.mark.parametrize("cfg,world,want", [
    (MeshConfig(), 8, ((8, 1), ("dp", "tp"))),
    (MeshConfig(tp=2), 8, ((4, 2), ("dp", "tp"))),
    (MeshConfig(dp=2, tp=2, sp=2), 8, ((2, 2, 2), ("dp", "tp", "sp"))),
    (MeshConfig(tp=2, sp=4), 8, ((1, 2, 4), ("dp", "tp", "sp"))),
    (MeshConfig(), 1, ((1, 1), ("dp", "tp"))),
])
def test_mesh_shape_follows_the_jax_rule(cfg, world, want):
    assert mesh_shape(cfg, world) == want


@pytest.mark.parametrize("cfg,world,jax_devices", [
    (MeshConfig(tp=3), 8, 8),  # 8 devices not divisible by tp*sp=3
    (MeshConfig(dp=4, tp=4), 8, 8),  # mesh 4x4x1 needs 16 devices
])
def test_mesh_errors_are_the_jax_errors(cfg, world, jax_devices):
    with pytest.raises(ValueError) as port:
        mesh_shape(cfg, world)
    with pytest.raises(ValueError) as ref:
        jax_build_mesh(JaxMeshConfig(dp=cfg.dp, tp=cfg.tp, sp=cfg.sp),
                       devices=jax.devices()[:jax_devices])
    assert str(port.value) == str(ref.value)


def test_a_mesh_smaller_than_the_world_is_refused():
    with pytest.raises(ValueError, match="every rank holds one"):
        mesh_shape(MeshConfig(dp=2, tp=2), 8)


def test_mesh_axes_on_eight_ranks():
    got = spawn_ranks(ranks.mesh_rank, 8)
    for rank, r in enumerate(got):
        assert r["info"]["axis_names"] == ["dp", "tp", "sp"]
        assert r["info"]["shape"] == {"dp": 2, "tp": 2, "sp": 2}
        assert r["info"]["n_devices"] == 8
        assert r["info"]["device_kinds"] == ["cpu"]
        dp, tp, sp = rank // 4, rank // 2 % 2, rank % 2
        assert r["axes"]["sp"] == (2, sp, (rank - sp, rank - sp + 1))
        assert r["axes"]["tp"][:2] == (2, tp)
        assert r["axes"]["dp"][:2] == (2, dp)
        assert r["default"]["shape"] == {"dp": 8, "tp": 1}


def test_initialize_without_a_rendezvous_is_a_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    info = distributed.runtime_info()
    assert set(info) >= {"process_index", "process_count",
                         "local_device_count", "global_device_count",
                         "backend"}
    assert (info["process_index"], info["process_count"]) == (0, 1)


# ------------------------------------------------------- partition rules
def _jax_shapes(cfg):
    model = ViLBertForVLTasks(cfg, dtype=jnp.float32)
    b, nt, nv = 2, 5, 3
    args = (jnp.zeros((b, nt), jnp.int32),
            jnp.zeros((b, nv, cfg.v_feature_size)), jnp.zeros((b, nv, 5)),
            jnp.zeros((b, nt), jnp.int32), jnp.ones((b, nt), jnp.int32),
            jnp.ones((b, nv), jnp.int32), None, jnp.zeros((b, 1), jnp.int32))
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *args, deterministic=True))["params"]


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_port_rules_shard_the_same_axis_as_jax(width):
    """Every port key, through the name map, against the JAX spec of its
    Flax path: the same axis sharded (torch Linear weights are the Flax
    kernels transposed; the fused qkv splits into query/key/value)."""
    cfg = ViLBertConfig().tiny() if width == "tiny" else ViLBertConfig()
    shapes = _jax_shapes(cfg)
    pcfg = to_port_config(cfg)
    for tp in (2, 4, 8):
        specs = jax_param_specs(shapes, jax_build_mesh(
            JaxMeshConfig(dp=8 // tp, tp=tp)))
        checked = 0
        for path, (keys, _pack, _unpack) in build_name_map(pcfg):
            spec, leaf = specs, shapes
            for k in path:
                spec, leaf = spec[k], leaf[k]
            sharded = [i for i, a in enumerate(tuple(spec)) if a == "tp"]
            flax_dim = sharded[0] if sharded else None
            matrix = len(leaf.shape) == 2 and path[-1] == "kernel"
            for key in keys:
                if path[-1] == "kernel" and "qkv" in path:
                    torch_shape = (leaf.shape[1] // 3, leaf.shape[0])
                elif matrix:
                    torch_shape = leaf.shape[::-1]
                else:
                    torch_shape = leaf.shape
                want = (None if flax_dim is None
                        else 1 - flax_dim if matrix else flax_dim)
                assert shard_dim(key, torch_shape, tp) == want, (tp, key)
                checked += 1
        assert checked > 200
        # the tied decoder follows the word table
        table = shapes["bert"]["embeddings"]["word_embeddings"]["embedding"]
        assert shard_dim("cls.predictions.decoder.weight", table.shape,
                         tp) == shard_dim(
            "bert.embeddings.word_embeddings.weight", table.shape, tp)


def test_full_vocabulary_shards_at_tp2_and_replicates_at_tp4():
    key, shape = "bert.embeddings.word_embeddings.weight", (30522, 768)
    assert shard_dim(key, shape, 2) == 0
    assert shard_dim(key, shape, 4) is None


def test_int8_pairs_shard_values_and_slice_scales_on_their_axis():
    """The JAX rule replicates every scale (its test_quant.py:115 case);
    the port slices a column shard's per-row scales with its rows and
    keeps a row shard's and a table's scales whole."""
    rng = np.random.default_rng(0)
    tree = quant.quantize_tree({
        "bert.encoder.layer.0.output.dense.weight":
            rng.normal(size=(32, 64)).astype(np.float32),
        "bert.encoder.layer.0.intermediate.dense.weight":
            rng.normal(size=(64, 32)).astype(np.float32),
        "bert.embeddings.word_embeddings.weight":
            rng.normal(size=(16, 8)).astype(np.float32),
    })

    class Mesh:  # the DeviceMesh surface of parallel.mesh.axis: rank 1
        mesh_dim_names = ("dp", "tp")  # of a 1 x 2 mesh, with no groups
        mesh = torch.arange(2).reshape(1, 2)

        def get_coordinate(self):
            return [0, 1]

        def get_group(self, name):
            return None

    mesh = Mesh()
    specs = param_specs(tree, mesh)
    row = specs["bert.encoder.layer.0.output.dense.weight"]
    col = specs["bert.encoder.layer.0.intermediate.dense.weight"]
    emb = specs["bert.embeddings.word_embeddings.weight"]
    assert row == {"int8": (None, "tp"), "scale": ()}
    assert col == {"int8": ("tp", None), "scale": ("tp",)}
    assert emb == {"int8": ("tp", None), "scale": ()}
    local = shard_state_dict(tree, mesh)
    c = local["bert.encoder.layer.0.intermediate.dense.weight"]
    full = tree["bert.encoder.layer.0.intermediate.dense.weight"]
    np.testing.assert_array_equal(c["int8"], full["int8"][32:])
    np.testing.assert_array_equal(c["scale"], full["scale"][32:])
    r = local["bert.encoder.layer.0.output.dense.weight"]
    full = tree["bert.encoder.layer.0.output.dense.weight"]
    np.testing.assert_array_equal(r["int8"], full["int8"][:, 32:])
    np.testing.assert_array_equal(r["scale"], full["scale"])
    # already sharded: passes through
    assert shard_state_dict(local, mesh) is local


def test_cast_floating_is_the_serving_cast():
    tree = {"w": torch.ones(4, 4), "n": torch.arange(3)}
    assert cast_params(tree, None) == tree
    assert cast_params(tree, "bfloat16")["w"].dtype == torch.bfloat16
    assert cast_params(tree, "bfloat16")["n"].dtype == torch.int64
    q = cast_params(tree, "int8")
    assert quant.is_quantized_leaf(q["w"])
    again = cast_params(q, "int8")  # the double-cast seam
    assert torch.equal(torch.as_tensor(again["w"]["int8"]),
                       torch.as_tensor(q["w"]["int8"]))
    with pytest.raises(ValueError):
        cast_params(tree, "int32")


@pytest.mark.parametrize("rows,dp,want", [
    (8, 4, True), (8, 2, True), (4, 4, False), (2, 2, False), (3, 3, True),
    (5, 2, False), (8, 1, False)])
def test_batch_rows_shard_without_splitting_a_pair(rows, dp, want):
    assert shards_batch(rows, dp) is want


# ------------------------------------------------- tp operators and model
@pytest.fixture(scope="module")
def tp2():
    cfg = ViLBertConfig().tiny()
    params = seeded_params(cfg, seed=2)
    inp = model_inputs(cfg, batch=4, seed=3)
    sd = {k: np.asarray(v) for k, v in
          from_flax_params(params, to_port_config(cfg)).items()}
    want = jax_forward(cfg, params, inp)
    got = spawn_ranks(ranks.ops_rank, 2, args=(sd, inp))
    return dict(got=got, want=want, cfg=cfg)


def test_collectives_on_two_ranks(tp2):
    for rank, r in enumerate(tp2["got"]):
        assert r["all_reduce"] == [3.0] * 3
        assert r["all_gather"] == [0.0, 0.0, 1.0, 1.0]
        assert r["broadcast"] == [6.0, 6.0]
        assert r["shift"] == [float(1 - rank)]
        assert r["runtime_info"]["process_count"] == 2
        assert r["runtime_info"]["dist_backend"] == "gloo"


@pytest.mark.parametrize("pairing", ["copy_to_tp+reduce_from_tp",
                                     "copy_to_tp+gather_from_tp",
                                     "scatter_to_tp+reduce_from_tp"])
def test_tp_operators_pass_gradcheck(tp2, pairing):
    assert all(r["gradcheck"][pairing] for r in tp2["got"])


def test_reduce_backward_is_not_multiplied_by_tp(tp2):
    assert all(r["mlp_grad_gap"] < 1e-12 for r in tp2["got"])


@pytest.mark.parametrize("rank", [0, 1])
def test_tp2_model_matches_single_device_and_jax(tp2, rank):
    r = tp2["got"][rank]
    for f, want in r["single"].items():
        np.testing.assert_allclose(r["tp"][f], want, err_msg=f, **F32)
        np.testing.assert_allclose(r["tp"][f], tp2["want"][f], err_msg=f,
                                   **F32)


def test_tp2_gradients_match_single_device(tp2):
    """Every parameter's gradient (the tp shards gathered) is the
    single-device one under a cross-entropy of every head: the
    vocabulary-parallel table and the tied MLM decoder, the column/row
    pairs and the replicated leaves alike. In f32 the sums run in other
    orders, so each leaf is held to rtol 1e-4 and an atol of 1e-6 of the
    largest gradient of the model (the key biases' gradients are zero but
    for that rounding)."""
    r = tp2["got"][0]
    assert len(r["grad_tp"]) > 100
    scale = max(float(np.abs(g).max()) for g in r["grad_single"].values())
    for k, got in r["grad_tp"].items():
        want = r["grad_single"].get(k, np.zeros_like(got))
        np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=1e-4,
                                   err_msg=k)


def test_tp2_model_holds_half_of_each_sharded_leaf(tp2):
    cfg = tp2["cfg"]
    shapes = tp2["got"][0]["local_shapes"]
    h, i = cfg.hidden_size, cfg.intermediate_size
    assert shapes["bert.encoder.layer.0.attention.self.query.weight"] == (
        h // 2, h)
    assert shapes["bert.encoder.layer.0.output.dense.weight"] == (h, i // 2)
    assert shapes["bert.embeddings.word_embeddings.weight"] == (
        cfg.vocab_size // 2, h)
    assert shapes["bert.encoder.c_layer.0.v_output.dense.weight"] == (
        cfg.v_hidden_size, cfg.v_intermediate_size)  # bridge FFNs: whole
    assert shapes["cls.predictions.bias"] == (cfg.vocab_size,)


def test_shard_gather_round_trip_and_batch_placement(tp2):
    for r in tp2["got"]:
        assert r["round_trip"]
        assert "global_batch=True" in r["per_rank_batch"]
    assert tp2["got"][0]["global_batch"] == [[0, 1], [2, 3], [4, 5], [6, 7]]


# --------------------------------------------------------------- launcher
def test_launch_tears_down_when_a_rank_fails():
    """Rank 1 exits 3 at once while rank 0 would sleep a minute: the
    launch ends with 3 within seconds and leaves nothing running."""
    code = ("import os, sys, time\n"
            "time.sleep(60) if os.environ['RANK'] == '0' else sys.exit(3)")
    t0 = time.monotonic()
    assert launch(2, "gloo", [sys.executable, "-c", code], grace_s=2) == 3
    assert time.monotonic() - t0 < 30


def test_launch_cli_passes_the_rank_variables(tmp_path):
    (tmp_path / "rank_env.py").write_text(
        "import os\n"
        "open(os.path.join({!r}, os.environ['RANK']), 'w').write(' '.join("
        "os.environ[v] for v in ('WORLD_SIZE', 'LOCAL_RANK', "
        "'VMT_DIST_BACKEND', 'MASTER_ADDR')))\n".format(str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "vilbert_multitask_tpu_torch.parallel.launch",
         "--nproc", "2", "--backend", "gloo", "--", "rank_env"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "0").read_text() == "2 0 gloo 127.0.0.1"
    assert (tmp_path / "1").read_text() == "2 1 gloo 127.0.0.1"


def test_spawn_reports_the_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn_ranks(ranks.fail_on_rank_1, 2, timeout_s=60)


def test_dataclass_mesh_config_matches_jax_fields():
    port = {f.name: f.default for f in dataclasses.fields(MeshConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxMeshConfig)}
    assert port == ref
