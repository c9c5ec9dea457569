"""The port's engine and server on a process mesh against the JAX engine on
its 8-device virtual mesh (tests/test_engine.py:220-295,
tests/test_serve.py:645).

Eight gloo ranks build ``InferenceEngine(..., mesh=)`` at dp 4 × tp 2 on
the JAX engine's converted weights; rank 0 serves, the others follow.
Its NLVR2 pair is held at atol 1e-4 against the JAX mesh engine and the
port's single-device engine, with the same answers, and ``run_many`` over
the JAX test's 5-request backlog decodes as both do. The int8 engine and
an engine restored from a checkpoint with ``restore_params(..., mesh=)``
serve the same way, and at dp 2 × tp 2 × sp 2 over a 16-region bucket the
visual self-attentions take the ring. A 2-rank engine idle for longer
than its process groups' timeout answers again. ``ServeApp`` built by
rank 0 of a 2-rank world serves a job through the dp mesh.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from tests import torch_parallel_ranks as ranks
from tests.test_engine import make_regions
from tests.torch_port_helpers import write_feature_files
from vilbert_multitask_tpu.config import (
    EngineConfig,
    FrameworkConfig,
    MeshConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu.engine.runtime import InferenceEngine as JaxEngine
from vilbert_multitask_tpu.parallel import build_mesh
from vilbert_multitask_tpu_torch import config as port_config
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.checkpoint.store import save_params
from vilbert_multitask_tpu_torch.engine.runtime import (
    InferenceEngine as PortEngine,
)
from vilbert_multitask_tpu_torch.parallel.launch import spawn_ranks

ATOL = 1e-4
# The idle test's process-group timeout and the idle time past it.
GROUP_TIMEOUT_S, IDLE_S = 8.0, 11.0


def _jax_cfg(**engine):
    kw = dict(compute_dtype="float32", use_pallas_coattention=False,
              use_pallas_self_attention=False, max_regions=11,
              image_buckets=(1, 2, 4), throughput_buckets=(8,))
    kw.update(engine)
    return FrameworkConfig(model=ViLBertConfig().tiny(),
                           engine=EngineConfig(**kw),
                           mesh=MeshConfig(dp=4, tp=2))


def _port_cfg(jax_cfg, **engine):
    pcfg = port_config.FrameworkConfig.from_dict(dataclasses.asdict(jax_cfg))
    return dataclasses.replace(pcfg, engine=dataclasses.replace(
        pcfg.engine, use_pallas_coattention=True,
        use_pallas_self_attention=True, **engine))


def _serve(eng):
    """The requests serve_engine sends, on a single-device engine."""
    regs = make_regions(4, feat_dim=32, seed=5)
    out, res = eng.run(eng.prepare(12, "both images contain wolves",
                                   regs[:2]))
    many = eng.run_many([eng.prepare(t, q, regs[:n])
                         for t, q, n in ranks.BACKLOG])
    return {"binary": np.asarray(out.vil_binary_prediction),
            "vision_logit": np.asarray(out.vision_logit),
            "answers": ranks.result_key(res),
            "many": [(r.kind, ranks.result_key(r)) for r in many]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jcfg = _jax_cfg()
    jax_single = JaxEngine(jcfg, seed=3)
    jax_mesh = JaxEngine(jcfg, seed=3, mesh=build_mesh(jcfg.mesh))
    sd = {k: np.asarray(v) for k, v in from_flax_params(
        jax.device_get(jax_single.params), _port_cfg(jcfg).model).items()}
    pcfg = _port_cfg(jcfg)
    int8_cfg = _port_cfg(jcfg, param_dtype="int8")
    ring_cfg = _port_cfg(_jax_cfg(max_regions=16), ring_min_regions=8)
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt") / "ckpt")
    save_params(ckpt, sd)
    want = {
        "jax_mesh": _serve(jax_mesh), "jax": _serve(jax_single),
        "f32": _serve(PortEngine(pcfg, params=sd, device="cpu")),
        "int8": _serve(PortEngine(int8_cfg, params=sd, device="cpu")),
        "ring": _serve(PortEngine(ring_cfg, params=sd, device="cpu")),
    }
    got = spawn_ranks(ranks.engine_rank, 8, args=(
        pcfg, sd, int8_cfg, {"cfg": ring_cfg, "seed": 5}, ckpt),
        timeout_s=300)
    return dict(got=got[0], ring_calls=[g["ring_calls"] for g in got],
                want=want, cfg=pcfg, sd=sd)


@pytest.mark.parametrize("ref", ["jax_mesh", "jax", "f32"])
def test_mesh_engine_matches_jax_mesh_and_single_device(world, ref):
    got, want = world["got"]["f32"], world["want"][ref]
    np.testing.assert_allclose(got["binary"], want["binary"], atol=ATOL)
    np.testing.assert_allclose(got["vision_logit"], want["vision_logit"],
                               atol=ATOL)
    assert got["answers"] == want["answers"]


@pytest.mark.parametrize("ref", ["jax_mesh", "f32"])
def test_mesh_run_many_matches_the_backlog(world, ref):
    assert world["got"]["f32"]["many"] == world["want"][ref]["many"]


def test_mesh_engine_holds_tp_shards(world):
    cfg = world["cfg"].model
    shapes = world["got"]["f32"]["state_shapes"]
    h, i = cfg.hidden_size, cfg.intermediate_size
    assert shapes["bert.encoder.layer.0.attention.self.query.weight"] == (
        h // 2, h)
    assert shapes["bert.encoder.layer.0.output.dense.weight"] == (h, i // 2)
    assert shapes["bert.encoder.layer.0.output.LayerNorm.weight"] == (h,)


@pytest.mark.parametrize("what", ["binary", "vision_logit", "answers",
                                  "many"])
def test_int8_mesh_engine_matches_single_device_int8(world, what):
    got, want = world["got"]["int8"], world["want"]["int8"]
    if what in ("answers", "many"):
        assert got[what] == want[what]
    else:
        np.testing.assert_allclose(got[what], want[what], atol=ATOL)
    shapes = got["state_shapes"]
    assert shapes["bert.encoder.layer.0.intermediate.dense.weight"][0] == (
        world["cfg"].model.intermediate_size // 2)


def test_mesh_restore_slices_each_ranks_shard(world):
    got, want = world["got"]["restored"], world["got"]["f32"]
    np.testing.assert_array_equal(got["binary"], want["binary"])
    assert got["many"] == want["many"]


def test_ring_engine_engages_and_matches_dense(world):
    got, want = world["got"]["ring"], world["want"]["ring"]
    # 2 visual layers per forward, on every rank: run() and the 2 chunks
    # of run_many
    assert all(c >= 2 * 3 for c in world["ring_calls"])
    np.testing.assert_allclose(got["binary"], want["binary"], atol=ATOL)
    np.testing.assert_allclose(got["vision_logit"], want["vision_logit"],
                               atol=ATOL)
    assert got["answers"] == want["answers"]
    assert got["many"] == want["many"]


def test_idle_mesh_engine_outlasts_the_group_timeout(world):
    """A served mesh idle for longer than its collectives' timeout still
    answers: the followers wait for rank 0's next dispatch on the idle
    group, not on a collective that times out."""
    pcfg = dataclasses.replace(world["cfg"], mesh=port_config.MeshConfig())
    sd = world["sd"]
    got = spawn_ranks(ranks.idle_rank, 2, args=(pcfg, sd, IDLE_S),
                      timeout_s=180, group_timeout_s=GROUP_TIMEOUT_S)[0]
    np.testing.assert_array_equal(got["after"], got["before"])
    np.testing.assert_allclose(got["before"], world["want"]["f32"]["binary"],
                               atol=ATOL)


def test_serveapp_serves_a_job_through_a_mesh(tmp_path):
    root = tmp_path / "features"
    root.mkdir()
    write_feature_files(str(root), 32, ["img_a", "img_b"])
    jcfg = _jax_cfg()
    pcfg = _port_cfg(jcfg)
    pcfg = dataclasses.replace(
        pcfg, mesh=port_config.MeshConfig(),
        serving=dataclasses.replace(
            pcfg.serving, queue_db_path=str(tmp_path / "q.sqlite3"),
            results_db_path=str(tmp_path / "r.sqlite3"),
            media_root=str(tmp_path / "media"), http_port=0, ws_port=0))
    got = spawn_ranks(ranks.serve_rank, 2, args=(pcfg, str(root)),
                      timeout_s=180)[0]
    assert got["mesh"] == {"dp": 2, "tp": 1}
    assert got["step"] == "acked"
    assert got["answer"]["kind"] == "ranking"
    assert len(got["answer"]["ranking"]) == 2
