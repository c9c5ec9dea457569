"""``ServeApp.rolling_swap`` on a process mesh against the JAX app's
``rolling_swap`` on its 8-device virtual mesh.

Two gloo ranks serve the tiny config at tp = 2 (rank 0's ``ServeApp``,
rank 1 following), booted from a checkpoint of the JAX engine's weights.
Swaps to other weights that rank 1 refuses (an ``engine.load`` fault
planned on rank 1 alone), from a checkpoint and from a tree in rank 0's
memory, raise on rank 0 with rank 1's error, and a tree with one leaf of a
wrong shape is refused on every rank; each leaves both ranks on the old
weights. The checkpoint swap then succeeds while a job is claimed, and so
does an in-memory swap; every job is answered, and the answers after each
swap equal the JAX app's after its own ``rolling_swap(params=)`` to the
same weights at atol 1e-4, with the same labels. The report carries
``last_swap``, ``cache_invalidated`` and the bytes broadcast. An int8
engine at tp = 2 that loads an f32 tree from rank 0's memory answers as a
one-device int8 engine loaded with the same tree.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel_engine import _jax_cfg, _port_cfg
from tests.torch_port_helpers import assert_same_result, write_feature_files
from vilbert_multitask_tpu.config import MeshConfig
from vilbert_multitask_tpu.engine.runtime import InferenceEngine as JaxEngine
from vilbert_multitask_tpu.features.store import FeatureStore as JaxStore
from vilbert_multitask_tpu.parallel import build_mesh
from vilbert_multitask_tpu.serve.app import ServeApp as JaxApp
from vilbert_multitask_tpu.serve.queue import make_job_message
from vilbert_multitask_tpu_torch import config as port_config
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.checkpoint.store import save_params
from vilbert_multitask_tpu_torch.parallel.launch import spawn_ranks

TOL = dict(rtol=0, atol=1e-4)
QUESTION = "what is the man holding"
JAX_MESH = MeshConfig(dp=4, tp=2)


def _serving(cfg, tmp, name):
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, queue_db_path=str(tmp / f"{name}_q.sqlite3"),
        results_db_path=str(tmp / f"{name}_r.sqlite3"),
        media_root=str(tmp / f"{name}_media"), http_port=0, ws_port=0))


def _answer(app, question: str, n: int) -> dict:
    app.queue.publish(make_job_message(["img_a.jpg"], question, 1,
                                       f"sock{n}"))
    assert app.worker.step() == "acked"
    return app.store.recent()[0]["answer_text"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_swap")
    root = tmp / "features"
    root.mkdir()
    write_feature_files(str(root), 32, ["img_a"])
    jcfg = _serving(dataclasses.replace(_jax_cfg(), mesh=JAX_MESH), tmp,
                    "jax")
    old = jax.device_get(JaxEngine(jcfg, seed=3).params)
    new = jax.device_get(JaxEngine(jcfg, seed=4).params)
    jeng = JaxEngine(jcfg, seed=3, mesh=build_mesh(JAX_MESH),
                     feature_store=JaxStore(str(root)))
    japp = JaxApp(jcfg, engine=jeng)
    japp.engine.mark_ready()  # what start() does for a no-warmup boot
    try:
        want = {"before": _answer(japp, QUESTION, 0),
                "refused": _answer(japp, ranks.REFUSED_QUESTION, 1)}
        japp.rolling_swap(params=new)
        want["after"] = _answer(japp, QUESTION, 2)
    finally:
        japp.stop()
    pcfg = _serving(_port_cfg(jcfg), tmp, "port")
    pcfg = dataclasses.replace(pcfg, mesh=port_config.MeshConfig(dp=1, tp=2))
    ckpts = {}
    for name, tree in (("old", old), ("new", new)):
        ckpts[name] = str(tmp / name)
        save_params(ckpts[name], {k: np.asarray(v) for k, v in
                                  from_flax_params(tree, pcfg.model).items()})
    got = spawn_ranks(ranks.swap_rank, 2, args=(
        pcfg, str(root), ckpts["old"], ckpts["new"]), timeout_s=240)[0]
    return dict(got=got, want=want)


def test_mesh_app_answers_as_the_jax_app_before_the_swap(world):
    assert_same_result(world["got"]["before"], world["want"]["before"], TOL)


def test_refused_swap_leaves_every_rank_on_the_old_weights(world):
    got = world["got"]
    assert "rank 1" in got["refused"] and "engine.load" in got["refused"]
    assert "every rank keeps its weights" in got["refused"]
    assert_same_result(got["after_refused"], world["want"]["refused"], TOL)
    assert got["gen_after_refused"] == 0


def test_mesh_swap_answers_as_the_jax_app_after_its_swap(world):
    got, want = world["got"], world["want"]
    assert_same_result(got["after"], want["after"], TOL)
    assert got["after"] != got["before"]


def test_mesh_swap_loses_no_job_and_reports(world):
    got = world["got"]
    assert got["during"]["answers"]  # the job claimed during the swap
    assert got["answered"] == 9
    # present; the jobs here went through the queue, not the result cache
    assert got["report"]["cache_invalidated"] == 0
    assert got["last_swap"]["checkpoint"].endswith("new")
    assert got["last_swap"]["replicas"][0]["load_s"] >= 0


@pytest.mark.parametrize("swap", ["refused_tree", "bad_shape"])
def test_refused_in_memory_swap_leaves_every_rank_on_the_old_weights(
        world, swap):
    got = world["got"]
    error = got[swap]
    assert "load of a tree on the mesh failed" in error
    assert "every rank keeps its weights" in error
    if swap == "refused_tree":
        assert "rank 1" in error and "engine.load" in error
        assert "rank 0" not in error
    else:  # every rank checks the leaf list before any weight moves
        assert "rank 0" in error and "rank 1" in error
        assert "shapes differ" in error and got["bad_key"] in error
    assert_same_result(got[f"after_{swap}"], world["want"]["refused"], TOL)


def test_in_memory_swap_on_a_mesh_answers_as_the_jax_app(world):
    got, want = world["got"], world["want"]
    assert_same_result(got["tree_old"], want["before"], TOL)
    assert_same_result(got["after_tree"], want["after"], TOL)
    assert got["during_tree"]["answers"]  # claimed during the swap
    assert got["answered"] == 9


def test_in_memory_swap_on_a_mesh_reports(world):
    got = world["got"]
    swap = got["last_tree_swap"]
    assert swap["checkpoint"] == "<in-memory>"
    # the f32 engine takes the f32 leaves as they are: each byte once
    assert swap["broadcast_bytes"] == got["tree_bytes"]
    assert got["tree_old_report"]["broadcast_bytes"] == got["tree_bytes"]
    assert swap["replicas"][0]["load_s"] >= 0 and swap["min_ready_seen"] == 1
    assert swap["cache_invalidated"] == 0
    assert got["last_swap"]["broadcast_bytes"] == 0  # a checkpoint


def test_int8_mesh_takes_an_f32_tree_as_one_device_does(world):
    got = world["got"]
    mesh, alone = got["int8_mesh"], got["int8_one_device"]
    np.testing.assert_allclose(mesh["binary"], alone["binary"], **TOL)
    assert mesh["answers"] == alone["answers"]
    # quantized on rank 0 before the broadcast: int8 values and f32 scales
    assert 0 < got["int8_bytes"] < got["tree_bytes"] / 2
