"""``ServeApp.rolling_swap`` on a process mesh against the JAX app's
``rolling_swap`` on its 8-device virtual mesh.

Two gloo ranks serve the tiny config at tp = 2 (rank 0's ``ServeApp``,
rank 1 following), booted from a checkpoint of the JAX engine's weights.
A swap to a checkpoint of other weights that rank 1's restore fails (an
``engine.load`` fault planned on rank 1 alone) raises on rank 0 with rank
1's error and leaves both ranks on the old weights; the same swap then
succeeds while a job is claimed, every job is answered, and the answers
after it equal the JAX app's after its own ``rolling_swap`` to the same
weights at atol 1e-4, with the same labels. The report carries
``last_swap`` and ``cache_invalidated``, and an in-memory tree is refused
on a mesh with the reason.
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
    assert got["answered"] == 4
    # present; the jobs here went through the queue, not the result cache
    assert got["report"]["cache_invalidated"] == 0
    assert got["last_swap"]["checkpoint"].endswith("new")
    assert got["last_swap"]["replicas"][0]["load_s"] >= 0


def test_in_memory_swap_on_a_mesh_says_why_it_cannot(world):
    assert "cannot receive an in-memory tree" in world["got"]["in_memory"]
