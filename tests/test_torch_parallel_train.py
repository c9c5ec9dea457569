"""The port's trainer on a process mesh (tests/test_train.py:98,131,
tests/test_train_loop.py:209,223,371).

On gloo ranks, from the same weights and batch, dropout off:

- three mesh train steps at dp 2 × tp 2 and at tp 4 against the
  single-device step, held to the chip parity limits of the single-device
  trainer (each loss within rtol 1e-5, the grad norm within 1e-6 at steps
  1-2 and 1e-4 at step 3; each parameter within a tenth of the three
  steps' learning rate, a leaf whose gradient is only rounding within the
  whole of it, and at most 1e-3 of the elements beyond 1e-6);
- the first step's loss against the JAX step's loss on its 8-device
  virtual mesh (tp 2), on weights from ``from_flax_params`` of its tree;
- the clip's global norm counts a replicated leaf once and sums the
  squared norms of tp shards.

Then the loop at dp 2 × tp 2: a snapshot and a resume on a fresh mesh
bit-equal to the uninterrupted run, a mesh snapshot restored on one device
and a single-device snapshot restored on the mesh, ``EvalHook`` on the
sharded parameters, and the CLI under the launcher.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import to_port_config
from vilbert_multitask_tpu.config import MeshConfig as JaxMeshConfig
from vilbert_multitask_tpu.config import ViLBertConfig
from vilbert_multitask_tpu.models.vilbert import ViLBertForVLTasks
from vilbert_multitask_tpu.parallel import build_mesh as jax_build_mesh
from vilbert_multitask_tpu.parallel import sharding as jax_shd
from vilbert_multitask_tpu.train.losses import LossConfig as JaxLossConfig
from vilbert_multitask_tpu.train.losses import multitask_loss
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.checkpoint.store import restore_train_state
from vilbert_multitask_tpu_torch.parallel.launch import spawn_ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
HEADS = ("vqa", "tri", "binary", "grounding", "mlm")
LOSS_RTOL, NORM_RTOL, NORM_RTOL_UPDATED = 1e-5, 1e-6, 1e-4
LR = 1e-4  # the steps' learning rate (torch_parallel_ranks.step_rank)


def _tp_divisible(vocab_size=512):
    """tests/test_train.py's tp-divisible tiny config."""
    return ViLBertConfig().tiny(
        hidden_size=64, num_attention_heads=4, intermediate_size=128,
        v_hidden_size=64, v_num_attention_heads=4, v_intermediate_size=128,
        bi_hidden_size=64, bi_num_attention_heads=4,
        bi_intermediate_size=128, vocab_size=vocab_size, num_labels=16,
        gqa_num_labels=16, v_target_size=12)


def _batch(cfg):
    """tests/test_train.py:_setup's batch (B = 4), as numpy."""
    b, nt, nv = 4, 12, 9
    rng = np.random.default_rng(0)
    return {
        "input_ids": rng.integers(0, cfg.vocab_size, (b, nt)).astype(
            np.int32),
        "features": rng.normal(size=(b, nv, cfg.v_feature_size)).astype(
            np.float32),
        "spatials": rng.random((b, nv, 5)).astype(np.float32),
        "segment_ids": np.zeros((b, nt), np.int32),
        "input_mask": np.ones((b, nt), np.int32),
        "image_mask": np.ones((b, nv), np.int32),
        "task_ids": np.ones((b, 1), np.int32),
        "vqa_target": (rng.random((b, cfg.num_labels)) < 0.1).astype(
            np.float32),
        "tri_label": rng.integers(0, 3, (b,)).astype(np.int32),
        "binary_label": rng.integers(0, 2, (b // 2,)).astype(np.int32),
        "grounding_target": rng.random((b, nv)).astype(np.float32),
        "mlm_labels": np.where(rng.random((b, nt)) < 0.3, rng.integers(
            0, cfg.vocab_size, (b, nt)), -1).astype(np.int32),
    }


@pytest.fixture(scope="module")
def steps():
    cfg = _tp_divisible()
    batch = _batch(cfg)
    model = ViLBertForVLTasks(cfg, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = ("input_ids", "features", "spatials", "segment_ids",
            "input_mask", "image_mask")
    params = jax.device_get(jax.jit(lambda key, b: model.init(
        key, *(b[k] for k in args), None, b["task_ids"],
        deterministic=True)["params"])(jax.random.PRNGKey(0), jb))
    # The JAX loss on its tp = 2 mesh (the first step's loss).
    mesh = jax_build_mesh(JaxMeshConfig(tp=2), devices=jax.devices()[:8])
    with mesh:
        placed = jax.device_put(jb, jax_shd.batch_shardings(jb, mesh))
        sharded = jax_shd.shard_params(params, mesh)
        loss = jax.jit(lambda p, b: multitask_loss(
            JaxLossConfig(heads=HEADS), model.apply(
                {"params": p}, *(b[k] for k in args), None, b["task_ids"],
                deterministic=True), b)[0])(sharded, placed)
    sd = {k: np.asarray(v) for k, v in
          from_flax_params(params, to_port_config(cfg)).items()}
    got = spawn_ranks(ranks.step_rank, 4,
                      args=(to_port_config(cfg), sd, batch), timeout_s=300)
    return dict(got=got, jax_loss=float(loss))


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


@pytest.mark.parametrize("mesh", ["dp2_tp2", "dp1_tp4"])
def test_mesh_steps_match_the_single_device_step(steps, mesh):
    got, single = steps["got"][0][mesh], steps["got"][0]["single"]
    for i, (m, s) in enumerate(zip(got["metrics"], single["metrics"])):
        for k, v in s.items():
            rtol = (LOSS_RTOL if k != "grad_norm" else NORM_RTOL if i < 2
                    else NORM_RTOL_UPDATED)
            assert _rel(m[k], v) <= rtol, (i, k, m[k], v)
    far = total = 0
    for k, p in single["params"].items():
        d = np.abs(got["params"][k] - p)
        limit = LR * 3 * (1.0 if _zero_gradient(k) else 0.1)
        assert d.max() <= limit, (k, d.max())
        if not _zero_gradient(k):
            far += int((d > 1e-6).sum())
            total += d.size
    assert far <= 1e-3 * total, (far, total)


def _zero_gradient(name: str) -> bool:
    """Leaves whose gradient is zero but for rounding (a softmax does not
    see a key bias): Adam turns that rounding into lr-sized steps."""
    return name.endswith(("key.bias", "key1.bias", "key2.bias",
                          "vil_logit.bias"))


def test_mesh_step_holds_shards_and_mirrored_moments(steps):
    got = steps["got"][0]["dp2_tp2"]
    assert got["dp"] == 2
    assert got["tp_shape"] == got["mu_shape"] == (64, 64)  # 128 / tp
    assert "bert.embeddings.word_embeddings.weight" in got["sharded"]
    assert "bert.encoder.layer.0.output.LayerNorm.weight" not in got[
        "sharded"]


def test_mesh_first_loss_matches_jax_on_its_mesh(steps):
    assert _rel(steps["got"][0]["dp2_tp2"]["metrics"][0]["loss/total"],
                steps["jax_loss"]) <= LOSS_RTOL


def test_clip_counts_replicated_leaves_once(steps):
    # |rep|^2 = 3 * 4 = 12 once; shards 1..4 of 2 elements: 2 * (1+4+9+16)
    want = (12 + 2 * 30) ** 0.5
    for r in steps["got"]:
        assert abs(r["clip_norm"] - want) < 1e-6


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    cfg = ranks.train_cfg(to_port_config(_tp_divisible(vocab_size=2048)))
    mesh_dir = str(tmp_path_factory.mktemp("mesh_ckpts"))
    single_dir = str(tmp_path_factory.mktemp("single_ckpts"))
    single, _ = ranks._trainer(cfg, ranks._loop(2, ckpt_every=2), None,
                               single_dir)
    single.train()
    got = spawn_ranks(ranks.loop_rank, 4,
                      args=(cfg, mesh_dir, GOLDEN, single_dir),
                      timeout_s=300)
    return dict(got=got, cfg=cfg, mesh_dir=mesh_dir,
                single=ranks._global_params(single.state))


def test_mesh_loop_trains(loop):
    logs = [json.loads(x) for x in loop["got"][0]["logs"]
            if x.startswith("{")]
    assert [m["step"] for m in logs] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss/total"]) for m in logs)
    assert loop["got"][0]["sharded_shape"] == (64, 64)


def test_mesh_resume_on_a_fresh_mesh_is_bit_exact(loop):
    got = loop["got"][0]
    assert got["resumed_step"] == 2
    assert got["snapshots"] == ["step_00000002", "step_00000004"]
    for k, v in got["ref"].items():
        np.testing.assert_array_equal(got["resumed"][k], v, err_msg=k)


def test_mesh_snapshot_restores_on_one_device(loop):
    t, _ = ranks._trainer(loop["cfg"], ranks._loop(4), None)
    restore_train_state(os.path.join(loop["mesh_dir"], "step_00000002"),
                        t.state)
    assert t.state.step == 2
    want = loop["got"][0]["restored_step2"]
    for k, v in ranks._global_params(t.state).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_single_device_snapshot_restores_on_the_mesh(loop):
    got = loop["got"][0]["from_single"]
    for k, v in loop["single"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_eval_hook_on_mesh_sharded_params(loop):
    scores = loop["got"][0]["eval"]
    assert 0.0 <= scores["eval/nlvr2/accuracy"] <= 1.0
    assert all(r["eval"] == {} for r in loop["got"][1:])  # rank 0 scores


def test_cli_trains_on_a_mesh_under_the_launcher(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "vilbert_multitask_tpu_torch.parallel.launch",
         "--nproc", "2", "--backend", "gloo", "--timeout", "240", "--",
         "vilbert_multitask_tpu_torch.train.loop", "--cpu", "--tiny",
         "--steps", "2", "--batch", "4", "--log-every", "1",
         "--mesh", "1,2", "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    finals = [json.loads(x)["final"] for x in out.stdout.splitlines()
              if x.startswith('{"final"')]
    assert len(finals) == 2  # every rank computes the global loss
    assert finals[0]["loss/total"] == finals[1]["loss/total"]
    assert os.listdir(tmp_path) == ["step_00000002"]
