"""The port's eval harness (``vilbert_multitask_tpu_torch/evals``) against
the JAX package's, on the CPU.

- the metric definitions' closed forms (pure Python copies);
- every eval task scored by the port's ``Evaluator`` on the port's engine
  equals the JAX ``Evaluator`` on the JAX engine with the same weights
  (scores are fractions of decoded answers: the same answers give the same
  floats, compared exactly);
- the committed golden fixtures (tests/fixtures/golden, read and never
  regenerated): the golden checkpoint, restored by the JAX package's own
  ``restore_params`` and carried across by ``from_flax_params``, scores
  exactly ``golden/scores.json`` on the port (CPU, f32, dense attention,
  ``golden_config()``'s shapes), within 1e-9 as tests/test_evals.py holds
  the JAX engine; and another seed moves a score;
- the CLI (``--cpu --tiny``) prints what the in-process Evaluator returns.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from tests.torch_port_helpers import engine_pair, write_feature_files
from vilbert_multitask_tpu.config import (
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu.evals import Evaluator as JaxEvaluator
from vilbert_multitask_tpu_torch.checkpoint import save_params
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.config import FrameworkConfig as PortFramework
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
from vilbert_multitask_tpu_torch.evals import (
    Evaluator,
    box_iou_single,
    grounding_hit,
    harness,
    load_jsonl,
    retrieval_recall_at_k,
    vqa_soft_accuracy,
)
from vilbert_multitask_tpu_torch.features.store import FeatureStore

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
IMAGES = [f"g{i}" for i in range(6)]
JAX_CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2, 4, 8), throughput_buckets=(8,),
        compute_dtype="float32",
        use_pallas_coattention=False, use_pallas_self_attention=False))


# ------------------------------------------------------------------ metrics
def test_vqa_soft_accuracy_closed_form():
    answers = ["cat"] * 10
    assert vqa_soft_accuracy("cat", answers) == 1.0
    assert vqa_soft_accuracy("dog", answers) == 0.0
    # 3 of 10 say "cat": 7 leave-one-out subsets keep 3 matches (1.0), 3
    # keep 2 (2/3): (7 + 3 * 2/3) / 10 = 0.9.
    answers = ["cat"] * 3 + ["dog"] * 7
    assert vqa_soft_accuracy("cat", answers) == pytest.approx(0.9)
    assert vqa_soft_accuracy("CAT ", answers) == pytest.approx(0.9)
    assert vqa_soft_accuracy("yes", ["yes"]) == 1.0
    assert vqa_soft_accuracy("no", ["yes"]) == 0.0
    assert vqa_soft_accuracy("x", []) == 0.0


def test_box_iou_hit_and_recall():
    assert box_iou_single([0, 0, 10, 10], [0, 0, 10, 10]) == 1.0
    assert box_iou_single([0, 0, 10, 10], [20, 20, 30, 30]) == 0.0
    assert box_iou_single([0, 0, 10, 10], [5, 0, 15, 10]) == pytest.approx(
        1 / 3)
    assert grounding_hit([0, 0, 10, 10], [1, 1, 10, 10])
    assert not grounding_hit([0, 0, 10, 10], [5, 0, 15, 10])
    assert retrieval_recall_at_k(1, 1) and not retrieval_recall_at_k(2, 1)


# ----------------------------------------------------- against the JAX one
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_evals_features"))
    write_feature_files(d, JAX_CFG.model.v_feature_size, IMAGES)
    jeng, peng, _ = engine_pair(JAX_CFG, d)
    return dict(jax=jeng, port=peng)


DATASETS = {
    "vqa": [{"question": f"what is in picture {i}", "image": f"g{i}.npy",
             "answers": ["yes", "no", "2", "red"] * 2 + ["yes", "no"]}
            for i in range(5)],
    "gqa": [{"question": f"is it left {i}", "image": f"g{i}.npy",
             "answers": ["yes"]} for i in range(4)],
    "grounding": [{"expression": f"the thing {i}", "image": f"g{i}.npy",
                   "gt_box": [10 * i, 10, 10 * i + 200, 160]}
                  for i in range(4)],
    "visual7w": [{"expression": f"which one {i}", "image": f"g{i}.npy",
                  "gt_box": [0, 0, 320, 240]} for i in range(3)],
    "retrieval": [{"caption": f"a scene {i}",
                   "images": [f"g{(i + j) % 6}.npy" for j in range(4)],
                   "target": i % 4} for i in range(4)],
    "retrieval_gallery": [{"caption": f"caption {i}", "image": f"g{i}.npy"}
                          for i in range(6)],
    "nlvr2": [{"caption": f"both {i}", "images": [f"g{i}.npy",
                                                  f"g{i + 1}.npy"],
               "label": bool(i % 2)} for i in range(4)],
}


@pytest.mark.parametrize("task", sorted(DATASETS))
def test_every_task_scores_like_the_jax_evaluator(world, task):
    kwargs = {"chunk": 4} if task == "retrieval_gallery" else {}
    want = JaxEvaluator(world["jax"], batch=3).run(task, DATASETS[task],
                                                   **kwargs)
    got = Evaluator(world["port"], batch=3).run(task, DATASETS[task],
                                                **kwargs)
    want.pop("wall_s")
    got.pop("wall_s")
    assert got == want


def test_unknown_task_raises(world):
    with pytest.raises(ValueError, match="unknown eval task"):
        Evaluator(world["port"]).run("pose-estimation", [])


# ------------------------------------------------------------ golden scores
def _golden_mod():
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "gen_golden_evals.py")
    spec = importlib.util.spec_from_file_location("gen_golden_evals", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden_port_engine(params=None, seed=0):
    g = _golden_mod()
    cfg = PortFramework.from_dict(dataclasses.asdict(g.golden_config()))
    return InferenceEngine(cfg, params=params, seed=seed, device="cpu",
                           feature_store=FeatureStore(
                               os.path.join(GOLDEN, "features")))


def _golden_scores():
    with open(os.path.join(GOLDEN, "scores.json")) as f:
        return json.load(f)


def test_golden_scores_exact_on_the_port():
    from vilbert_multitask_tpu.checkpoint.store import restore_params

    params = jax.device_get(restore_params(os.path.join(GOLDEN, "ckpt")))
    g = _golden_mod()
    engine = _golden_port_engine(from_flax_params(
        params, PortFramework.from_dict(
            dataclasses.asdict(g.golden_config())).model))
    ev = Evaluator(engine, batch=4)
    for task, expected in sorted(_golden_scores().items()):
        live = ev.run(task, load_jsonl(os.path.join(GOLDEN,
                                                    f"{task}.jsonl")))
        for key, val in expected.items():
            if isinstance(val, float):
                assert live[key] == pytest.approx(val, abs=1e-9), (
                    task, key, live)
            else:
                assert live[key] == val, (task, key, live)


def test_golden_scores_are_falsifiable_on_the_port():
    """Other weights (the port's own seeded init) move the VQA score, so
    the goldens bind to the weights on the port too."""
    engine = _golden_port_engine(seed=_golden_mod().GOLDEN_SEED + 1)
    live = Evaluator(engine, batch=4).run(
        "vqa", load_jsonl(os.path.join(GOLDEN, "vqa.jsonl")))
    assert live["accuracy"] != pytest.approx(
        _golden_scores()["vqa"]["accuracy"], abs=1e-9)


# ---------------------------------------------------------------------- CLI
def _cli_engine(params=None):
    from vilbert_multitask_tpu_torch.config import apply_backend_args

    class Args:
        cpu, tiny = True, True

    cfg = apply_backend_args(PortFramework(), Args())
    return InferenceEngine(cfg, params=params, device="cpu",
                           feature_store=FeatureStore(
                               os.path.join(GOLDEN, "features")))


@pytest.mark.parametrize("task", ["vqa", "retrieval"])
def test_cli_cpu_tiny_prints_what_the_evaluator_returns(task, capsys):
    data = os.path.join(GOLDEN, f"{task}.jsonl")
    harness.main(["--task", task, "--data", data, "--features",
                  os.path.join(GOLDEN, "features"), "--cpu", "--tiny",
                  "--batch", "4"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = Evaluator(_cli_engine(), batch=4).run(task, load_jsonl(data))
    printed.pop("wall_s")
    want.pop("wall_s")
    assert printed == want


def test_cli_reads_a_checkpoint_of_this_package(tmp_path, capsys):
    engine = _cli_engine()
    params = engine.init_params(seed=5)
    save_params(str(tmp_path / "ckpt"), params)
    data = os.path.join(GOLDEN, "vqa.jsonl")
    harness.main(["--task", "vqa", "--data", data, "--features",
                  os.path.join(GOLDEN, "features"), "--cpu", "--tiny",
                  "--checkpoint", str(tmp_path / "ckpt")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = Evaluator(_cli_engine(params)).run("vqa", load_jsonl(data))
    assert {k: v for k, v in printed.items() if k != "wall_s"} == {
        k: v for k, v in want.items() if k != "wall_s"}
    np.testing.assert_equal(printed["n"], 3)
