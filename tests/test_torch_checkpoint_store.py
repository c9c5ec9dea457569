"""The port's own checkpoints (checkpoint/store.py) and its onboarding CLI
(checkpoint/onboard.py), on the CPU.

- save -> restore is the identity (tensors compared exactly);
- ``restore_params(dtype="int8")`` equals ``quant.quantize_tree`` of the
  f32 tree, bit for bit; a checkpoint saved from an int8 engine restores
  unchanged; a floating ``dtype`` casts the floating leaves;
- ``restore_params_async`` joins, reports its seconds, re-raises;
- an upstream ``.bin`` (``state_dict`` wrapper, ``module.`` prefixes)
  restores through ``load_torch_checkpoint``, keys checked against the
  model;
- the onboarding CLI (``--cpu --tiny``) on a synthetic upstream-layout
  ``.bin`` (the JAX package's ``to_torch_state_dict`` of a seeded JAX
  engine's weights, torch-serialized with ``module.`` prefixes), the
  committed vocab, label files written through the port's LabelMapStore
  and a maskrcnn-layout detector file passes convert -> boot -> smoke ->
  parity, with parity held at 1e-9 against the JAX Evaluator on the JAX
  engine (the same weights decode to the same answers), and exits 1 on a
  planted miss, as tests/test_onboard.py rehearses the JAX CLI.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    detector_params,
    maskrcnn_state_dict,
    to_port_config,
)
from vilbert_multitask_tpu.checkpoint.convert import to_torch_state_dict
from vilbert_multitask_tpu.config import (
    DetectorConfig as JaxDetectorConfig,
)
from vilbert_multitask_tpu.config import FrameworkConfig as JaxFramework
from vilbert_multitask_tpu.engine.labels import LabelMapStore as JaxLabels
from vilbert_multitask_tpu.engine.runtime import InferenceEngine as JaxEngine
from vilbert_multitask_tpu.evals.harness import Evaluator as JaxEvaluator
from vilbert_multitask_tpu.evals.harness import load_jsonl
from vilbert_multitask_tpu.features.store import FeatureStore as JaxStore
from vilbert_multitask_tpu_torch import assets, quant
from vilbert_multitask_tpu_torch.checkpoint import (
    convert_and_save,
    onboard,
    restore_params,
    restore_params_async,
    save_params,
)
from vilbert_multitask_tpu_torch.config import EngineConfig, FrameworkConfig
from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore
from vilbert_multitask_tpu_torch.engine.runtime import (
    InferenceEngine,
    init_state_dict,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
CFG = FrameworkConfig(model=FrameworkConfig().model.tiny(),
                      engine=EngineConfig(compute_dtype="float32"))


@pytest.fixture(scope="module")
def weights():
    return init_state_dict(CFG.model, seed=2)


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if quant.is_quantized_leaf(w):
            assert quant.is_quantized_leaf(g), key
            for part in w:
                assert torch.equal(torch.as_tensor(g[part]),
                                   torch.as_tensor(w[part])), (key, part)
        else:
            assert g.dtype == torch.as_tensor(w).dtype, key
            assert torch.equal(g, torch.as_tensor(w)), key


def test_save_then_restore_is_the_identity(weights, tmp_path):
    save_params(str(tmp_path / "ckpt"), weights)
    _same(restore_params(str(tmp_path / "ckpt")), weights)
    _same(restore_params(str(tmp_path / "ckpt"), cfg=CFG.model), weights)


def test_save_refuses_to_overwrite_without_force(weights, tmp_path):
    path = str(tmp_path / "ckpt")
    save_params(path, weights)
    with pytest.raises(FileExistsError):
        save_params(path, weights)
    bumped = {k: v * 2 for k, v in weights.items()}
    save_params(path, bumped, force=True)
    _same(restore_params(path), bumped)


def test_int8_restore_quantizes_on_the_host_like_quantize_tree(
        weights, tmp_path):
    save_params(str(tmp_path / "ckpt"), weights)
    got = restore_params(str(tmp_path / "ckpt"), dtype="int8")
    _same(got, quant.quantize_tree(weights))
    assert all(v.device.type == "cpu" for k, p in got.items()
               for v in (p.values() if quant.is_quantized_leaf(p) else [p]))


def test_a_checkpoint_of_an_int8_engine_restores_unchanged(weights,
                                                           tmp_path):
    cfg = dataclasses.replace(CFG, engine=dataclasses.replace(
        CFG.engine, param_dtype="int8"))
    engine = InferenceEngine(cfg, params=weights, device="cpu")
    served = {k: quant.leaf_to(v) for k, v in engine.state_dict().items()}
    save_params(str(tmp_path / "int8"), served)
    want = {k: ({n: t.contiguous() for n, t in v.items()}
                if quant.is_quantized_leaf(v) else v)
            for k, v in served.items()}
    for dtype in (None, "int8"):
        _same(restore_params(str(tmp_path / "int8"), dtype=dtype), want)
    # Quantizing is idempotent: restored, then loaded, the engine serves
    # the same tensors.
    engine.load_params(restore_params(str(tmp_path / "int8"),
                                      dtype="int8"))
    _same({k: quant.leaf_to(v) for k, v in engine.state_dict().items()},
          want)


def test_floating_restore_casts_floating_leaves(weights, tmp_path):
    save_params(str(tmp_path / "ckpt"), weights)
    got = restore_params(str(tmp_path / "ckpt"), dtype="bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    with pytest.raises(ValueError, match="floating or 'int8'"):
        restore_params(str(tmp_path / "ckpt"), dtype="int16")


def test_async_restore_joins_times_and_reraises(weights, tmp_path):
    save_params(str(tmp_path / "ckpt"), weights)
    handle = restore_params_async(str(tmp_path / "ckpt"), dtype="int8")
    _same(handle.join(), quant.quantize_tree(weights))
    assert handle.seconds > 0
    bad = restore_params_async(str(tmp_path / "missing"), dtype="int8")
    with pytest.raises(FileNotFoundError):
        bad.join()


def test_an_upstream_bin_restores_through_load_torch_checkpoint(
        weights, tmp_path):
    path = str(tmp_path / "pytorch_model_9.bin")
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in weights.items()}}, path)
    _same(restore_params(path, cfg=CFG.model), weights)
    _same(restore_params(path), weights)
    broken = {k: v for k, v in weights.items()
              if k != "bert.t_pooler.dense.bias"}
    torch.save(broken, path)
    with pytest.raises(KeyError, match="1 missing keys"):
        restore_params(path, cfg=CFG.model)


def test_convert_and_save_writes_a_checkpoint_of_the_bin(weights,
                                                         tmp_path):
    path = str(tmp_path / "pytorch_model_9.bin")
    torch.save({f"module.{k}": v for k, v in weights.items()}, path)
    returned = convert_and_save(path, str(tmp_path / "ckpt"), CFG.model)
    _same(returned, weights)
    _same(restore_params(str(tmp_path / "ckpt"), cfg=CFG.model), weights)


# ---------------------------------------------------------------- onboard
@pytest.fixture(scope="module")
def assets_world(tmp_path_factory):
    """A seeded JAX engine's weights as a DataParallel-prefixed upstream
    .bin, a tiny maskrcnn-layout detector file, label files for both
    answer vocabularies, and the expected VQA score from the JAX Evaluator
    on the JAX engine (label files, committed vocab, golden data)."""
    root = tmp_path_factory.mktemp("onboard")
    vocab = assets.default_vocab_path()
    labels = str(root / "labels")
    jcfg = JaxFramework()
    jcfg = dataclasses.replace(jcfg, model=jcfg.model.tiny())
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(
        jcfg.engine, vocab_path=vocab, labels_root=labels,
        compute_dtype="float32", use_pallas_coattention=False,
        use_pallas_self_attention=False))
    store = LabelMapStore(labels, allow_synthetic=False)
    store.save_json("vqa", [f"ans_{i}"
                            for i in range(jcfg.model.num_labels)])
    store.save_json("gqa", [f"g_{i}"
                            for i in range(jcfg.model.gqa_num_labels)])
    src = JaxEngine(jcfg, seed=0,
                    label_store=JaxLabels(labels, allow_synthetic=False),
                    feature_store=JaxStore(os.path.join(GOLDEN, "features")))
    sd = to_torch_state_dict(jax.device_get(src.params), jcfg.model)
    bin_path = str(root / "pytorch_model_9.bin")
    torch.save({f"module.{k}": torch.from_numpy(np.array(v))
                for k, v in sd.items()}, bin_path)
    jdet = JaxDetectorConfig().tiny(
        representation_size=jcfg.model.v_feature_size)
    det_path = str(root / "model_final.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in
                          maskrcnn_state_dict(detector_params(jdet, seed=1),
                                              jdet).items()}}, det_path)
    vqa = JaxEvaluator(src, batch=4).run(
        "vqa", load_jsonl(os.path.join(GOLDEN, "vqa.jsonl")))
    return dict(root=root, vocab=vocab, labels=labels, bin=bin_path,
                det=det_path, vqa=vqa, model=to_port_config(jcfg.model))


def _argv(w, out, expect):
    return ["--torch-bin", w["bin"], "--vocab", w["vocab"],
            "--labels", w["labels"], "--out", out,
            "--detector-bin", w["det"],
            "--eval", f"vqa={os.path.join(GOLDEN, 'vqa.jsonl')}",
            "--features", os.path.join(GOLDEN, "features"),
            "--expect", expect, "--tol", "1e-9", "--tiny", "--cpu"]


def test_onboard_cli_converts_boots_smokes_and_holds_parity(assets_world,
                                                            capsys):
    w = assets_world
    expect = str(w["root"] / "expected.json")
    with open(expect, "w") as f:
        json.dump({"vqa": {"accuracy": w["vqa"]["accuracy"]}}, f)
    out = str(w["root"] / "onboarded")
    assert onboard.main(_argv(w, out, expect)) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is True
    steps = report["steps"]
    assert steps["boot"]["vocab_tokens"] > 1000
    assert steps["parity"]["failures"] == []
    assert steps["parity"]["scores"]["vqa"]["accuracy"] == pytest.approx(
        w["vqa"]["accuracy"], abs=1e-9)
    assert steps["detector"]["n_boxes"] >= 1
    assert os.path.isdir(steps["detector"]["params_dir"])
    # Smoke answers decoded out of the PROVIDED label files.
    assert steps["smoke"]["tasks"]["1"]["top"].startswith("ans_")
    assert os.path.exists(os.path.join(out, "report.json"))
    # The converted checkpoint is this package's own, restorable as is.
    params = restore_params(steps["convert"]["params_dir"],
                            cfg=w["model"])
    raw = torch.load(w["bin"], weights_only=True)
    assert set(params) == {k[len("module."):] for k in raw}
    assert all(torch.equal(params[k[len("module."):]], v)
               for k, v in raw.items())


def test_onboard_cli_exits_1_on_a_planted_miss(assets_world, capsys):
    w = assets_world
    expect = str(w["root"] / "wrong.json")
    with open(expect, "w") as f:
        json.dump({"vqa": {"accuracy": w["vqa"]["accuracy"] + 0.25},
                   "gqa": {"accuracy": 0.5}}, f)
    assert onboard.main(_argv(w, str(w["root"] / "again"), expect)) == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is False
    fails = report["steps"]["parity"]["failures"]
    assert any("vqa.accuracy" in f for f in fails)
    assert any("gqa" in f and "never evaluated" in f for f in fails)


def test_onboard_rejects_malformed_requests(tmp_path):
    with pytest.raises(SystemExit, match="TASK=DATA"):
        onboard._parse_evals(["vqa:data.jsonl"])
    expect = tmp_path / "exp.json"
    expect.write_text(json.dumps({"vqa": {"accuracy": 0.5}}))
    with pytest.raises(SystemExit, match="verify nothing"):
        onboard.main(["--torch-bin", "x.bin", "--vocab", "v", "--labels",
                      "l", "--out", str(tmp_path), "--expect", str(expect),
                      "--cpu"])
    with pytest.raises(SystemExit, match="needs --features"):
        onboard.main(["--torch-bin", "x.bin", "--vocab", "v", "--labels",
                      "l", "--out", str(tmp_path), "--eval", "vqa=d.jsonl",
                      "--cpu"])
