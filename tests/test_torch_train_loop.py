"""The port's training loop (``vilbert_multitask_tpu_torch/train/``) on the
CPU at the tiny config: its data bit-equal to the JAX package's at several
steps, and the non-mesh cases of tests/test_train_loop.py (every head
trains, the loss falls, bit-exact resume with dropout on, retention,
divergence, the eval hook on the served engine, the CLI)."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from tests import torch_port_helpers  # noqa: F401 — torch thread count
from vilbert_multitask_tpu import assets as jax_assets
from vilbert_multitask_tpu.features.pipeline import (
    RegionFeatures as JaxRegion,
)
from vilbert_multitask_tpu.features.store import FeatureStore as JaxStore
from vilbert_multitask_tpu.text.wordpiece import FullTokenizer as JaxTok
from vilbert_multitask_tpu.train import loop as jloop
from vilbert_multitask_tpu.utils import IndexedJsonl as JaxIndexedJsonl
from vilbert_multitask_tpu_torch import assets
from vilbert_multitask_tpu_torch.config import (
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.evals.harness import Evaluator, load_jsonl
from vilbert_multitask_tpu_torch.features.pipeline import (
    RegionFeatures,
    encode_image,
)
from vilbert_multitask_tpu_torch.features.store import (
    FeatureStore,
    save_reference_npy,
)
from vilbert_multitask_tpu_torch.text.wordpiece import FullTokenizer
from vilbert_multitask_tpu_torch.train import loop as ploop
from vilbert_multitask_tpu_torch.train.loop import (
    EvalHook,
    JsonlTaskData,
    LoopConfig,
    MultiTaskSampler,
    SyntheticTaskData,
    Trainer,
    latest_checkpoint,
)
from vilbert_multitask_tpu_torch.utils import IndexedJsonl

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
ALL_HEADS = ("binary", "gqa", "grounding", "pretrain", "retrieval", "tri",
             "vqa")


@pytest.fixture(scope="module")
def train_cfg():
    return FrameworkConfig(
        model=ViLBertConfig().tiny(),
        engine=EngineConfig(max_text_len=12, max_regions=9,
                            compute_dtype="float32",
                            use_pallas_coattention=False,
                            use_pallas_self_attention=False))


@pytest.fixture(scope="module")
def jax_cfg():
    from vilbert_multitask_tpu.config import EngineConfig as JaxEngineCfg
    from vilbert_multitask_tpu.config import FrameworkConfig as JaxCfg

    return JaxCfg(model=JaxCfg().model.tiny(),
                  engine=JaxEngineCfg(max_text_len=12, max_regions=9,
                                      compute_dtype="float32"))


def _loop(steps, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("log_every", 2)
    kw.setdefault("ckpt_every", 10_000)
    kw.setdefault("warmup_steps", 1)
    kw.setdefault("learning_rate", 1e-4)
    return LoopConfig(total_steps=steps, **kw)


def _sampler(cfg, heads=("vqa", "tri", "grounding", "binary")):
    return MultiTaskSampler({h: SyntheticTaskData(h, cfg) for h in heads})


def _trainer(cfg, sampler, loop, **kw):
    kw.setdefault("log_fn", lambda s: None)
    return Trainer(cfg, sampler, loop, device="cpu", **kw)


def assert_batches_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------- data vs the JAX
@pytest.mark.parametrize("head", ALL_HEADS)
def test_synthetic_batches_are_bit_equal_to_jax(train_cfg, jax_cfg, head):
    for step in (0, 1, 7):
        want = jloop.SyntheticTaskData(head, jax_cfg, seed=3).batch(
            4, step=step)
        got = SyntheticTaskData(head, train_cfg, seed=3).batch(4, step=step)
        assert_batches_equal(got, want)


def test_masking_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 400, (16, 24)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((16, 24), np.int32)
    mask[:, -4:] = 0
    kw = dict(mask_id=103, vocab_size=400, special_ids=(0, 101, 102, 103))
    for seed in (1, 2, 3):
        want = jloop.apply_mlm_masking(ids, mask, np.random.default_rng(seed),
                                       **kw)
        got = ploop.apply_mlm_masking(ids, mask, np.random.default_rng(seed),
                                      **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    r = np.random.RandomState(0)
    boxes = r.uniform(10, 200, (8, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + 20
    cp = r.rand(8, 6).astype(np.float32)
    feats = r.rand(8, 16).astype(np.float32)
    for seed in (3, 4):
        w_regions, w_t, w_m = jloop.apply_mrm_masking(
            [JaxRegion(feats, boxes, 640, 480, cls_prob=c)
             for c in (cp, None, cp[:, :3])],
            np.random.default_rng(seed), n_classes=6, max_regions=9)
        g_regions, g_t, g_m = ploop.apply_mrm_masking(
            [RegionFeatures(feats, boxes, 640, 480, cls_prob=c)
             for c in (cp, None, cp[:, :3])],
            np.random.default_rng(seed), n_classes=6, max_regions=9)
        np.testing.assert_array_equal(g_t, w_t)
        np.testing.assert_array_equal(g_m, w_m)
        for g, w in zip(g_regions, w_regions):
            np.testing.assert_array_equal(g.features, w.features)
            assert g.num_boxes == w.num_boxes
        assert g_m[:, 0].sum() == 0 and g_m.sum() > 0


def test_target_builders_are_bit_equal_to_jax():
    answers = ["a", "a", "a", "b", "c"]
    lab = {"a": 0, "b": 1, "d": 3}
    np.testing.assert_array_equal(ploop.vqa_soft_target(answers, lab, 4),
                                  jloop.vqa_soft_target(answers, lab, 4))
    boxes = np.array([[0, 0, 10, 10], [0, 0, 100, 100], [90, 90, 99, 99],
                      [5, 5, 95, 95]], np.float32)
    for gt, n in (([0, 0, 100, 100], 4), ([50, 50, 60, 60], 1),
                  ([0, 0, 12, 11], 3), ([0, 0, 1, 1], 0)):
        np.testing.assert_array_equal(
            ploop.iou_grounding_target(boxes, gt, n, 9),
            jloop.iou_grounding_target(boxes, gt, n, 9))


def test_sampler_is_bit_equal_to_jax(train_cfg, jax_cfg):
    weights = {"vqa": 3.0, "tri": 1.0, "grounding": 0.5}
    want = jloop.MultiTaskSampler(
        {h: jloop.SyntheticTaskData(h, jax_cfg) for h in weights},
        weights=weights, seed=5)
    got = MultiTaskSampler(
        {h: SyntheticTaskData(h, train_cfg) for h in weights},
        weights=weights, seed=5)
    np.testing.assert_array_equal(got.probs, want.probs)
    heads = []
    for step in range(12):
        gh, gb = got.next(2, step)
        wh, wb = want.next(2, step)
        assert gh == wh
        assert_batches_equal(gb, wb)
        heads.append(gh)
    assert len(set(heads)) > 1


def _stores():
    root = os.path.join(GOLDEN, "features")
    return (FeatureStore(root),
            FullTokenizer.from_vocab_file(assets.default_vocab_path()),
            JaxStore(root),
            JaxTok.from_vocab_file(jax_assets.default_vocab_path()))


@pytest.mark.parametrize("head,fixture,labels", [
    ("vqa", "vqa.jsonl", ["4", "brown", "left"]),
    ("gqa", "vqa.jsonl", ["brown", "4"]),
    ("grounding", "grounding.jsonl", None),
    ("binary", "nlvr2.jsonl", None),
    ("retrieval", "retrieval.jsonl", None),
    ("pretrain", "retrieval.jsonl", None),
])
def test_jsonl_batches_are_bit_equal_to_jax(train_cfg, jax_cfg, head,
                                            fixture, labels, tmp_path):
    store, tok, jstore, jtok = _stores()
    path = os.path.join(GOLDEN, fixture)
    if head == "pretrain":  # caption rows, one image each
        rows = load_jsonl(path)
        path = str(tmp_path / "pretrain.jsonl")
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps({"caption": r["caption"],
                                    "image": r["images"][0]}) + "\n")
    got_ds = JsonlTaskData(head, path, store, tok, train_cfg,
                           label_map=labels, seed=2)
    want_ds = jloop.JsonlTaskData(head, path, jstore, jtok, jax_cfg,
                                  label_map=labels, seed=2)
    try:
        for step in (0, 1, 5):
            assert_batches_equal(got_ds.batch(4, step=step),
                                 want_ds.batch(4, step=step))
    finally:
        got_ds.close()
        want_ds.close()


def test_jsonl_contract_errors(train_cfg):
    store, tok, _, _ = _stores()
    nlvr = JsonlTaskData("binary", os.path.join(GOLDEN, "nlvr2.jsonl"),
                         store, tok, train_cfg)
    with pytest.raises(ValueError, match="even"):
        nlvr.batch(5, step=0)
    with pytest.raises(ValueError, match="label_map"):
        JsonlTaskData("vqa", os.path.join(GOLDEN, "vqa.jsonl"), store, tok,
                      train_cfg)
    with pytest.raises(ValueError, match="unknown head"):
        SyntheticTaskData("nope", train_cfg)


def test_jsonl_clips_overprovisioned_store(train_cfg, jax_cfg, tmp_path):
    """A store entry with more boxes than the region budget is clipped to
    the top max_regions - 1, as the JAX loader does, bit for bit."""
    e = train_cfg.engine
    n_boxes = e.max_regions + 5
    rng = np.random.RandomState(0)
    boxes = rng.uniform(10, 200, (n_boxes, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + 20
    save_reference_npy(
        str(tmp_path / "big.npy"),
        RegionFeatures(rng.randn(n_boxes, train_cfg.model.v_feature_size)
                       .astype(np.float32), boxes, 640, 480), "big")
    jl = tmp_path / "grounding.jsonl"
    jl.write_text(json.dumps({"expression": "the thing", "image": "big",
                              "gt_box": [0, 0, 100, 100]}) + "\n")
    _, tok, _, jtok = _stores()
    ds = JsonlTaskData("grounding", str(jl), FeatureStore(str(tmp_path)),
                       tok, train_cfg)
    b = ds.batch(2, step=0)
    assert b["features"].shape[1] == e.max_regions
    np.testing.assert_allclose(b["grounding_target"].sum(axis=-1), 1.0,
                               atol=1e-5)
    want = jloop.JsonlTaskData("grounding", str(jl), JaxStore(str(tmp_path)),
                               jtok, jax_cfg).batch(2, step=0)
    assert_batches_equal(b, want)


def test_retrieval_positive_first(train_cfg):
    store, tok, _, _ = _stores()
    ds = JsonlTaskData("retrieval", os.path.join(GOLDEN, "retrieval.jsonl"),
                       store, tok, train_cfg, group_size=2)
    b = ds.batch(4, step=0)
    np.testing.assert_array_equal(b["input_ids"][0], b["input_ids"][1])
    examples = load_jsonl(os.path.join(GOLDEN, "retrieval.jsonl"))
    drawn = np.random.default_rng((0, 0, 7)).integers(0, len(examples), (2,))
    ex0 = examples[drawn[0]]
    pos = encode_image(store.get(ex0["images"][int(ex0["target"])]),
                       train_cfg.engine.max_regions)
    np.testing.assert_array_equal(b["features"][0], pos.features)


# ---------------------------------------------------------- IndexedJsonl
def test_indexed_jsonl_matches_eager_load(tmp_path):
    p = tmp_path / "data.jsonl"
    rows = [{"i": i, "text": f"q{i}" * (i % 5 + 1)} for i in range(57)]
    with open(p, "w") as f:
        for i, r in enumerate(rows):
            f.write(json.dumps(r) + "\n")
            if i % 7 == 0:
                f.write("\n")  # blank lines must not shift indices
    eager = load_jsonl(str(p))
    lazy = IndexedJsonl(str(p))
    ref = JaxIndexedJsonl(str(p))
    assert len(lazy) == len(eager) == len(ref) == 57
    assert list(lazy) == eager == list(ref)
    assert lazy[13] == eager[13]
    assert lazy[-1] == eager[-1]
    with pytest.raises(IndexError):
        lazy[57]
    assert lazy[np.int64(3)] == eager[3]
    assert lazy._offsets == ref._offsets
    lazy.close()
    ref.close()


def test_indexed_jsonl_concurrent_reads(tmp_path):
    path = tmp_path / "d.jsonl"
    with open(path, "w") as f:
        for i in range(200):
            f.write(json.dumps({"i": i, "pad": "x" * (i % 37)}) + "\n")
    with IndexedJsonl(str(path)) as ds:
        errors = []

        def reader(seed):
            rng = np.random.default_rng(seed)
            for _ in range(300):
                i = int(rng.integers(0, 200))
                if ds[i]["i"] != i:
                    errors.append(i)

        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:3]
    assert ds._f.closed


# ------------------------------------------------------------- the loop
def test_every_head_trains(train_cfg):
    """Each head's step runs on its own dataset, its loss finite, and the
    parameters its loss reads move."""
    logs = []
    heads = ALL_HEADS
    t = _trainer(train_cfg, _sampler(train_cfg, heads=heads),
                 _loop(len(heads) * 3, log_every=1),
                 log_fn=lambda s: logs.append(json.loads(s)))
    before = {k: v.detach().clone() for k, v in t.state.params.items()}
    final = t.train()
    assert final["step"] == len(heads) * 3 and t.state.step == final["step"]
    seen = {m["head"] for m in logs}
    assert seen <= set(heads) and len(seen) >= 4
    assert seen <= set(t._steps)
    for m in logs:
        assert all(np.isfinite(v) for k, v in m.items()
                   if k.startswith("loss/"))
        if m["head"] == "pretrain":
            assert "loss/mlm" in m and "loss/mrm" in m
    # Every parameter moved (AdamW: the read ones by their gradients, the
    # rest by weight decay), and the head of each seen task by its loss.
    moved = {k for k, v in t.state.params.items()
             if not torch.equal(v, before[k])}
    assert "vil_tri_prediction.weight" in moved
    assert "bert.encoder.c_layer.0.biattention.query1.weight" in moved


def test_loss_decreases_on_fixed_batch(train_cfg):
    class FixedData(SyntheticTaskData):
        def batch(self, batch_size, *, step=0):
            return super().batch(batch_size, step=0)

    logs = []
    t = _trainer(train_cfg, MultiTaskSampler({"vqa": FixedData("vqa",
                                                               train_cfg)}),
                 _loop(12, log_every=1),
                 log_fn=lambda s: logs.append(json.loads(s)))
    t.train()
    assert logs[-1]["loss/total"] < logs[0]["loss/total"]


def test_checkpoint_resume_is_bit_exact_with_dropout(train_cfg, tmp_path):
    """4 straight steps == 2 steps + snapshot + a fresh Trainer + 2 steps,
    tensor for tensor, dropout on (the tiny config's 0.1): the sampler is
    keyed by the step and the dropout generator rides the snapshot."""
    out = str(tmp_path / "ckpts")
    ref = _trainer(train_cfg, _sampler(train_cfg), _loop(4))
    assert ref.model.training and train_cfg.model.hidden_dropout_prob > 0
    ref.train()
    a = _trainer(train_cfg, _sampler(train_cfg), _loop(2, ckpt_every=2),
                 out_dir=out)
    a.train()
    found = latest_checkpoint(out)
    assert found is not None and found[1] == 2
    b = _trainer(train_cfg, _sampler(train_cfg), _loop(4, ckpt_every=2),
                 out_dir=out)
    assert b.state.step == 2
    assert torch.equal(b.state.generator.get_state(),
                       a.state.generator.get_state())
    b.train()
    for what in ("params", "mu", "nu"):
        for k, v in getattr(ref.state, what).items():
            assert torch.equal(getattr(b.state, what)[k], v), (what, k)
    assert torch.equal(b.state.generator.get_state(),
                       ref.state.generator.get_state())
    # And without the generator's state the run would differ: dropout draws.
    c = _trainer(train_cfg, _sampler(train_cfg), _loop(4))
    c.state.generator.manual_seed(99)
    c.train()
    assert not all(torch.equal(c.state.params[k], v)
                   for k, v in ref.state.params.items())


def test_interrupted_snapshot_leaves_the_last_complete_one(train_cfg,
                                                          tmp_path,
                                                          monkeypatch):
    """A trainer killed while writing a snapshot leaves no ``step_N``
    behind: the snapshot is written whole under a temporary name and
    renamed into place. A fresh Trainer resumes from the last complete
    snapshot, beside both a save interrupted by an exception (its
    temporary directory removed) and a process's leftover temporary
    directory holding half a file."""
    from vilbert_multitask_tpu_torch.checkpoint import store

    out = str(tmp_path / "ckpts")
    a = _trainer(train_cfg, _sampler(train_cfg), _loop(2, ckpt_every=2),
                 out_dir=out)
    a.train()
    real_save = torch.save

    def killed(obj, f, *args, **kw):
        with open(f, "wb") as fh:
            fh.write(b"half a snapshot")
        raise KeyboardInterrupt

    monkeypatch.setattr(store.torch, "save", killed)
    b = _trainer(train_cfg, _sampler(train_cfg), _loop(4, ckpt_every=2),
                 out_dir=out)
    with pytest.raises(KeyboardInterrupt):
        b.train()
    monkeypatch.setattr(store.torch, "save", real_save)
    assert sorted(os.listdir(out)) == ["step_00000002"]
    leftover = os.path.join(out, "step_00000004.tmp-12345")
    os.makedirs(leftover)
    with open(os.path.join(leftover, store.TRAIN_STATE_FILE), "wb") as fh:
        fh.write(b"half a snapshot")
    assert latest_checkpoint(out) == (os.path.join(out, "step_00000002"), 2)
    c = _trainer(train_cfg, _sampler(train_cfg), _loop(4, ckpt_every=2),
                 out_dir=out)
    assert c.state.step == 2
    for k, v in a.state.params.items():
        assert torch.equal(c.state.params[k], v), k
    c.train()
    assert latest_checkpoint(out)[1] == 4


def test_snapshot_refuses_an_existing_step(train_cfg, tmp_path):
    """A snapshot is never written over another (the JAX store's Orbax
    save refuses too); the first stays readable."""
    from vilbert_multitask_tpu_torch.checkpoint.store import (
        restore_train_state,
        save_train_state,
    )

    path = str(tmp_path / "step_00000001")
    t = _trainer(train_cfg, _sampler(train_cfg), _loop(1))
    t.train()
    save_train_state(path, t.state)
    with pytest.raises(FileExistsError):
        save_train_state(path, t.state)
    assert os.listdir(tmp_path) == ["step_00000001"]
    fresh = _trainer(train_cfg, _sampler(train_cfg), _loop(1))
    restore_train_state(path, fresh.state)
    assert fresh.state.step == 1
    for k, v in t.state.params.items():
        assert torch.equal(fresh.state.params[k], v), k


def test_checkpoint_retention(train_cfg, tmp_path):
    out = str(tmp_path / "ckpts")
    _trainer(train_cfg, _sampler(train_cfg),
             _loop(8, ckpt_every=2, keep_ckpts=2), out_dir=out).train()
    snaps = sorted(n for n in os.listdir(out) if n.startswith("step_"))
    assert snaps == ["step_00000006", "step_00000008"]


class _PoisonData(SyntheticTaskData):
    def batch(self, batch_size, *, step=0):
        b = super().batch(batch_size, step=step)
        b["features"] = np.full_like(b["features"], np.nan)
        return b


def test_trainer_aborts_on_divergence(train_cfg):
    t = _trainer(train_cfg,
                 MultiTaskSampler({"vqa": _PoisonData("vqa", train_cfg)}),
                 _loop(6, log_every=1))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        t.train()


def test_trainer_never_snapshots_diverged_state(train_cfg, tmp_path):
    out = str(tmp_path / "ckpts")
    t = _trainer(train_cfg,
                 MultiTaskSampler({"vqa": _PoisonData("vqa", train_cfg)}),
                 _loop(4, log_every=100, ckpt_every=1), out_dir=out)
    with pytest.raises(FloatingPointError, match="snapshot NOT written"):
        t.train()
    snaps = ([n for n in os.listdir(out) if n.startswith("step_")]
             if os.path.isdir(out) else [])
    assert not snaps


def test_retrieval_group_size_must_match(train_cfg):
    store, tok, _, _ = _stores()
    ds = JsonlTaskData("retrieval", os.path.join(GOLDEN, "retrieval.jsonl"),
                       store, tok, train_cfg, group_size=3)
    with pytest.raises(ValueError, match="group_size"):
        _trainer(train_cfg, MultiTaskSampler({"retrieval": ds}), _loop(1))


def test_jsonl_end_to_end_training(train_cfg):
    store, tok, _, _ = _stores()
    datasets = {
        "vqa": JsonlTaskData("vqa", os.path.join(GOLDEN, "vqa.jsonl"), store,
                             tok, train_cfg, label_map=["4", "brown"]),
        "retrieval": JsonlTaskData(
            "retrieval", os.path.join(GOLDEN, "retrieval.jsonl"), store, tok,
            train_cfg),
    }
    final = _trainer(train_cfg, MultiTaskSampler(datasets), _loop(4)).train()
    assert np.isfinite(final["loss/total"])


# ------------------------------------------------------------ eval hook
def _eval_tasks():
    return {"vqa": load_jsonl(os.path.join(GOLDEN, "vqa.jsonl")),
            "nlvr2": load_jsonl(os.path.join(GOLDEN, "nlvr2.jsonl"))}


def _vqa_bundle(eng, examples) -> list:
    """The float leaves of ``eng``'s decode bundle for the VQA
    ``examples``, packed into one chunk as the eval harness packs them."""
    reqs = [eng.prepare_from_store(1, e["question"], [e["image"]])
            for e in examples]
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif np.issubdtype(np.asarray(node).dtype, np.floating):
            leaves.append(np.asarray(node))

    walk(eng._dispatch_many(reqs).fetch())
    return leaves


def test_eval_hook_scores_as_a_fresh_engine(train_cfg):
    """The hook builds its engine once and later copies the parameters in;
    at each eval its scores equal a freshly built engine's on the same
    parameters, and so does its bundle for the eval rows (the same f32
    computation on the CPU: equal to 1e-6), which the steps between the
    two evals moved by far more: an engine still on the first eval's
    parameters fails."""
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    store = FeatureStore(os.path.join(GOLDEN, "features"))
    hook = EvalHook(train_cfg, store, _eval_tasks(), device="cpu")
    vqa = _eval_tasks()["vqa"]
    logs, fresh, bundles = [], [], []

    def eval_fn(step, state):
        scores = hook(step, state)
        eng = InferenceEngine(train_cfg, params={
            k: v.detach().clone() for k, v in state.state_dict().items()},
            feature_store=store, device="cpu")
        ev = Evaluator(eng)
        want = {}
        for task, examples in _eval_tasks().items():
            for k, v in ev.run(task, examples).items():
                if k not in EvalHook._META_KEYS and isinstance(v, (int,
                                                                   float)):
                    want[f"eval/{task}/{k}"] = round(float(v), 5)
        fresh.append(want)
        got = _vqa_bundle(hook._engine, vqa)
        for a, b in zip(got, _vqa_bundle(eng, vqa)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        bundles.append(got)
        return scores

    t = _trainer(train_cfg, _sampler(train_cfg),
                 _loop(4, eval_every=2, log_every=1), eval_fn=eval_fn,
                 log_fn=lambda s: logs.append(json.loads(s)))
    t.train()
    evals = [m for m in logs if any(k.startswith("eval/") for k in m)]
    assert len(evals) == 2 and len(fresh) == 2
    for got, want in zip(evals, fresh):
        assert {k: v for k, v in got.items() if k != "step"} == want
        assert 0.0 <= got["eval/vqa/accuracy"] <= 1.0
    assert hook._engine is not None
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(bundles[0], bundles[1]))
    assert moved > 1e-3


def test_eval_hook_rejects_unknown_tasks_and_skips_metadata(train_cfg):
    store = FeatureStore(os.path.join(GOLDEN, "features"))
    with pytest.raises(ValueError, match="unknown eval tasks"):
        EvalHook(train_cfg, store, {"snli_ve": []}, device="cpu")
    hook = EvalHook(train_cfg, store,
                    {"vqa": load_jsonl(os.path.join(GOLDEN, "vqa.jsonl"))},
                    device="cpu")
    t = _trainer(train_cfg, _sampler(train_cfg), _loop(1))
    scores = hook(1, t.state)
    assert "eval/vqa/accuracy" in scores
    assert not any(k.endswith(("/n", "/task_id", "/wall_s"))
                   for k in scores)


# ------------------------------------------------------------------ CLI
def test_cli_main_synthetic_smoke(capsys, tmp_path):
    out = str(tmp_path / "cli")
    ploop.main(["--cpu", "--tiny", "--steps", "2", "--batch", "2",
                "--heads", "tri,binary", "--log-every", "1", "--out", out])
    lines = capsys.readouterr().out.strip().splitlines()
    final = json.loads(lines[-1])
    assert np.isfinite(final["final"]["loss/total"])
    assert final["final"]["step"] == 2
    assert latest_checkpoint(out)[1] == 2
