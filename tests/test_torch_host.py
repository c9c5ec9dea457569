"""The port's copies of the host-side modules give results identical to the
JAX package's on the same inputs: WordPiece tokenizer, question encoding
(with the GuessWhat reformat and truncation), region encode and batching,
the feature store formats, the label maps and the per-task decoders."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from vilbert_multitask_tpu import assets as jax_assets
from vilbert_multitask_tpu import config as jax_config
from vilbert_multitask_tpu.engine import decode as jax_decode
from vilbert_multitask_tpu.engine.labels import LabelMapStore as JaxLabels
from vilbert_multitask_tpu.features import pipeline as jax_feat
from vilbert_multitask_tpu.features import store as jax_store
from vilbert_multitask_tpu.text.pipeline import (
    encode_question as jax_encode_question,
)
from vilbert_multitask_tpu.text.wordpiece import (
    FullTokenizer as JaxTokenizer,
)
from vilbert_multitask_tpu_torch import assets, config
from vilbert_multitask_tpu_torch.engine import decode
from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore
from vilbert_multitask_tpu_torch.features import pipeline as feat
from vilbert_multitask_tpu_torch.features import store
from vilbert_multitask_tpu_torch.text.pipeline import encode_question
from vilbert_multitask_tpu_torch.text.wordpiece import FullTokenizer

TEXTS = [
    "What is the man holding?",
    "Is the bowl to the RIGHT of the mug",
    "q: is it a person? a: no q: is it red? a: yes",
    "Café naïve résumé — 東京 tower!!",
    "a man riding a horse on the beach " * 8,  # truncated at 37
    "",
]


@pytest.fixture(scope="module")
def tokenizers():
    return (FullTokenizer.from_vocab_file(assets.default_vocab_path()),
            JaxTokenizer.from_vocab_file(jax_assets.default_vocab_path()))


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches(tokenizers, text):
    ours, theirs = tokenizers
    assert ours.tokenize(text) == theirs.tokenize(text)
    assert ours.encode(text) == theirs.encode(text)


@pytest.mark.parametrize("task_id", sorted(jax_config.TASK_REGISTRY))
def test_encode_question_matches(tokenizers, task_id):
    ours, theirs = tokenizers
    for text in TEXTS:
        a = encode_question(ours, text, 37, task_id=task_id).stack(2)
        b = jax_encode_question(theirs, text, 37, task_id=task_id).stack(2)
        for f in ("input_ids", "input_mask", "segment_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_task_registry_and_label_constants_match():
    assert {k: dataclasses.asdict(v)
            for k, v in config.TASK_REGISTRY.items()} == {
        k: dataclasses.asdict(v)
        for k, v in jax_config.TASK_REGISTRY.items()}
    assert config.NLVR2_LABELS == jax_config.NLVR2_LABELS
    assert config.SNLI_VE_LABELS == jax_config.SNLI_VE_LABELS
    assert dataclasses.asdict(config.ViLBertConfig()) == dataclasses.asdict(
        jax_config.ViLBertConfig())
    assert dataclasses.asdict(config.ViLBertConfig().tiny()) == \
        dataclasses.asdict(jax_config.ViLBertConfig().tiny())


def _regions(n_boxes, dim=16, seed=0):
    return (feat.synthetic_regions(dim, n_boxes=n_boxes, seed=seed),
            jax_feat.synthetic_regions(dim, n_boxes=n_boxes, seed=seed))


@pytest.mark.parametrize("n_boxes", [3, 8, 12])
def test_region_encode_and_batch_match(n_boxes):
    ours, theirs = _regions(n_boxes)
    np.testing.assert_array_equal(ours.features, theirs.features)
    np.testing.assert_array_equal(ours.boxes, theirs.boxes)
    a = [feat.encode_image(r, 11) for r in
         feat.clip_regions([ours, ours], 11, num_features=8)]
    b = [jax_feat.encode_image(r, 11) for r in
         jax_feat.clip_regions([theirs, theirs], 11, num_features=8)]
    for x, y in zip(feat.batch_images(a, pad_to=4),
                    jax_feat.batch_images(b, pad_to=4)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        feat.build_spatials(ours.boxes, 640.0, 480.0),
        jax_feat.build_spatials(theirs.boxes, 640.0, 480.0))


@pytest.mark.parametrize("fmt", ["npy", "vlfr"])
def test_feature_store_reads_like_jax(tmp_path, fmt):
    ours, _ = _regions(6, dim=24, seed=3)
    path = str(tmp_path / f"img.{fmt}")
    if fmt == "npy":
        jax_store.save_reference_npy(path, ours, "img")
    else:
        store.save_vlfr(path, ours)
    a = store.FeatureStore(str(tmp_path)).get("uploads/img.jpg")
    b = jax_store.FeatureStore(str(tmp_path)).get("uploads/img.jpg")
    for f in ("features", "boxes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.image_width, a.image_height, a.num_boxes) == (
        b.image_width, b.image_height, b.num_boxes)


def test_label_maps_match():
    ours = LabelMapStore(root=assets.default_labels_root())
    theirs = JaxLabels(root=jax_assets.default_labels_root())
    for name in ("vqa", "gqa"):
        assert ours.get(name) == theirs.get(name)


@pytest.mark.parametrize("family", ["labels", "labels_topk", "binary",
                                    "trinary", "ranking", "grounding"])
def test_decoders_match(family):
    rng = np.random.default_rng(5)
    tasks = {"labels": 1, "labels_topk": 15, "binary": 12, "trinary": 13,
             "ranking": 7, "grounding": 11}
    ours_spec = config.TASK_REGISTRY[tasks[family]]
    theirs_spec = jax_config.TASK_REGISTRY[tasks[family]]
    ours_labels = LabelMapStore(root=assets.default_labels_root())
    theirs_labels = JaxLabels(root=jax_assets.default_labels_root())
    images = [("a.jpg", 640, 480), ("b.jpg", 320, 200), ("c.jpg", 50, 90)]
    if family == "labels":
        row = rng.normal(size=3129).astype(np.float32)
        a = decode.decode_labels(ours_spec, row, ours_labels)
        b = jax_decode.decode_labels(theirs_spec, row, theirs_labels)
    elif family == "labels_topk":
        idx, p = np.array([5, 1, 900]), np.array([0.5, 0.2, 0.1], np.float32)
        a = decode.decode_labels_topk(ours_spec, idx, p, ours_labels)
        b = jax_decode.decode_labels_topk(theirs_spec, idx, p, theirs_labels)
    elif family == "binary":
        row = rng.normal(size=2).astype(np.float32)
        a = decode.decode_binary(ours_spec, row)
        b = jax_decode.decode_binary(theirs_spec, row)
    elif family == "trinary":
        row = rng.normal(size=3).astype(np.float32)
        a = decode.decode_trinary(ours_spec, row)
        b = jax_decode.decode_trinary(theirs_spec, row)
    elif family == "ranking":
        scores = rng.normal(size=(3, 1)).astype(np.float32)
        a = decode.decode_ranking(
            ours_spec, scores, [decode.ImageMeta(*m) for m in images])
        b = jax_decode.decode_ranking(
            theirs_spec, scores, [jax_decode.ImageMeta(*m) for m in images])
    else:
        logits = rng.normal(size=(11, 1)).astype(np.float32)
        spatials = rng.random((11, 5)).astype(np.float32)
        a = decode.decode_grounding(ours_spec, logits, spatials,
                                    decode.ImageMeta(*images[0]))
        b = jax_decode.decode_grounding(theirs_spec, logits, spatials,
                                        jax_decode.ImageMeta(*images[0]))
    assert a.to_json() == b.to_json()
