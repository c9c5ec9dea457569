"""The trainer's data: masking, batch builders, datasets and the sampler.

The data half of ``vilbert_multitask_tpu/train/loop.py`` (:53-471), numpy
only. Every draw is the same seeded numpy call in the same order as there,
so each batch is bit-equal to the JAX package's:

- ``SyntheticTaskData``: shape-correct random batches for any head;
- ``JsonlTaskData``: the eval harness's JSONL schema over a feature store
  (``features/pipeline.py``, ``features/store.py``, ``text/wordpiece.py``),
  with BERT masking and masked-region targets for pretraining;
- ``MultiTaskSampler``: one head per step, drawn by dataset size.

Draws are stateless, keyed by ``(seed, step, task id)``: a resumed run sees
the batches an uninterrupted run would have.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from vilbert_multitask_tpu_torch.config import FrameworkConfig
from vilbert_multitask_tpu_torch.features.pipeline import (
    batch_images,
    clip_regions,
    encode_image,
)
from vilbert_multitask_tpu_torch.text.pipeline import encode_question
from vilbert_multitask_tpu_torch.utils import IndexedJsonl

# head → serving task id (config.TASK_REGISTRY). "pretrain" is the masked
# objective pair (masked LM + masked region); task token 0 is its own.
HEAD_TASK_IDS = {"vqa": 1, "gqa": 15, "tri": 13, "binary": 12,
                 "grounding": 11, "retrieval": 7, "pretrain": 0}

# Heads that train as one group under one loss configuration.
HEAD_LOSS_GROUPS = {"pretrain": ("mlm", "mrm")}


def apply_mlm_masking(input_ids: np.ndarray, input_mask: np.ndarray,
                      rng, *, mask_id: int, vocab_size: int,
                      special_ids: Sequence[int],
                      mask_prob: float = 0.15) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """BERT dynamic masking: 15% of real, non-special positions; of those
    80% → [MASK], 10% → a random id, 10% kept. Returns (masked_ids, labels),
    label -1 where nothing was masked."""
    ids = input_ids.copy()
    labels = np.full_like(ids, -1)
    special = np.isin(ids, np.asarray(list(special_ids)))
    candidates = (input_mask > 0) & ~special
    pick = candidates & (rng.random(ids.shape) < mask_prob)
    labels[pick] = ids[pick]
    action = rng.random(ids.shape)
    ids[pick & (action < 0.8)] = mask_id
    rand_pos = pick & (action >= 0.8) & (action < 0.9)
    ids[rand_pos] = rng.integers(0, vocab_size, int(rand_pos.sum()))
    return ids, labels


def apply_mrm_masking(regions, rng, *, n_classes: int, max_regions: int,
                      mask_prob: float = 0.15):
    """Masked-region modelling on the raw region sets, before encoding:
    ~15% of each image's detector rows are zeroed, so the global mean row
    ``encode_image`` prepends is computed over the masked features. The
    target is the detector's class distribution (``cls_prob``), or uniform
    where a region set carries none of width ``n_classes``.

    Returns (masked_regions, mrm_target (B, max_regions, C), mrm_mask (B,
    max_regions)), aligned to the encoded layout (row 0, the global row,
    never masked)."""
    masked, targets, masks = [], [], []
    for r in regions:
        n = int(r.num_boxes)
        pick = rng.random((n,)) < mask_prob
        feats = np.asarray(r.features[:n], np.float32).copy()
        feats[pick] = 0.0
        masked.append(dataclasses.replace(r, features=feats, num_boxes=n))
        target = np.full((max_regions, n_classes), 1.0 / n_classes,
                         np.float32)
        cp = r.cls_prob
        if cp is not None and cp.ndim == 2 and cp.shape[1] == n_classes:
            k = min(cp.shape[0], n, max_regions - 1)
            row_sum = np.clip(cp[:k].sum(axis=-1, keepdims=True), 1e-9, None)
            target[1 : k + 1] = cp[:k] / row_sum
        targets.append(target)
        if n > max_regions - 1:
            raise ValueError(
                f"{n} regions exceed the {max_regions - 1} budget — run "
                f"clip_regions before masking")
        mask = np.zeros((max_regions,), np.float32)
        mask[1 : n + 1] = pick.astype(np.float32)
        masks.append(mask)
    return masked, np.stack(targets), np.stack(masks)


def _text_batch(tokenizer, questions: Sequence[str], max_len: int,
                task_id: int) -> Dict[str, np.ndarray]:
    enc = [encode_question(tokenizer, q, max_len, task_id=task_id)
           for q in questions]
    return dict(
        input_ids=np.stack([e.input_ids for e in enc]),
        segment_ids=np.stack([e.segment_ids for e in enc]),
        input_mask=np.stack([e.input_mask for e in enc]),
        task_ids=np.full((len(enc), 1), task_id, np.int32),
    )


def _image_batch(regions, max_regions: int) -> Dict[str, np.ndarray]:
    feats, spatials, mask = batch_images(
        [encode_image(r, max_regions) for r in regions])
    return dict(features=feats, spatials=spatials, image_mask=mask)


def iou_grounding_target(boxes: np.ndarray, gt_box: Sequence[float],
                         n_regions: int, max_regions: int) -> np.ndarray:
    """Per-region soft target from a ground-truth box: the IoU where it is
    ≥ 0.5, renormalised; if no region clears 0.5 the best one takes the
    whole mass. Row 0, the global region, is never a target."""
    target = np.zeros((max_regions,), np.float32)
    if n_regions == 0:
        return target
    b = np.asarray(boxes[:n_regions], np.float32)
    gx1, gy1, gx2, gy2 = [float(v) for v in gt_box]
    ix1 = np.maximum(b[:, 0], gx1)
    iy1 = np.maximum(b[:, 1], gy1)
    ix2 = np.minimum(b[:, 2], gx2)
    iy2 = np.minimum(b[:, 3], gy2)
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    area_g = max((gx2 - gx1) * (gy2 - gy1), 1e-9)
    iou = inter / np.clip(area_b + area_g - inter, 1e-9, None)
    keep = iou * (iou >= 0.5)
    if keep.sum() <= 0:
        keep = np.zeros_like(iou)
        keep[int(np.argmax(iou))] = 1.0
    target[1 : n_regions + 1] = keep / keep.sum()
    return target


def vqa_soft_target(answers: Sequence[str], ans2label: Dict[str, int],
                    num_labels: int) -> np.ndarray:
    """VQAv2 soft score: min(1, matching annotators × 0.3) per label."""
    target = np.zeros((num_labels,), np.float32)
    for ans in set(answers):
        idx = ans2label.get(ans)
        if idx is not None:
            target[idx] = min(1.0, 0.3 * sum(a == ans for a in answers))
    return target


class SyntheticTaskData:
    """Shape-correct random batches for one head (smoke and timing runs)."""

    def __init__(self, head: str, cfg: FrameworkConfig, *, seed: int = 0,
                 group_size: int = 2):
        if head not in HEAD_TASK_IDS:
            raise ValueError(f"unknown head {head!r}")
        self.head = head
        self.cfg = cfg
        self.group_size = group_size
        self.seed = seed

    def batch(self, batch_size: int, *, step: int = 0
              ) -> Dict[str, np.ndarray]:
        # Keyed by the global step (exact resume); the task id keeps this
        # stream apart from the sampler's head draw at the same step.
        rng = np.random.default_rng(
            (self.seed, step, HEAD_TASK_IDS[self.head]))
        m, e = self.cfg.model, self.cfg.engine
        B, Nt, Nv = batch_size, e.max_text_len, e.max_regions
        out = dict(
            input_ids=rng.integers(0, m.vocab_size, (B, Nt)).astype(np.int32),
            segment_ids=np.zeros((B, Nt), np.int32),
            input_mask=np.ones((B, Nt), np.int32),
            features=rng.standard_normal(
                (B, Nv, m.v_feature_size)).astype(np.float32),
            spatials=rng.random((B, Nv, 5)).astype(np.float32),
            image_mask=np.ones((B, Nv), np.int32),
            task_ids=np.full((B, 1), HEAD_TASK_IDS[self.head], np.int32),
        )
        h = self.head
        if h == "vqa":
            out["vqa_target"] = rng.random((B, m.num_labels)).astype(
                np.float32)
        elif h == "gqa":
            out["gqa_target"] = rng.random((B, m.gqa_num_labels)).astype(
                np.float32)
        elif h == "tri":
            out["tri_label"] = rng.integers(0, 3, (B,)).astype(np.int32)
        elif h == "binary":
            if B % 2:
                raise ValueError("binary (NLVR2) needs an even batch")
            out["binary_label"] = rng.integers(0, 2, (B // 2,)).astype(
                np.int32)
        elif h == "grounding":
            t = rng.random((B, Nv)).astype(np.float32)
            out["grounding_target"] = t / t.sum(axis=-1, keepdims=True)
        elif h == "retrieval":
            if B % self.group_size:
                raise ValueError(
                    "retrieval batch must be divisible by group_size")
        elif h == "pretrain":
            labels = np.full((B, Nt), -1, np.int32)
            pick = rng.random((B, Nt)) < 0.15
            labels[pick] = rng.integers(
                0, m.vocab_size, int(pick.sum())).astype(np.int32)
            out["mlm_labels"] = labels
            t = rng.random((B, Nv, m.v_target_size)).astype(np.float32)
            out["mrm_target"] = t / t.sum(axis=-1, keepdims=True)
            out["mrm_mask"] = (rng.random((B, Nv)) < 0.15).astype(np.float32)
        return out


class JsonlTaskData:
    """One head's dataset: the eval harness's JSONL schema over a feature
    store (fixtures under ``tests/fixtures/golden/*.jsonl``).

    vqa/gqa: {"question", "image", "answers": [...]}
    tri:     {"premise"|"question", "image", "label": 0..2}
    binary:  {"caption", "images": [a, b], "label": bool}
    grounding: {"expression", "image", "gt_box": [x1, y1, x2, y2]}
    pretrain: {"caption", "image"}, masked dynamically per (seed, step):
              BERT 80/10/10 token masking and ~15% region zeroing with the
              detector's class distribution (``cls_prob``) as the target.
    retrieval: {"caption", "images": [...], "target": i}: the caption over
              ``group_size`` candidates, the positive at offset 0.
    """

    def __init__(self, head: str, jsonl_path: str, feature_store, tokenizer,
                 cfg: FrameworkConfig, *, label_map=None, seed: int = 0,
                 group_size: int = 2):
        if head not in ("vqa", "gqa", "tri", "binary", "grounding",
                        "pretrain", "retrieval"):
            raise ValueError(f"no JSONL loader for head {head!r}")
        self.group_size = group_size
        self.head = head
        # Offset-indexed, not loaded whole: at real dataset sizes resident
        # parsed records would be the trainer's memory bill.
        self.examples = IndexedJsonl(jsonl_path)
        if not self.examples:
            raise ValueError(f"empty dataset {jsonl_path}")
        self.store = feature_store
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.ans2label: Dict[str, int] = {}
        if label_map is not None:
            self.ans2label = {a: i for i, a in enumerate(label_map)}
        if head in ("vqa", "gqa") and not self.ans2label:
            # Without the map every soft target is zero and BCE only pushes
            # every logit down: training runs and learns nothing.
            raise ValueError(
                f"head {head!r} needs a non-empty label_map "
                "(answer-string → index); got none")
        self.seed = seed
        self._warned_uniform_mrm = False

    def __len__(self) -> int:
        return len(self.examples)

    def close(self) -> None:
        """Release the dataset's file handle."""
        self.examples.close()

    def _question_of(self, ex: Dict) -> str:
        for k in ("question", "expression", "caption", "premise"):
            if k in ex:
                return ex[k]
        raise KeyError(f"no text field in example {sorted(ex)}")

    def batch(self, batch_size: int, *, step: int = 0
              ) -> Dict[str, np.ndarray]:
        m, e = self.cfg.model, self.cfg.engine
        h = self.head
        if h == "binary":
            if batch_size % 2:
                raise ValueError(
                    f"NLVR2 batch {batch_size} must be even (2 images/row)")
            n_logical = batch_size // 2
        elif h == "retrieval":
            if batch_size % self.group_size:
                raise ValueError(
                    f"retrieval batch {batch_size} must be divisible by "
                    f"group_size {self.group_size}")
            n_logical = batch_size // self.group_size
        else:
            n_logical = batch_size
        rng_idx = np.random.default_rng((self.seed, step, HEAD_TASK_IDS[h]))
        idx = rng_idx.integers(0, len(self.examples), (n_logical,))
        exs = [self.examples[i] for i in idx]
        task_id = HEAD_TASK_IDS[h]

        if h == "binary":  # NLVR2: the text repeated per image of the pair
            questions, image_keys = [], []
            for ex in exs:
                questions.extend([self._question_of(ex)] * 2)
                image_keys.extend(ex["images"][:2])
        elif h == "retrieval":
            # The positive first (the contrastive loss scores index 0 as
            # aligned), then group_size - 1 drawn distractors.
            questions, image_keys = [], []
            for ex in exs:
                imgs = list(ex["images"])
                pos = int(ex.get("target", 0))
                distract = [k for j, k in enumerate(imgs) if j != pos]
                need = self.group_size - 1
                if len(distract) < need:
                    raise ValueError(
                        f"retrieval example needs ≥{self.group_size} images")
                picks = list(rng_idx.choice(len(distract), size=need,
                                            replace=False))
                questions.extend([self._question_of(ex)] * self.group_size)
                image_keys.append(imgs[pos])
                image_keys.extend(distract[j] for j in picks)
        else:
            questions = [self._question_of(ex) for ex in exs]
            image_keys = [ex["image"] for ex in exs]

        regions = clip_regions(self.store.get_batch(image_keys),
                               e.max_regions)
        if h == "pretrain":
            # Mask the raw rows before encoding: the global row 0 is the
            # mean over region features and must see the zeros.
            rng = np.random.default_rng(
                (self.seed, step, HEAD_TASK_IDS[h], 1))
            if not self._warned_uniform_mrm:
                bad = sum(1 for r in regions
                          if r.cls_prob is None or r.cls_prob.ndim != 2
                          or r.cls_prob.shape[1] != m.v_target_size)
                if bad:
                    logging.getLogger(__name__).warning(
                        "%d/%d sampled images carry no usable cls_prob "
                        "(need (N, %d)); their MRM targets fall back to "
                        "uniform", bad, len(regions), m.v_target_size)
                    self._warned_uniform_mrm = True
            regions, mrm_target, mrm_mask = apply_mrm_masking(
                regions, rng, n_classes=m.v_target_size,
                max_regions=e.max_regions)
        out = _text_batch(self.tokenizer, questions, e.max_text_len, task_id)
        out.update(_image_batch(regions, e.max_regions))

        if h in ("vqa", "gqa"):
            key = "vqa_target" if h == "vqa" else "gqa_target"
            width = m.num_labels if h == "vqa" else m.gqa_num_labels
            out[key] = np.stack([
                vqa_soft_target(ex["answers"], self.ans2label, width)
                for ex in exs])
        elif h == "tri":
            out["tri_label"] = np.asarray([int(ex["label"]) for ex in exs],
                                          np.int32)
        elif h == "binary":
            out["binary_label"] = np.asarray(
                [int(bool(ex["label"])) for ex in exs], np.int32)
        elif h == "grounding":
            out["grounding_target"] = np.stack([
                iou_grounding_target(r.boxes, ex["gt_box"], r.num_boxes,
                                     e.max_regions)
                for ex, r in zip(exs, regions)])
        elif h == "pretrain":
            # The text side masks with its own per-step stream.
            rng = np.random.default_rng(
                (self.seed, step, HEAD_TASK_IDS[h], 2))
            tok = self.tokenizer
            specials = (tok.pad_id, tok.cls_id, tok.sep_id, tok.mask_id)
            out["input_ids"], out["mlm_labels"] = apply_mlm_masking(
                out["input_ids"], out["input_mask"], rng,
                mask_id=tok.mask_id, vocab_size=m.vocab_size,
                special_ids=specials)
            out["mrm_target"] = mrm_target
            out["mrm_mask"] = mrm_mask
        return out


class MultiTaskSampler:
    """Task alternation: each step draws one head (weighted by dataset size
    unless ``weights`` says otherwise) and asks its dataset for a batch.
    Draws are keyed by the global step, so a resumed run replays the
    schedule an uninterrupted run would have."""

    # Head selection must not share a bitstream with any dataset's draws at
    # the same (seed, step).
    _STREAM = 0x5A

    def __init__(self, datasets: Dict[str, object], *,
                 weights: Optional[Dict[str, float]] = None, seed: int = 0):
        if not datasets:
            raise ValueError("need at least one task dataset")
        self.datasets = dict(datasets)
        self.heads = sorted(self.datasets)
        if weights:
            w = np.asarray([float(weights.get(h, 1.0)) for h in self.heads])
        else:
            w = np.asarray([
                float(len(d)) if hasattr(d, "__len__") else 1.0
                for d in (self.datasets[h] for h in self.heads)])
        self.probs = w / w.sum()
        self.seed = seed

    def next(self, batch_size: int, step: int
             ) -> Tuple[str, Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, step, self._STREAM))
        head = self.heads[int(rng.choice(len(self.heads), p=self.probs))]
        return head, self.datasets[head].batch(batch_size, step=step)
