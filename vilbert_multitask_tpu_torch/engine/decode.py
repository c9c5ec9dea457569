"""Per-task decoding: model output 10-tuple → answer payloads.

Reference capability: the per-task branches of ``prediction``
(reference worker.py:295-386) plus the result-marshalling in the callback
(worker.py:564-645), redesigned as pure host-side functions over numpy views
of :class:`~vilbert_multitask_tpu_torch.models.vilbert.ViLBertOutput`.

Decode families (config.TaskSpec.decode):
- ``labels``    tasks 1/2 (VQA), 15 (GQA): softmax → top-k answers via the
                label map (worker.py:295-323).
- ``binary``    task 12 (NLVR2): 2-way softmax over the paired head
                (worker.py:325-338).
- ``trinary``   task 13 (SNLI-VE): 3-way softmax (worker.py:341-354).
- ``ranking``   task 7 (retrieval): rank candidate images by vil_logit
                (worker.py:358-367).
- ``grounding`` tasks 4/11/16: top-k regions from vision_logit, mapped back
                to pixel boxes (worker.py:371-386).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

from vilbert_multitask_tpu_torch.config import (
    NLVR2_LABELS,
    SNLI_VE_LABELS,
    TaskSpec,
)
from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


@dataclasses.dataclass
class ImageMeta:
    """Per-image context the decoders need (path + original pixel size)."""

    path: str
    width: int
    height: int


@dataclasses.dataclass
class TaskResult:
    """One decoded answer, serializable for the DB row / websocket frame.

    ``kind`` mirrors TaskSpec.decode; exactly one payload field is populated.
    """

    task_id: int
    kind: str
    answers: List[Dict[str, Any]] | None = None  # labels/binary/trinary
    boxes: List[Dict[str, Any]] | None = None  # grounding
    ranking: List[Dict[str, Any]] | None = None  # retrieval

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"task_id": self.task_id, "kind": self.kind}
        for k in ("answers", "boxes", "ranking"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


def decode_labels(
    spec: TaskSpec, logits_row: np.ndarray, labels: LabelMapStore
) -> TaskResult:
    """VQA/GQA: softmax over the answer vocabulary, top-k answers."""
    probs = softmax(np.asarray(logits_row, np.float32))
    order = np.argsort(-probs)[: spec.top_k]
    return decode_labels_topk(spec, order, probs[order], labels)


def decode_labels_topk(
    spec: TaskSpec, top_idx: np.ndarray, top_probs: np.ndarray,
    labels: LabelMapStore,
) -> TaskResult:
    """VQA/GQA from an already-reduced top-k — the serving path, where the
    softmax + top-k ran on the device right after the forward
    (engine/runtime.py:_decode_bundle) so only k (index, prob) pairs cross
    the device→host link instead of the 3129/1533-wide head row."""
    vocab = labels.get(spec.label_map)
    answers = [
        {"answer": vocab[i] if i < len(vocab) else f"<{i}>",
         "confidence": float(p)}
        for i, p in zip(np.asarray(top_idx)[: spec.top_k],
                        np.asarray(top_probs)[: spec.top_k])
    ]
    return TaskResult(spec.task_id, "labels", answers=answers)


def decode_binary(spec: TaskSpec, logits_pair: np.ndarray) -> TaskResult:
    """NLVR2: 2-way softmax; labels (False, True) per worker.py:327."""
    probs = softmax(np.asarray(logits_pair, np.float32).reshape(-1)[:2])
    order = np.argsort(-probs)
    answers = [
        {"answer": NLVR2_LABELS[i], "confidence": float(probs[i])} for i in order
    ]
    return TaskResult(spec.task_id, "binary", answers=answers)


def decode_trinary(spec: TaskSpec, logits_row: np.ndarray) -> TaskResult:
    """SNLI-VE: contradiction/neutral/entailment (worker.py:342)."""
    probs = softmax(np.asarray(logits_row, np.float32).reshape(-1)[:3])
    order = np.argsort(-probs)
    answers = [
        {"answer": SNLI_VE_LABELS[i], "confidence": float(probs[i])} for i in order
    ]
    return TaskResult(spec.task_id, "trinary", answers=answers)


def decode_ranking(
    spec: TaskSpec, vil_logit: np.ndarray, images: Sequence[ImageMeta]
) -> TaskResult:
    """Retrieval: each batch row scored the caption against one candidate
    image (repeat-batching, worker.py:278-284); rank candidates by score."""
    n = len(images)
    scores = np.asarray(vil_logit, np.float32).reshape(-1)[:n]
    probs = softmax(scores)
    order = np.argsort(-scores)
    ranking = [
        {"rank": r + 1, "image": images[i].path, "score": float(scores[i]),
         "confidence": float(probs[i])}
        for r, i in enumerate(order)
    ]
    return TaskResult(spec.task_id, "ranking", ranking=ranking)


def decode_grounding(
    spec: TaskSpec,
    vision_logit_row: np.ndarray,  # (Nv, 1) — already mask-penalized
    spatials_row: np.ndarray,  # (Nv, 5) normalized
    image: ImageMeta,
    *,
    include_global_box: bool = True,
) -> TaskResult:
    """Visual7W/RefCOCO/GuessWhat: top-k regions → pixel boxes.

    The reference sorts the raw (mask-penalized) logits over all 101 regions
    including the prepended whole-image feature (worker.py:371-386) — so the
    global box can legitimately win. ``include_global_box=False`` restricts to
    detector boxes.
    """
    logits = np.asarray(vision_logit_row, np.float32).reshape(-1)
    probs = softmax(logits)
    start = 0 if include_global_box else 1
    order = start + np.argsort(-logits[start:])
    boxes: List[Dict[str, Any]] = []
    for i in order[: spec.top_k]:
        x1, y1, x2, y2 = (np.asarray(spatials_row[i, :4], np.float32)
                          * np.array([image.width, image.height,
                                      image.width, image.height], np.float32))
        boxes.append(
            {
                "region_index": int(i),
                "is_global": bool(i == 0),
                "box_xyxy": [float(x1), float(y1), float(x2), float(y2)],
                "box_normalized": [float(v) for v in spatials_row[i, :4]],
                "score": float(logits[i]),
                "confidence": float(probs[i]),
                "image": image.path,
            }
        )
    return TaskResult(spec.task_id, "grounding", boxes=boxes)
