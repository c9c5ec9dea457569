"""Standard metric definitions for the served task families.

The port's copy of ``vilbert_multitask_tpu/evals/metrics.py`` (pure Python).

- VQA soft accuracy: the official VQAv2 metric — ``min(#annotators who gave
  the predicted answer / 3, 1)``, averaged over all 10-choose-9 annotator
  subsets, which reduces to the closed form below.
- Grounding accuracy: top-1 predicted box hits iff IoU with the ground-truth
  box > 0.5 (the RefCOCO/Visual7W convention).
- Retrieval recall@k: fraction of queries whose aligned image ranks in the
  top k.
"""

from __future__ import annotations

from typing import Sequence


def vqa_soft_accuracy(pred: str, annotator_answers: Sequence[str]) -> float:
    """Official VQAv2 accuracy for one example (10 annotator answers)."""
    pred = pred.strip().lower()
    answers = [a.strip().lower() for a in annotator_answers]
    n = len(answers)
    if n == 0:
        return 0.0
    if n < 4:
        # degenerate annotation sets: plain match-rate
        return sum(a == pred for a in answers) / n
    # average of min(matches_in_subset / 3, 1) over all leave-one-out subsets
    total = 0.0
    for i in range(n):
        matches = sum(1 for j, a in enumerate(answers) if j != i and a == pred)
        total += min(matches / 3.0, 1.0)
    return total / n


def box_iou_single(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two xyxy boxes."""
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter)
    return inter / union if union > 0 else 0.0


def grounding_hit(pred_box: Sequence[float], gt_box: Sequence[float],
                  iou_threshold: float = 0.5) -> bool:
    return box_iou_single(pred_box, gt_box) > iou_threshold


def retrieval_recall_at_k(rank_of_target: int, k: int) -> bool:
    """``rank_of_target`` is 1-based."""
    return rank_of_target <= k
