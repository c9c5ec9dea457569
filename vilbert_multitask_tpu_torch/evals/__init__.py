"""Evaluation harness: the score-parity metrics (the port's copy of
``vilbert_multitask_tpu/evals``): dataset readers (simple JSONL schemas),
the standard metric definitions, and a batched engine-driven evaluator
with a CLI (``python -m vilbert_multitask_tpu_torch.evals.harness``)."""

from vilbert_multitask_tpu_torch.evals.metrics import (
    box_iou_single,
    grounding_hit,
    retrieval_recall_at_k,
    vqa_soft_accuracy,
)
from vilbert_multitask_tpu_torch.evals.harness import Evaluator, load_jsonl

__all__ = [
    "Evaluator",
    "box_iou_single",
    "grounding_hit",
    "load_jsonl",
    "retrieval_recall_at_k",
    "vqa_soft_accuracy",
]
