"""Per-task losses over the ViLBERT heads.

Counterpart of ``vilbert_multitask_tpu/train/losses.py``, with the same
families, reductions and metric keys:

- **labels** (VQA/GQA, ``vil_prediction*``): sigmoid BCE against soft answer
  scores, summed over the answer vocabulary, mean over the batch;
- **binary / trinary** (NLVR2 / SNLI-VE): softmax cross-entropy;
- **grounding** (``vision_logit``): cross-entropy between the region softmax
  (padded regions at -1e4) and the normalised IoU soft target;
- **ranking** (``vil_logit``): contrastive cross-entropy over each
  question's candidate group, the aligned image first;
- **masked LM / masked region** (``linguisic_prediction`` /
  ``vision_prediction``): the pretraining objectives.

Every loss casts its inputs to float32 before any reduction (``_f32``), as
the JAX package does, whatever the compute dtype: a bf16 softmax loses
answers with close logits. So even an f64 model computes its losses, and
the first gradient of its backward pass, in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from vilbert_multitask_tpu_torch.models.vilbert import ViLBertOutput


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def optax_sigmoid_bce(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits."""
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def label_bce_loss(logits, soft_targets) -> torch.Tensor:
    """Soft-target BCE, summed over the label axis (VQA convention)."""
    per = optax_sigmoid_bce(_f32(logits), _f32(soft_targets))
    return per.sum(dim=-1).mean()


def softmax_ce_loss(logits, labels) -> torch.Tensor:
    """Integer-label cross-entropy (NLVR2 binary, SNLI-VE trinary)."""
    logp = F.log_softmax(_f32(logits), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def grounding_loss(vision_logit, target_dist, image_mask) -> torch.Tensor:
    """Cross-entropy of the region softmax against the normalised IoU
    targets; padded regions masked out."""
    logits = _f32(vision_logit)[..., 0]  # (B, Nv)
    logits = torch.where(image_mask > 0, logits, torch.full_like(logits, -1e4))
    logp = F.log_softmax(logits, dim=-1)
    t = _f32(target_dist)
    t = t / torch.clamp_min(t.sum(dim=-1, keepdim=True), 1e-6)
    return -(t * logp).sum(dim=-1).mean()


def retrieval_contrastive_loss(vil_logit, group_size: int) -> torch.Tensor:
    """Cross-entropy over each question's candidate group; index 0 is the
    aligned image (a question's candidates lie contiguously, so (B, 1) →
    (B // K, K))."""
    scores = _f32(vil_logit).reshape(-1, group_size)
    return -F.log_softmax(scores, dim=-1)[:, 0].mean()


def masked_lm_loss(linguisic_prediction, mlm_labels) -> torch.Tensor:
    """Cross-entropy on masked positions; label -1 = not masked.

    With task-specific tokens the prediction sequence is one longer than the
    input (the task token after [CLS], models/embeddings.py): the labels are
    realigned by an ignore label at that slot."""
    mlm_labels = mlm_labels.long()
    if linguisic_prediction.shape[1] == mlm_labels.shape[1] + 1:
        pad = torch.full_like(mlm_labels[:, :1], -1)
        mlm_labels = torch.cat([mlm_labels[:, :1], pad, mlm_labels[:, 1:]],
                               dim=1)
    logp = F.log_softmax(_f32(linguisic_prediction), dim=-1)
    mask = (mlm_labels >= 0).to(torch.float32)
    safe = torch.clamp_min(mlm_labels, 0)
    per = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def masked_region_loss(vision_prediction, target_dist,
                       region_mask) -> torch.Tensor:
    """Cross-entropy against the detector's class distribution on masked
    regions."""
    logp = F.log_softmax(_f32(vision_prediction), dim=-1)
    mask = _f32(region_mask)
    per = -(_f32(target_dist) * logp).sum(dim=-1)
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Which heads train, with what weight."""

    heads: Sequence[str] = ("vqa",)
    weights: Tuple[float, ...] = ()
    retrieval_group_size: int = 2

    def weight_for(self, i: int) -> float:
        return self.weights[i] if i < len(self.weights) else 1.0


def multitask_loss(cfg: LossConfig, out: ViLBertOutput,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the configured head losses, and ``loss/<head>`` plus
    ``loss/total`` metrics.

    Batch target keys by head: ``vqa``→``vqa_target`` (B, num_labels soft),
    ``gqa``→``gqa_target``, ``binary``→``binary_label`` int, ``tri``→
    ``tri_label`` int, ``grounding``→``grounding_target`` (B, Nv) +
    ``image_mask``, ``retrieval``→ (``vil_logit`` and
    ``cfg.retrieval_group_size``), ``mlm``→``mlm_labels`` int (-1 pad),
    ``mrm``→``mrm_target`` (B, Nv, C) + ``mrm_mask`` (B, Nv).
    """
    metrics: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32,
                        device=out.vil_prediction.device)
    for i, head in enumerate(cfg.heads):
        if head == "vqa":
            loss = label_bce_loss(out.vil_prediction, batch["vqa_target"])
        elif head == "gqa":
            loss = label_bce_loss(out.vil_prediction_gqa, batch["gqa_target"])
        elif head == "binary":
            loss = softmax_ce_loss(out.vil_binary_prediction,
                                   batch["binary_label"])
        elif head == "tri":
            loss = softmax_ce_loss(out.vil_tri_prediction, batch["tri_label"])
        elif head == "grounding":
            loss = grounding_loss(out.vision_logit, batch["grounding_target"],
                                  batch["image_mask"])
        elif head == "retrieval":
            loss = retrieval_contrastive_loss(out.vil_logit,
                                              cfg.retrieval_group_size)
        elif head == "mlm":
            loss = masked_lm_loss(out.linguisic_prediction,
                                  batch["mlm_labels"])
        elif head == "mrm":
            loss = masked_region_loss(out.vision_prediction,
                                      batch["mrm_target"], batch["mrm_mask"])
        else:
            raise ValueError(f"unknown loss head {head!r}")
        metrics[f"loss/{head}"] = loss
        total = total + cfg.weight_for(i) * loss
    metrics["loss/total"] = total
    return total, metrics
