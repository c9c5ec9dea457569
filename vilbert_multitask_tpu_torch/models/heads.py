"""Poolers and the nine task heads.

Counterpart of ``vilbert_multitask_tpu/models/heads.py``. Output contract =
the 10-tuple unpacked at reference worker.py:287-289. Head topologies (and
their upstream keys):

- poolers (``bert.{t,v}_pooler.dense``) take the first token of each stream
  through a Linear + ReLU into the shared ``bi_hidden`` space;
- ``SimpleClassifier`` = Linear → GELU → LayerNorm → Linear, upstream
  ``{head}.logit_fc.{0,2,3}``;
- the masked-modeling heads (``cls.predictions`` with its decoder tied to
  the word-embedding table, ``cls.imagePredictions``);
- :func:`build_head_slabs` / :func:`fused_layer_norm`: the weights side and
  the LayerNorm of the fused decode-head program (models/vilbert.py:
  fused_head_output).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.models.layers import ACT, LayerNorm

# Logit floor written into the padded dense2 bias columns of the stacked
# label slab: padded columns come out at exactly this value, which
# underflows to probability 0 in the f32 softmax — so top-k over the padded
# width matches top-k over each head's real width.
PAD_LOGIT_BIAS = -1e9


class Pooler(nn.Module):
    """First-token pooler into the bi_hidden space (ReLU, per ViLBERT)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.dense = nn.Linear(in_dim, out_dim)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.dense(hidden[:, 0]))


class SimpleClassifier(nn.Module):
    """Linear → GELU → LayerNorm → Linear (12-in-1 classifier topology)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 layer_norm_eps: float = 1e-12):
        super().__init__()
        self.logit_fc = nn.Sequential(
            nn.Linear(in_dim, hidden_dim), nn.GELU(),
            LayerNorm(hidden_dim, eps=layer_norm_eps),
            nn.Linear(hidden_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logit_fc(x)


class PredictionTransform(nn.Module):
    def __init__(self, hidden: int, activation: str, eps: float):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)
        self.act = ACT[activation]
        self.LayerNorm = LayerNorm(hidden, eps=eps)

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class TextPredictionHead(nn.Module):
    """Masked-LM head: transform + decoder tied to the word embeddings."""

    def __init__(self, cfg: ViLBertConfig, word_embeddings: nn.Embedding):
        super().__init__()
        self.transform = PredictionTransform(cfg.hidden_size, cfg.hidden_act,
                                             cfg.layer_norm_eps)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.decoder.weight = word_embeddings.weight
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden):
        logits = self.decoder(self.transform(hidden))
        return logits + self.bias.to(logits.dtype)


class ImagePredictionHead(nn.Module):
    """Masked-region head: transform + decoder onto v_target_size classes."""

    def __init__(self, cfg: ViLBertConfig):
        super().__init__()
        self.transform = PredictionTransform(cfg.v_hidden_size,
                                             cfg.v_hidden_act,
                                             cfg.layer_norm_eps)
        self.decoder = nn.Linear(cfg.v_hidden_size, cfg.v_target_size)

    def forward(self, hidden):
        return self.decoder(self.transform(hidden))


class PretrainingHeads(nn.Module):
    """Upstream ``cls``: ``predictions`` (text) and ``imagePredictions``."""

    def __init__(self, cfg: ViLBertConfig, word_embeddings: nn.Embedding):
        super().__init__()
        self.predictions = TextPredictionHead(cfg, word_embeddings)
        self.imagePredictions = ImagePredictionHead(cfg)


def build_head_slabs(model: nn.Module, cfg: ViLBertConfig
                     ) -> Dict[str, torch.Tensor]:
    """Stack the serving heads' weights of a ``ViLBertForVLTasks`` into the
    batched slabs of the fused decode-head program.

    - the two wide label classifiers (VQA / GQA) stack on a leading head
      axis; their dense2 kernels zero-pad to the wider label count and the
      padded bias columns carry :data:`PAD_LOGIT_BIAS`;
    - the two tiny pooled heads (vil_logit, vil_tri_prediction) concat into
      one (bi, 4) kernel — independent output columns;
    - the paired NLVR2 classifier and the grounding heads keep their own.

    Kernels are ``(in, out)`` like the JAX package's, in the dtype the
    module holds them (the engine's compute dtype); the LayerNorm leaves
    keep theirs (f32). Built once per weight load, outside any forward.
    """
    wmax = max(cfg.num_labels, cfg.gqa_num_labels)

    def fc(head):
        lin1, _, norm, lin2 = head.logit_fc
        return lin1, norm, lin2

    def padded(lin2):
        k, b = lin2.weight.t(), lin2.bias
        pad = wmax - b.shape[-1]
        return (torch.nn.functional.pad(k, (0, pad)),
                torch.nn.functional.pad(b, (0, pad), value=PAD_LOGIT_BIAS))

    with torch.no_grad():
        v1, vn, v2 = fc(model.vil_prediction)
        g1, gn, g2 = fc(model.vil_prediction_gqa)
        b1, bn, b2 = fc(model.vil_binary_prediction)
        k_vqa, b_vqa = padded(v2)
        k_gqa, b_gqa = padded(g2)
        slabs = {
            "label_d1_kernel": torch.stack([v1.weight.t(), g1.weight.t()]),
            "label_d1_bias": torch.stack([v1.bias, g1.bias]),
            "label_ln_scale": torch.stack([vn.weight, gn.weight]),
            "label_ln_bias": torch.stack([vn.bias, gn.bias]),
            "label_d2_kernel": torch.stack([k_vqa, k_gqa]),
            "label_d2_bias": torch.stack([b_vqa, b_gqa]),
            "pooled_kernel": torch.cat([model.vil_logit.weight.t(),
                                        model.vil_tri_prediction.weight.t()],
                                       dim=-1),
            "pooled_bias": torch.cat([model.vil_logit.bias,
                                      model.vil_tri_prediction.bias]),
            "binary_d1_kernel": b1.weight.t(),
            "binary_d1_bias": b1.bias,
            "binary_ln_scale": bn.weight,
            "binary_ln_bias": bn.bias,
            "binary_d2_kernel": b2.weight.t(),
            "binary_d2_bias": b2.bias,
            "vision_kernel": model.vision_logit.weight.t(),
            "vision_bias": model.vision_logit.bias,
            "ling_kernel": model.linguisic_logit.weight.t(),
            "ling_bias": model.linguisic_logit.bias,
        }
        return {k: v.detach().contiguous().clone() for k, v in slabs.items()}


def fused_layer_norm(h, scale, bias, eps: float):
    """LayerNorm with flax ``nn.LayerNorm`` numerics: statistics in f32 (or
    f64 for f64 input; ``var = max(0, E[x²] − E[x]²)``), scale folded into
    the rsqrt, result cast back to the input dtype."""
    dt = h.dtype
    st = torch.promote_types(dt, torch.float32)
    x = h.to(st)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          0.0)
    mul = torch.rsqrt(var + eps) * scale.to(st)
    return ((x - mean) * mul + bias.to(st)).to(dt)
