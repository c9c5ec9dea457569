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
- :func:`build_head_slabs` (:func:`build_int8_head_slabs` in the int8
  storage mode) / :func:`fused_layer_norm`: the weights side and the
  LayerNorm of the fused decode-head program (models/vilbert.py:
  fused_head_output).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from vilbert_multitask_tpu_torch import quant
from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.models.layers import ACT, LayerNorm
from vilbert_multitask_tpu_torch.ops.int8_linear import padded_rows

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


# Upstream-key prefixes of the served heads: what the fused slabs stack.
SERVED_HEADS = ("vil_prediction.", "vil_prediction_gqa.",
                "vil_binary_prediction.", "vil_logit.", "vil_tri_prediction.",
                "vision_logit.", "linguisic_logit.")


def stack_head_slabs(w: Callable[[str], torch.Tensor], cfg: ViLBertConfig
                     ) -> Dict[str, torch.Tensor]:
    """Stack the serving heads' weights into the batched slabs of the fused
    decode-head program; ``w(key)`` gives the tensor at an upstream key.

    - the two wide label classifiers (VQA / GQA) stack on a leading head
      axis; their dense2 kernels zero-pad to the wider label count and the
      padded bias columns carry :data:`PAD_LOGIT_BIAS`;
    - the two tiny pooled heads (vil_logit, vil_tri_prediction) concat into
      one (bi, 4) kernel — independent output columns;
    - the paired NLVR2 classifier and the grounding heads keep their own.

    Kernels are ``(in, out)`` like the JAX package's, in the dtype ``w``
    gives them; built once per weight load, outside any forward.
    """
    wmax = max(cfg.num_labels, cfg.gqa_num_labels)

    def kernel(lin):
        return w(f"{lin}.weight").t()

    def padded(lin):
        k, b = kernel(lin), w(f"{lin}.bias")
        pad = wmax - b.shape[-1]
        return (torch.nn.functional.pad(k, (0, pad)),
                torch.nn.functional.pad(b, (0, pad), value=PAD_LOGIT_BIAS))

    def pair(key):
        return torch.stack([w(f"vil_prediction.{key}"),
                            w(f"vil_prediction_gqa.{key}")])

    with torch.no_grad():
        k_vqa, b_vqa = padded("vil_prediction.logit_fc.3")
        k_gqa, b_gqa = padded("vil_prediction_gqa.logit_fc.3")
        slabs = {
            "label_d1_kernel": torch.stack([
                kernel("vil_prediction.logit_fc.0"),
                kernel("vil_prediction_gqa.logit_fc.0")]),
            "label_d1_bias": pair("logit_fc.0.bias"),
            "label_ln_scale": pair("logit_fc.2.weight"),
            "label_ln_bias": pair("logit_fc.2.bias"),
            "label_d2_kernel": torch.stack([k_vqa, k_gqa]),
            "label_d2_bias": torch.stack([b_vqa, b_gqa]),
            "pooled_kernel": torch.cat([kernel("vil_logit"),
                                        kernel("vil_tri_prediction")],
                                       dim=-1),
            "pooled_bias": torch.cat([w("vil_logit.bias"),
                                      w("vil_tri_prediction.bias")]),
            "binary_d1_kernel": kernel("vil_binary_prediction.logit_fc.0"),
            "binary_d1_bias": w("vil_binary_prediction.logit_fc.0.bias"),
            "binary_ln_scale": w("vil_binary_prediction.logit_fc.2.weight"),
            "binary_ln_bias": w("vil_binary_prediction.logit_fc.2.bias"),
            "binary_d2_kernel": kernel("vil_binary_prediction.logit_fc.3"),
            "binary_d2_bias": w("vil_binary_prediction.logit_fc.3.bias"),
            "vision_kernel": kernel("vision_logit"),
            "vision_bias": w("vision_logit.bias"),
            "ling_kernel": kernel("linguisic_logit"),
            "ling_bias": w("linguisic_logit.bias"),
        }
        return {k: v.detach().contiguous().clone() for k, v in slabs.items()}


def build_head_slabs(model: nn.Module, cfg: ViLBertConfig
                     ) -> Dict[str, torch.Tensor]:
    """:func:`stack_head_slabs` of a (floating) ``ViLBertForVLTasks``: the
    kernels in the dtype the modules hold them (the engine's compute
    dtype), the LayerNorm leaves in theirs (f32)."""
    return stack_head_slabs(model.state_dict().__getitem__, cfg)


def build_int8_head_slabs(params: Dict, cfg: ViLBertConfig,
                          dtype: torch.dtype, device
                          ) -> Dict[str, torch.Tensor]:
    """The int8 slabs, as the JAX engine builds them
    (``_make_head_slab_builder``, engine/runtime.py:476-500): the served
    heads' already-quantized leaves of ``params`` (an upstream-key tree of
    ``{"int8", "scale"}`` pairs) dequantized to f32, stacked by
    :func:`stack_head_slabs`, and every ``*_kernel`` slab quantized again
    over its last axis, so a stacked ``(2, in, out)`` slab has one scale
    per output column shared by both heads (a column that is zero in both
    gets 1.0). The JAX engine builds them under ``jax.jit``, so they are
    quantized with its arithmetic there (``jit_arithmetic``).

    Each kernel slab is stored for ``ops/int8_linear.py``: int8 in torch's
    ``(..., out, in)`` layout in rows padded to 16 bytes, with its scale
    under ``<name>_scale`` repeated over the leading head axis. Biases are
    in ``dtype`` (the compute dtype), LayerNorm leaves f32. Everything is
    built on the host and placed on ``device``."""
    f32 = quant.dequantize_tree(
        {k: quant.leaf_to(v, "cpu") for k, v in params.items()
         if k.startswith(SERVED_HEADS)}, torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for name, v in stack_head_slabs(f32.__getitem__, cfg).items():
        if name.endswith("_kernel"):
            pair = quant.quantize_leaf(v, -1, jit_arithmetic=True)
            q = pair[quant.QVALUES].transpose(-1, -2)
            scale = pair[quant.QSCALE].expand(*q.shape[:-1])
            out[name] = padded_rows(q.to(device))
            out[name + "_scale"] = scale.contiguous().to(device)
        elif name.endswith("_bias"):
            out[name] = v.to(device, dtype)
        else:
            out[name] = v.to(device)
    return out


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
