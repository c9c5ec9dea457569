"""The flagship model: two-stream ViLBERT trunk + 9 task heads.

Counterpart of ``vilbert_multitask_tpu/models/vilbert.py``. Reference
capability: ``VILBertForVLTasks`` from the external ``vilbert`` package —
constructed at reference worker.py:530-536, called at worker.py:286-289 —
returning the 10-tuple decoded at worker.py:295-386, here as a typed
:class:`ViLBertOutput`. The module tree carries the upstream key layout, so
``load_state_dict`` takes the reference checkpoint (or
``checkpoint.convert.from_flax_params`` of a JAX tree) with ``strict=True``.

The compute dtype is the dtype the Linear/Embedding weights are held in
(the engine casts them once at load; LayerNorm parameters stay f32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.models.embeddings import (
    ImageEmbeddings,
    TextEmbeddings,
)
from vilbert_multitask_tpu_torch.models.encoder import TwoStreamEncoder
from vilbert_multitask_tpu_torch.models.heads import (
    Pooler,
    PretrainingHeads,
    SimpleClassifier,
    fused_layer_norm,
)
from vilbert_multitask_tpu_torch.models.layers import ACT, compute_dtype
from vilbert_multitask_tpu_torch.ops.attention import mask_to_bias
from vilbert_multitask_tpu_torch.ops.int8_linear import int8_linear


@dataclasses.dataclass
class ViLBertOutput:
    """Typed view of the reference 10-tuple (worker.py:287-289), fields in
    the reference's positional order."""

    vil_prediction: torch.Tensor  # (B, num_labels)        VQA
    vil_prediction_gqa: torch.Tensor  # (B, gqa_num_labels) GQA
    vil_logit: torch.Tensor  # (B, 1)                       retrieval alignment
    vil_binary_prediction: Optional[torch.Tensor]  # (B//2, 2)  NLVR2 pairs
    vil_tri_prediction: torch.Tensor  # (B, 3)              SNLI-VE
    vision_prediction: Optional[torch.Tensor]  # (B, Nv, v_target) masked-region
    vision_logit: torch.Tensor  # (B, Nv, 1)                grounding
    linguisic_prediction: Optional[torch.Tensor]  # (B, Nt', vocab) masked-LM
    linguisic_logit: torch.Tensor  # (B, Nt', 1)            token grounding
    attn_data_list: List[Any]  # per-bridge (text→image, image→text) probs


class ViLBertModel(nn.Module):
    """Trunk (upstream ``bert``): embeddings + two-stream encoder + poolers."""

    def __init__(self, cfg: ViLBertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg)
        self.v_embeddings = ImageEmbeddings(cfg)
        self.encoder = TwoStreamEncoder(cfg)
        self.t_pooler = Pooler(cfg.hidden_size, cfg.bi_hidden_size)
        self.v_pooler = Pooler(cfg.v_hidden_size, cfg.bi_hidden_size)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the dtype the weights are held in (or that
        their int8 form computes in)."""
        return compute_dtype(self.embeddings.word_embeddings)

    def forward(self, input_ids, features, spatials, segment_ids, input_mask,
                image_mask, task_ids=None, *, collect_attention: bool = False):
        t_hidden = self.embeddings(input_ids, segment_ids, task_ids)
        if self.cfg.task_specific_tokens:
            input_mask = TextEmbeddings.extend_mask_for_task_token(input_mask)
        v_hidden = self.v_embeddings(features, spatials)
        t_bias = mask_to_bias(input_mask, self.dtype)
        v_bias = mask_to_bias(image_mask, self.dtype)
        t_seq, v_seq, attn_maps = self.encoder(
            t_hidden, v_hidden, t_bias, v_bias,
            collect_attention=collect_attention)
        pooled_t = self.t_pooler(t_seq)
        pooled_v = self.v_pooler(v_seq)
        return t_seq, v_seq, pooled_t, pooled_v, attn_maps, input_mask


def _fuse(cfg: ViLBertConfig, pooled_t, pooled_v):
    if cfg.fusion_method == "mul":
        return pooled_t * pooled_v
    if cfg.fusion_method == "sum":
        return pooled_t + pooled_v
    raise ValueError(f"unknown fusion_method {cfg.fusion_method}")


class ViLBertForVLTasks(nn.Module):
    """Trunk + all 9 heads; output order matches the reference 10-tuple."""

    def __init__(self, cfg: ViLBertConfig):
        super().__init__()
        self.config = cfg
        self.bert = ViLBertModel(cfg)
        bi = cfg.bi_hidden_size
        eps = cfg.layer_norm_eps
        self.vil_prediction = SimpleClassifier(bi, bi * 2, cfg.num_labels, eps)
        self.vil_prediction_gqa = SimpleClassifier(bi, bi * 2,
                                                   cfg.gqa_num_labels, eps)
        self.vil_binary_prediction = SimpleClassifier(bi * 2, bi * 2, 2, eps)
        self.vil_logit = nn.Linear(bi, 1)
        self.vil_tri_prediction = nn.Linear(bi, 3)
        self.vision_logit = nn.Linear(cfg.v_hidden_size, 1)
        self.linguisic_logit = nn.Linear(cfg.hidden_size, 1)
        self.cls = PretrainingHeads(cfg, self.bert.embeddings.word_embeddings)
        self.head_dropout = nn.Dropout(0.1)

    def trunk(self, input_ids, features, spatials, segment_ids, input_mask,
              image_mask, co_attention_mask=None, task_ids=None, *,
              output_all_attention_masks: bool = False):
        """The trunk alone, for the engine's fused-head path: same
        positional contract as :meth:`forward`, returns the 6-tuple
        ``(t_seq, v_seq, pooled_t, pooled_v, attn_maps, input_mask)``."""
        return self.bert(input_ids, features, spatials, segment_ids,
                         input_mask, image_mask, task_ids,
                         collect_attention=output_all_attention_masks)

    def forward(self, input_ids, features, spatials, segment_ids, input_mask,
                image_mask, co_attention_mask=None, task_ids=None, *,
                output_all_attention_masks: bool = False,
                compute_pretraining_heads: bool = True) -> ViLBertOutput:
        """``co_attention_mask`` is accepted for contract parity (zeros in
        serving). ``compute_pretraining_heads=False`` (the serving default
        of the engine) skips the masked-LM and masked-region decoders."""
        t_seq, v_seq, pooled_t, pooled_v, attn_maps, _ = self.bert(
            input_ids, features, spatials, segment_ids, input_mask,
            image_mask, task_ids,
            collect_attention=output_all_attention_masks)
        pooled = self.head_dropout(_fuse(self.config, pooled_t, pooled_v))

        vil_prediction = self.vil_prediction(pooled)
        vil_prediction_gqa = self.vil_prediction_gqa(pooled)
        vil_logit = self.vil_logit(pooled)
        vil_tri_prediction = self.vil_tri_prediction(pooled)

        # NLVR2: adjacent rows are the image pair for one example
        # (repeat-batching, mirroring reference worker.py:266-276).
        vil_binary_prediction = None
        if pooled.shape[0] % 2 == 0:
            paired = pooled.reshape(pooled.shape[0] // 2, -1)
            vil_binary_prediction = self.vil_binary_prediction(paired)

        # Grounding heads: mask penalty keeps padded regions out of the
        # softmax (the same -10000 fold-in, in the compute dtype).
        vision_logit = self.vision_logit(self.head_dropout(v_seq))
        vision_logit = (vision_logit
                        + mask_to_bias(image_mask,
                                       self.bert.dtype)[:, 0, 0, :, None])
        linguisic_logit = self.linguisic_logit(self.head_dropout(t_seq))

        linguisic_prediction = vision_prediction = None
        if compute_pretraining_heads:
            linguisic_prediction = self.cls.predictions(t_seq)
            vision_prediction = self.cls.imagePredictions(v_seq)

        return ViLBertOutput(
            vil_prediction=vil_prediction,
            vil_prediction_gqa=vil_prediction_gqa,
            vil_logit=vil_logit,
            vil_binary_prediction=vil_binary_prediction,
            vil_tri_prediction=vil_tri_prediction,
            vision_prediction=vision_prediction,
            vision_logit=vision_logit,
            linguisic_prediction=linguisic_prediction,
            linguisic_logit=linguisic_logit,
            attn_data_list=attn_maps,
        )


def _dense(slabs: dict, name: str, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ kernel + bias`` of one slab (flax ``Dense``'s two roundings,
    the product then the bias); an int8 slab runs the int8 GEMM."""
    kernel, bias = slabs[f"{name}_kernel"], slabs[f"{name}_bias"]
    if kernel.dtype == torch.int8:
        return int8_linear(x, kernel, slabs[f"{name}_kernel_scale"], bias)
    return x @ kernel.to(dtype) + bias.to(dtype)


def fused_head_output(cfg: ViLBertConfig, slabs: dict, trunk_out,
                      image_mask, dtype) -> Tuple[ViLBertOutput, torch.Tensor]:
    """All nine serving heads from one trunk pass, as batched slab matmuls.

    ``slabs`` is :func:`..models.heads.build_head_slabs` of the served
    model (:func:`..models.heads.build_int8_head_slabs` in the int8 storage
    mode, whose products run ``ops/int8_linear.py``: the label pair's
    dense1 as one product over both heads' columns, its dense2 as a batch
    of two); ``trunk_out`` is :meth:`ViLBertForVLTasks.trunk`'s 6-tuple.
    Reproduces the per-head numerics (kernels in the compute dtype,
    LayerNorm statistics in f32), so the returned :class:`ViLBertOutput`
    matches the module path to rounding. Also returns the stacked
    ``(B, 2, max_label_width)`` label logits the engine's decode bundle
    gathers from per row by task id.
    """
    t_seq, v_seq, pooled_t, pooled_v, attn_maps, _ = trunk_out
    pooled = _fuse(cfg, pooled_t, pooled_v)
    gelu = ACT["gelu"]
    int8 = slabs["label_d1_kernel"].dtype == torch.int8

    # Wide label pair (VQA + GQA): one batched classifier over a head axis.
    if int8:
        q = slabs["label_d1_kernel"]  # (2, out, in)
        h = int8_linear(pooled, q.reshape(-1, q.shape[-1]),
                        slabs["label_d1_kernel_scale"].reshape(-1),
                        slabs["label_d1_bias"].reshape(-1))
        h = gelu(h.view(pooled.shape[0], 2, -1))
    else:
        h = torch.einsum("bi,kio->bko", pooled,
                         slabs["label_d1_kernel"].to(dtype))
        h = gelu(h + slabs["label_d1_bias"].to(dtype)[None])
    h = fused_layer_norm(h, slabs["label_ln_scale"], slabs["label_ln_bias"],
                         cfg.layer_norm_eps)
    if int8:
        label_logits = int8_linear(
            h.transpose(0, 1), slabs["label_d2_kernel"],
            slabs["label_d2_kernel_scale"],
            slabs["label_d2_bias"]).transpose(0, 1)
    else:
        label_logits = (torch.einsum("bko,kow->bkw", h,
                                     slabs["label_d2_kernel"].to(dtype))
                        + slabs["label_d2_bias"].to(dtype)[None])
    vil_prediction = label_logits[:, 0, : cfg.num_labels]
    vil_prediction_gqa = label_logits[:, 1, : cfg.gqa_num_labels]

    # Tiny pooled heads, concat-fused: columns 0 = vil_logit, 1:4 = tri.
    small = _dense(slabs, "pooled", pooled, dtype)
    vil_logit = small[:, :1]
    vil_tri_prediction = small[:, 1:4]

    # NLVR2 paired head: even batches only.
    vil_binary_prediction = None
    if pooled.shape[0] % 2 == 0:
        paired = pooled.reshape(pooled.shape[0] // 2, -1)
        hb = gelu(_dense(slabs, "binary_d1", paired, dtype))
        hb = fused_layer_norm(hb, slabs["binary_ln_scale"],
                              slabs["binary_ln_bias"], cfg.layer_norm_eps)
        vil_binary_prediction = _dense(slabs, "binary_d2", hb, dtype)

    # Per-token grounding heads, mask penalty folded in as in forward().
    vision_logit = _dense(slabs, "vision", v_seq, dtype)
    vision_logit = vision_logit + mask_to_bias(
        image_mask, dtype)[:, 0, 0, :, None]
    linguisic_logit = _dense(slabs, "ling", t_seq, dtype)

    out = ViLBertOutput(
        vil_prediction=vil_prediction,
        vil_prediction_gqa=vil_prediction_gqa,
        vil_logit=vil_logit,
        vil_binary_prediction=vil_binary_prediction,
        vil_tri_prediction=vil_tri_prediction,
        vision_prediction=None,
        vision_logit=vision_logit,
        linguisic_prediction=None,
        linguisic_logit=linguisic_logit,
        attn_data_list=attn_maps,
    )
    return out, label_logits
