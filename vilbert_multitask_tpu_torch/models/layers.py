"""Transformer building blocks for both streams.

Counterpart of ``vilbert_multitask_tpu/models/layers.py``: post-LayerNorm
BERT layers, the exact-erf GELU feed-forward and the co-attention bridge.
The module tree follows the upstream torch key layout (the external
``vilbert`` package the reference loads), so ``state_dict()`` keys are the
reference checkpoint's own:

- ``encoder.layer.{i}`` / ``encoder.v_layer.{i}``: ``attention.self.
  {query,key,value}``, ``attention.output.{dense,LayerNorm}``,
  ``intermediate.dense``, ``output.{dense,LayerNorm}``;
- ``encoder.c_layer.{i}``: ``biattention.{query,key,value}{1,2}``,
  ``biOutput.{dense1,LayerNorm1,dense2,LayerNorm2}``,
  ``{v,t}_intermediate.dense``, ``{v,t}_output.{dense,LayerNorm}``.

Upstream bridge direction: the ``*1`` projections act on the VISUAL stream
and the ``*2`` projections on TEXT; ``dense1``/``LayerNorm1`` close the
visual residual, ``dense2``/``LayerNorm2`` the text residual.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vilbert_multitask_tpu_torch.ops import layer_norm as ln_ops
from vilbert_multitask_tpu_torch.ops.attention import (
    FusedSelfAttention,
    cross_attention,
    dropout,
)

# Exact (erf) GELU: the BERT/ViLBERT family is trained with the exact form.
ACT = {
    "gelu": F.gelu,
    "relu": F.relu,
    "swish": F.silu,
}


def compute_dtype(module: nn.Module) -> torch.dtype:
    """The dtype a Linear or Embedding computes in: its weight's, or the
    compute dtype of its int8 form (models/int8.py)."""
    dt = getattr(module, "compute_dtype", None)
    return dt if dt is not None else module.weight.dtype


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose masks come from ``generator`` when one is set
    (:func:`set_dropout_generator`: the trainer's own generator, saved in
    its train state, so a resumed run draws the masks an uninterrupted run
    would), from torch's default generator otherwise."""

    generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.training, self.generator)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Give every dropout of ``model`` (the :class:`Dropout` modules, the
    attention-probability dropouts and the encoder's rematerialization)
    ``generator``; ``None`` returns them to the default generator."""
    for mod in model.modules():
        if hasattr(type(mod), "generator"):
            mod.generator = generator


class LayerNorm(nn.LayerNorm):
    """LayerNorm of ``x + residual`` (or of ``x``) with flax
    ``nn.LayerNorm(dtype=...)`` numerics: the sum in the inputs' promoted
    dtype, statistics (``var = max(0, E[s²] − E[s]²)``) and the affine
    step at ``promote(dtype, float32)`` with the parameters at that
    precision, the result in the sum's dtype (``ops/layer_norm.py``: one
    kernel launch on the card for an inference call; a call autograd
    records takes ``F.layer_norm``). The engine keeps LayerNorm parameters
    in f32 under a bf16 compute dtype, as the JAX package does."""

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ln_ops.layer_norm(x, residual, self.weight, self.bias,
                                 self.eps)


class AttentionOutput(nn.Module):
    """Projection + dropout + residual + LayerNorm after an attention block
    (upstream ``BertSelfOutput``; also the feed-forward's ``output``)."""

    def __init__(self, in_size: int, hidden_size: int,
                 dropout_rate: float = 0.1, layer_norm_eps: float = 1e-12):
        super().__init__()
        self.dense = nn.Linear(in_size, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.dropout = Dropout(dropout_rate)

    def forward(self, context: torch.Tensor, residual: torch.Tensor
                ) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(context)), residual)


class Intermediate(nn.Module):
    """The feed-forward's expanding half (upstream ``BertIntermediate``)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation: str = "gelu"):
        super().__init__()
        self.dense = nn.Linear(hidden_size, intermediate_size)
        self.act = ACT[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


def feed_forward(x: torch.Tensor, intermediate: Intermediate,
                 output: AttentionOutput) -> torch.Tensor:
    """BERT FFN: expand → activation → contract → dropout → residual → LN
    (the JAX package's ``FeedForward``; upstream keeps its two halves as
    sibling modules, so here it is a function over them)."""
    return output(intermediate(x), x)


class SelfAttentionBlock(nn.Module):
    """Upstream ``BertAttention``: ``self`` (the projections and the
    attention) and ``output``."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attention_dropout: float, hidden_dropout: float,
                 layer_norm_eps: float, use_pallas: bool):
        super().__init__()
        self.self = FusedSelfAttention(hidden_size, num_heads,
                                       attention_dropout, use_pallas)
        self.output = AttentionOutput(hidden_size, hidden_size,
                                      hidden_dropout, layer_norm_eps)

    def forward(self, x, mask_bias):
        ctx, probs = self.self(x, mask_bias)
        return self.output(ctx, x), probs


class TransformerLayer(nn.Module):
    """One single-stream encoder layer (text or visual)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, activation: str = "gelu",
                 hidden_dropout: float = 0.1, attention_dropout: float = 0.1,
                 layer_norm_eps: float = 1e-12, use_pallas: bool = False):
        super().__init__()
        self.attention = SelfAttentionBlock(
            hidden_size, num_heads, attention_dropout, hidden_dropout,
            layer_norm_eps, use_pallas)
        self.intermediate = Intermediate(hidden_size, intermediate_size,
                                         activation)
        self.output = AttentionOutput(intermediate_size, hidden_size,
                                      hidden_dropout, layer_norm_eps)

    def forward(self, x, mask_bias
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x, probs = self.attention(x, mask_bias)
        return feed_forward(x, self.intermediate, self.output), probs


class BiAttention(nn.Module):
    """The two co-attention directions' projections (upstream
    ``biattention``): ``*1`` on the visual stream, ``*2`` on text."""

    generator: Optional[torch.Generator] = None  # set_dropout_generator

    def __init__(self, v_hidden_size: int, hidden_size: int,
                 bi_hidden_size: int, num_heads: int,
                 dropout_rate: float = 0.1, use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.use_pallas = use_pallas
        self.query1 = nn.Linear(v_hidden_size, bi_hidden_size)
        self.key1 = nn.Linear(v_hidden_size, bi_hidden_size)
        self.value1 = nn.Linear(v_hidden_size, bi_hidden_size)
        self.query2 = nn.Linear(hidden_size, bi_hidden_size)
        self.key2 = nn.Linear(hidden_size, bi_hidden_size)
        self.value2 = nn.Linear(hidden_size, bi_hidden_size)

    def forward(self, v_hidden, v_mask_bias, t_hidden, t_mask_bias,
                need_probs: bool):
        kw = dict(num_heads=self.num_heads, use_pallas=self.use_pallas,
                  need_probs=need_probs, dropout_rate=self.dropout_rate,
                  training=self.training, generator=self.generator)
        # Text queries over image keys/values → feeds the TEXT stream.
        t_ctx, probs_t2v = cross_attention(
            t_hidden, v_hidden, v_mask_bias,
            self.query2, self.key1, self.value1, **kw)
        # Image queries over text keys/values → feeds the IMAGE stream.
        v_ctx, probs_v2t = cross_attention(
            v_hidden, t_hidden, t_mask_bias,
            self.query1, self.key2, self.value2, **kw)
        return t_ctx, v_ctx, (probs_t2v, probs_v2t)


class BiOutput(nn.Module):
    """Upstream ``biOutput``: dense1/LayerNorm1 close the visual residual,
    dense2/LayerNorm2 the text residual."""

    def __init__(self, bi_hidden_size: int, v_hidden_size: int,
                 hidden_size: int, dropout_rate: float = 0.1,
                 layer_norm_eps: float = 1e-12):
        super().__init__()
        self.dense1 = nn.Linear(bi_hidden_size, v_hidden_size)
        self.LayerNorm1 = LayerNorm(v_hidden_size, eps=layer_norm_eps)
        self.dense2 = nn.Linear(bi_hidden_size, hidden_size)
        self.LayerNorm2 = LayerNorm(hidden_size, eps=layer_norm_eps)
        self.dropout = Dropout(dropout_rate)

    def forward(self, v_ctx, v_residual, t_ctx, t_residual):
        v = self.LayerNorm1(self.dropout(self.dense1(v_ctx)), v_residual)
        t = self.LayerNorm2(self.dropout(self.dense2(t_ctx)), t_residual)
        return v, t


class ConnectionLayer(nn.Module):
    """Co-attention bridge between the streams (the "connect" in
    ``bert_base_6layer_6conect``): both cross-attention directions, each
    followed by its output projection + residual + LN + FFN."""

    def __init__(self, hidden_size: int, v_hidden_size: int,
                 bi_hidden_size: int, bi_num_heads: int,
                 intermediate_size: int, v_intermediate_size: int,
                 activation: str = "gelu", v_activation: str = "gelu",
                 hidden_dropout: float = 0.1, attention_dropout: float = 0.1,
                 layer_norm_eps: float = 1e-12, use_pallas: bool = False):
        super().__init__()
        self.biattention = BiAttention(v_hidden_size, hidden_size,
                                       bi_hidden_size, bi_num_heads,
                                       attention_dropout, use_pallas)
        self.biOutput = BiOutput(bi_hidden_size, v_hidden_size, hidden_size,
                                 hidden_dropout, layer_norm_eps)
        self.v_intermediate = Intermediate(v_hidden_size,
                                           v_intermediate_size, v_activation)
        self.v_output = AttentionOutput(v_intermediate_size, v_hidden_size,
                                        hidden_dropout, layer_norm_eps)
        self.t_intermediate = Intermediate(hidden_size, intermediate_size,
                                           activation)
        self.t_output = AttentionOutput(intermediate_size, hidden_size,
                                        hidden_dropout, layer_norm_eps)

    def forward(self, v_hidden, v_mask_bias, t_hidden, t_mask_bias,
                need_probs: bool = True):
        t_ctx, v_ctx, probs = self.biattention(
            v_hidden, v_mask_bias, t_hidden, t_mask_bias, need_probs)
        v_hidden, t_hidden = self.biOutput(v_ctx, v_hidden, t_ctx, t_hidden)
        v_hidden = feed_forward(v_hidden, self.v_intermediate, self.v_output)
        t_hidden = feed_forward(t_hidden, self.t_intermediate, self.t_output)
        return v_hidden, t_hidden, probs
