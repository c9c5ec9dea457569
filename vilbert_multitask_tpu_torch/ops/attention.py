"""Attention primitives shared by both streams and the co-attention bridge.

Counterpart of ``vilbert_multitask_tpu/ops/attention.py``, with the same
numerics and the same kernel gates:

- the additive mask bias is made in the compute dtype (``(1 - mask) *
  -10000``, so -9984 in bf16), as the JAX package makes it;
- the dense path's scale, mask bias and softmax (at ``promote(dtype,
  float32)``) are ``ops/softmax.py``: one kernel launch on the card for an
  inference call, the plain torch composition for a call autograd
  records;
- self-attention takes the flash kernel when ``use_pallas``, there is no
  dropout and ``head_dim % 128 == 0``; a bridge direction takes it when
  ``use_pallas``, no probabilities are needed and there is no dropout;
- any other attention with no dropout and no probabilities asked takes
  the dense core as one kernel (``ops/dense_attention.py``) when it is a
  bf16 call autograd does not record with ``head_dim % 16 == 0`` and at
  most 128, and at most 128 keys (every served text self-attention); the
  rest (f32, collected bridge maps, longer text, a recorded call) runs
  :func:`multi_head_attention`: an einsum, the softmax's kernel, an
  einsum.

The module tree keeps the upstream torch key layout (``attention.self.
{query,key,value}``), so the reference's checkpoint loads unchanged. The
JAX package's ``CrossAttention`` module owns its projections; here the
upstream layout puts all six bridge projections on one ``biattention``
module (models/layers.py), so the bridge direction is the function
:func:`cross_attention` over projections it is handed.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from vilbert_multitask_tpu_torch.ops import dense_attention as dense_ops
from vilbert_multitask_tpu_torch.ops import softmax as softmax_ops
from vilbert_multitask_tpu_torch.ops.coattention import flash_cross_attention
from vilbert_multitask_tpu_torch.ops.routes import records_gradient


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, N) {0,1} mask → (B, 1, 1, N) additive bias in ``dtype``.

    The BERT-family -10000 penalty rather than -inf, so bf16 softmax stays
    finite. The product is taken in ``dtype``, as in the JAX package.
    """
    bias = (1.0 - mask.to(dtype)) * -10000.0
    return bias[:, None, None, :]


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)`` in x's dtype (flax ``nn.Dropout``'s form).
    The mask comes from ``generator`` when one is given (it must live on
    x's device), from torch's default generator otherwise. Three launches:
    the draw, the mask product and the scale."""
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return (x * keep).div_(1.0 - p)


@functools.lru_cache(maxsize=None)
def _inv_sqrt(depth: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(depth)`` rounded as the JAX package computes it, in
    ``dtype`` (a host scalar: no device traffic per call)."""
    return torch.tensor(depth, dtype=dtype).sqrt().reciprocal().item()


def multi_head_attention(
    q: torch.Tensor,  # (B, Nq, H, D)
    k: torch.Tensor,  # (B, Nk, H, D)
    v: torch.Tensor,  # (B, Nk, H, D)
    bias: Optional[torch.Tensor],  # broadcastable to (B, H, Nq, Nk)
    *,
    dropout_rate: float = 0.0,
    training: bool = False,
    dtype=torch.float32,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense attention. Returns (context (B, Nq, H, D), probs (B, H, Nq, Nk))."""
    # In ``dtype``, as the JAX einsum's preferred_element_type (no launch
    # when q is already in it, as on every path of the model).
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(dtype)
    probs = softmax_ops.attention_probs(scores, bias,
                                        _inv_sqrt(q.shape[-1], dtype))
    dropped = dropout(probs, dropout_rate, training, generator)
    context = torch.einsum("bhqk,bkhd->bqhd", dropped, v)
    return context, probs


def cross_attention(
    x: torch.Tensor,  # (B, Nq, Dx) queries' stream
    y: torch.Tensor,  # (B, Nk, Dy) keys' and values' stream
    y_mask_bias: torch.Tensor,  # (B, 1, 1, Nk)
    query: nn.Linear,
    key: nn.Linear,
    value: nn.Linear,
    *,
    num_heads: int,
    use_pallas: bool,
    need_probs: bool,
    dropout_rate: float = 0.0,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One co-attention direction: queries from ``x``, keys/values from
    ``y``. Returns (context (B, Nq, bi_hidden), probs or None)."""
    q, k, v = query(x), key(y), value(y)
    B, Nq, hidden = q.shape
    Nk = k.shape[1]
    head_dim = hidden // num_heads
    q = q.view(B, Nq, num_heads, head_dim)
    k = k.view(B, Nk, num_heads, head_dim)
    v = v.view(B, Nk, num_heads, head_dim)
    use_dropout = training and dropout_rate > 0.0
    if use_pallas and not need_probs and not use_dropout:
        ctx = flash_cross_attention(q, k, v, y_mask_bias)
        return ctx.reshape(B, Nq, hidden), None
    # The dense core as one kernel: a gate by shape and type, as the flash
    # kernel's; the kernel has no backward, so a recorded call keeps the
    # composition below.
    if (not need_probs and not use_dropout
            and dense_ops.fits(head_dim, Nk, q.dtype)
            and not records_gradient(q, k, v, y_mask_bias)):
        return dense_ops.dense_attention(
            q, k, v, y_mask_bias, _inv_sqrt(head_dim, q.dtype)), None
    ctx, probs = multi_head_attention(q, k, v, y_mask_bias,
                                      dropout_rate=dropout_rate,
                                      training=training, dtype=q.dtype,
                                      generator=generator)
    return ctx.reshape(B, Nq, hidden), probs


class FusedSelfAttention(nn.Module):
    """BERT self-attention (upstream keys ``query``/``key``/``value``).

    The JAX package fuses the three projections into one ``qkv`` kernel;
    here they stay three ``Linear`` layers, so each projection's output is
    contiguous and its ``(B, N, H, D)`` view goes to the kernel as it is.

    The route is the JAX package's: the ring (``ring``, a
    ``parallel.ring.RingContext``, set on the visual stream of a model
    built with ``ring_v``) when it engages at this sequence length and
    there is no dropout; then the flash kernel when ``use_pallas``, no
    dropout and ``head_dim % 128 == 0``; then dense (one kernel where
    :func:`cross_attention`'s gate lets it). Under tensor
    parallelism (parallel/tp.py) the projections hold this rank's heads
    and ``num_heads`` counts them; ``head_dim`` does not change.
    """

    # The probabilities' dropout generator (models/layers.py
    # set_dropout_generator); None draws from torch's default one.
    generator: Optional[torch.Generator] = None
    # parallel.ring.RingContext, or None (dense / kernel only).
    ring = None

    def __init__(self, hidden_size: int, num_heads: int,
                 dropout_rate: float = 0.1, use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.dropout_rate = dropout_rate
        self.use_pallas = use_pallas
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        use_dropout = self.training and self.dropout_rate > 0.0
        if (self.ring is not None and not use_dropout
                and self.ring.engages(x.shape[1])):
            from vilbert_multitask_tpu_torch.parallel.ring import (
                ring_self_attention,
            )

            shape = (*x.shape[:-1], self.num_heads, self.head_dim)
            q, k, v = (proj(x).view(shape)
                       for proj in (self.query, self.key, self.value))
            # Accumulate at >= f32, as the dense softmax does.
            ctx = ring_self_attention(
                self.ring, q, k, v, mask_bias,
                dtype=torch.promote_types(q.dtype, torch.float32))
            return ctx.to(q.dtype).reshape(*x.shape[:-1], -1), None
        # Self-attention probs are never surfaced (the reference's
        # attn_data_list carries only the bridge maps), so dropout and the
        # head width alone gate the flash kernel; a head_dim that fails the
        # % 128 gate (the text stream's 64) takes the dense core's kernel
        # when bf16, % 16 and at most 128 keys (cross_attention).
        return cross_attention(
            x, x, mask_bias, self.query, self.key, self.value,
            num_heads=self.num_heads,
            use_pallas=self.use_pallas and self.head_dim % 128 == 0,
            need_probs=False, dropout_rate=self.dropout_rate,
            training=self.training, generator=self.generator)
