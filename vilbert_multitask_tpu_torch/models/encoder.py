"""Two-stream encoder with interleaved co-attention.

Counterpart of ``vilbert_multitask_tpu/models/encoder.py`` (upstream keys
``bert.encoder.{layer,v_layer,c_layer}.{i}``). The schedule is derived
statically from ``t_biattention_id`` / ``v_biattention_id``: with t ids
(6..11) and v ids (0..5),

    text 0..5 → co-attn 0 → text 6 + vis 0 → co-attn 1 → ... → co-attn 5
    → vis 5 → text 11

i.e. the first six text layers run before the visual stream starts, then each
bridge interleaves one layer per stream, and each stream finishes its tail
after the last bridge.

With ``cfg.remat`` each layer and bridge runs under
``torch.utils.checkpoint`` while gradients are on (the JAX package's
per-layer ``nn.remat``, encoder.py:45-51): its activations are recomputed in
the backward pass instead of kept.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.models.layers import (
    ConnectionLayer,
    TransformerLayer,
)


def rematerialized(fn, *args, generator: Optional[torch.Generator] = None,
                   **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint``.

    The checkpoint restores only torch's default CPU and CUDA generators
    before it recomputes ``fn`` in the backward pass. A dropout drawing from
    ``generator`` (the trainer's own) would otherwise draw new masks there
    and the gradients would belong to another forward, so the recompute
    runs from the generator state the forward started from, and the state
    the forward left is put back after it."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    start = generator.get_state()
    ran = []

    def run(*a, **kw):
        if not ran:  # the forward
            ran.append(True)
            return fn(*a, **kw)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a, **kw)
        finally:
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


class TwoStreamEncoder(nn.Module):
    # The dropout generator (models/layers.py set_dropout_generator), which
    # rematerialization must replay.
    generator: Optional[torch.Generator] = None

    def __init__(self, cfg: ViLBertConfig, ring_v=None):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(
            TransformerLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, cfg.hidden_act,
                cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob,
                cfg.layer_norm_eps, cfg.use_pallas_self_attention)
            for _ in range(cfg.num_hidden_layers))
        self.v_layer = nn.ModuleList(
            TransformerLayer(
                cfg.v_hidden_size, cfg.v_num_attention_heads,
                cfg.v_intermediate_size, cfg.v_hidden_act,
                cfg.v_hidden_dropout_prob, cfg.v_attention_probs_dropout_prob,
                cfg.layer_norm_eps, cfg.use_pallas_self_attention)
            for _ in range(cfg.v_num_hidden_layers))
        self.c_layer = nn.ModuleList(
            ConnectionLayer(
                cfg.hidden_size, cfg.v_hidden_size, cfg.bi_hidden_size,
                cfg.bi_num_attention_heads, cfg.intermediate_size,
                cfg.v_intermediate_size, cfg.hidden_act, cfg.v_hidden_act,
                cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob,
                cfg.layer_norm_eps, cfg.use_pallas_coattention)
            for _ in range(cfg.num_connection_layers))
        # ``ring_v`` (parallel.ring.RingContext) routes the VISUAL stream's
        # self-attention through the ring when it engages (ops/attention.py
        # FusedSelfAttention), as the JAX encoder's ``ring_v`` does.
        for layer in self.v_layer:
            layer.attention.self.ring = ring_v

    def _run(self, layer: nn.Module, *args, **kwargs):
        if self.cfg.remat and torch.is_grad_enabled():
            return rematerialized(layer, *args, generator=self.generator,
                                  **kwargs)
        return layer(*args, **kwargs)

    def forward(self, t_hidden, v_hidden, t_mask_bias, v_mask_bias, *,
                collect_attention: bool = False):
        cfg = self.cfg
        attn_maps: List[Tuple] = []
        t_ptr = v_ptr = 0
        for c_idx, (v_stop, t_stop) in enumerate(
                zip(cfg.v_biattention_id, cfg.t_biattention_id)):
            while t_ptr < t_stop:
                t_hidden, _ = self._run(self.layer[t_ptr], t_hidden,
                                        t_mask_bias)
                t_ptr += 1
            while v_ptr < v_stop:
                v_hidden, _ = self._run(self.v_layer[v_ptr], v_hidden,
                                        v_mask_bias)
                v_ptr += 1
            v_hidden, t_hidden, co_probs = self._run(
                self.c_layer[c_idx], v_hidden, v_mask_bias, t_hidden,
                t_mask_bias, need_probs=collect_attention)
            if collect_attention:
                attn_maps.append(co_probs)
        while v_ptr < cfg.v_num_hidden_layers:
            v_hidden, _ = self._run(self.v_layer[v_ptr], v_hidden,
                                    v_mask_bias)
            v_ptr += 1
        while t_ptr < cfg.num_hidden_layers:
            t_hidden, _ = self._run(self.layer[t_ptr], t_hidden,
                                    t_mask_bias)
            t_ptr += 1
        return t_hidden, v_hidden, attn_maps
