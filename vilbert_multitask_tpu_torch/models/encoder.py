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
"""

from __future__ import annotations

from typing import List, Tuple

from torch import nn

from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.models.layers import (
    ConnectionLayer,
    TransformerLayer,
)


class TwoStreamEncoder(nn.Module):
    def __init__(self, cfg: ViLBertConfig):
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

    def forward(self, t_hidden, v_hidden, t_mask_bias, v_mask_bias, *,
                collect_attention: bool = False):
        cfg = self.cfg
        attn_maps: List[Tuple] = []
        t_ptr = v_ptr = 0
        for c_idx, (v_stop, t_stop) in enumerate(
                zip(cfg.v_biattention_id, cfg.t_biattention_id)):
            while t_ptr < t_stop:
                t_hidden, _ = self.layer[t_ptr](t_hidden, t_mask_bias)
                t_ptr += 1
            while v_ptr < v_stop:
                v_hidden, _ = self.v_layer[v_ptr](v_hidden, v_mask_bias)
                v_ptr += 1
            v_hidden, t_hidden, co_probs = self.c_layer[c_idx](
                v_hidden, v_mask_bias, t_hidden, t_mask_bias,
                need_probs=collect_attention)
            if collect_attention:
                attn_maps.append(co_probs)
        while v_ptr < cfg.v_num_hidden_layers:
            v_hidden, _ = self.v_layer[v_ptr](v_hidden, v_mask_bias)
            v_ptr += 1
        while t_ptr < cfg.num_hidden_layers:
            t_hidden, _ = self.layer[t_ptr](t_hidden, t_mask_bias)
            t_ptr += 1
        return t_hidden, v_hidden, attn_maps
