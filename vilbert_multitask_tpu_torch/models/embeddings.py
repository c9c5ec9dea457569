"""Input embeddings for both streams.

Counterpart of ``vilbert_multitask_tpu/models/embeddings.py`` (upstream keys
``bert.embeddings.*`` and ``bert.v_embeddings.*``):

- text = word + position + token-type embeddings, then (with
  ``task_specific_tokens=True``, reference worker.py:485,516-517) the task
  token embedding is inserted **after [CLS]**, extending the sequence by one;
  the position ids span the N tokens BEFORE the insertion, so the task token
  carries no position embedding. LayerNorm + dropout after insertion.
- image = linear(2048 fc6 feature) + linear(5-dim normalized box geometry),
  summed, LayerNorm + dropout.
"""

from __future__ import annotations

import torch
from torch import nn

from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.models.layers import (
    LayerNorm,
    compute_dtype,
)


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: ViLBertConfig):
        super().__init__()
        self.task_specific_tokens = cfg.task_specific_tokens
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        if cfg.task_specific_tokens:
            self.task_embeddings = nn.Embedding(cfg.num_task_tokens,
                                                cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, task_ids=None):
        n = input_ids.shape[1]
        positions = torch.arange(n, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)
             + self.token_type_embeddings(token_type_ids))
        if self.task_specific_tokens:
            if task_ids is None:
                raise ValueError("task_specific_tokens=True requires task_ids")
            task = self.task_embeddings(task_ids)  # (B, 1, H)
            # Insert after [CLS]: [cls, task, rest...] → sequence length N+1.
            x = torch.cat([x[:, :1], task, x[:, 1:]], dim=1)
        return self.dropout(self.LayerNorm(x))

    @staticmethod
    def extend_mask_for_task_token(mask: torch.Tensor) -> torch.Tensor:
        """Extend a (B, N) attention mask to (B, N+1) for the inserted task
        token (always attended)."""
        ones = torch.ones_like(mask[:, :1])
        return torch.cat([mask[:, :1], ones, mask[:, 1:]], dim=1)


class ImageEmbeddings(nn.Module):
    def __init__(self, cfg: ViLBertConfig):
        super().__init__()
        self.image_embeddings = nn.Linear(cfg.v_feature_size,
                                          cfg.v_hidden_size)
        self.image_location_embeddings = nn.Linear(5, cfg.v_hidden_size)
        self.LayerNorm = LayerNorm(cfg.v_hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.v_hidden_dropout_prob)

    def forward(self, features, spatials):
        """features: (B, Nv, v_feature_size); spatials: (B, Nv, 5). Both are
        cast to the compute dtype (the weights' dtype) first."""
        dt = compute_dtype(self.image_embeddings)
        feat = self.image_embeddings(features.to(dt))
        loc = self.image_location_embeddings(spatials.to(dt))
        return self.dropout(self.LayerNorm(feat + loc))
