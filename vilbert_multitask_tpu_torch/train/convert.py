"""A JAX train state carried into this package's :class:`..step.TrainState`.

The numpy trees of an optax ``TrainState`` (its parameters and the
``ScaleByAdamState``'s ``mu`` and ``nu``) go through the same name map as
the parameters (``checkpoint.convert.from_flax_params``): the moments are
parameter-shaped trees, so each is transposed and split (the fused ``qkv``
into three Linear layers) exactly as its parameter is. A run of the JAX
package can then go on here, and a test can start both sides from one
state.
"""

from __future__ import annotations

from typing import Dict

import torch

from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.config import ViLBertConfig
from vilbert_multitask_tpu_torch.train.step import TrainState

# The tied MLM decoder: a second key of the word-embedding parameter.
TIED = "cls.predictions.decoder.weight"


def from_jax_train_state(step: int, params: Dict, mu: Dict, nu: Dict,
                         cfg: ViLBertConfig) -> TrainState:
    """A host :class:`TrainState` (no generator: the JAX dropout stream has
    no counterpart) from the numpy trees of a JAX train state at ``step``;
    ``..step.load_train_state`` copies it into a model-bound state."""
    def tree(t: Dict) -> Dict[str, torch.Tensor]:
        sd = from_flax_params(t, cfg)
        sd.pop(TIED)
        return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}

    return TrainState(step=int(step), params=tree(params), mu=tree(mu),
                      nu=tree(nu))
