"""Training: the multi-task losses, the train step with its AdamW update,
the data and the loop (the port of the JAX package's ``train/``, on one
device; ``shard_train_state`` waits for the port's parallelism)."""

from vilbert_multitask_tpu_torch.train.losses import (
    LossConfig,
    grounding_loss,
    label_bce_loss,
    masked_lm_loss,
    masked_region_loss,
    multitask_loss,
    retrieval_contrastive_loss,
    softmax_ce_loss,
)
from vilbert_multitask_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_train_step,
)

__all__ = [
    "LossConfig",
    "TrainState",
    "create_train_state",
    "grounding_loss",
    "label_bce_loss",
    "make_train_step",
    "masked_lm_loss",
    "masked_region_loss",
    "multitask_loss",
    "retrieval_contrastive_loss",
    "softmax_ce_loss",
]
