"""Inference engine: bucketed runtime, label store, per-task decoders."""

from vilbert_multitask_tpu_torch.engine.decode import ImageMeta, TaskResult
from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore
from vilbert_multitask_tpu_torch.engine.runtime import (
    InferenceEngine,
    PreparedRequest,
)

__all__ = [
    "ImageMeta",
    "TaskResult",
    "LabelMapStore",
    "InferenceEngine",
    "PreparedRequest",
]
