"""Inference engine: bucketed runtime, kernel-library cache, label store,
per-task decoders."""

from vilbert_multitask_tpu_torch.engine.aotcache import (
    AotCache,
    compile_fingerprint,
)
from vilbert_multitask_tpu_torch.engine.decode import ImageMeta, TaskResult
from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore
from vilbert_multitask_tpu_torch.engine.runtime import (
    InferenceEngine,
    PreparedRequest,
)

__all__ = [
    "AotCache",
    "compile_fingerprint",
    "ImageMeta",
    "TaskResult",
    "LabelMapStore",
    "InferenceEngine",
    "PreparedRequest",
]
