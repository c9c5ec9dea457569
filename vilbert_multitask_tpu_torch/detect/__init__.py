"""Live region-feature extraction: the port's Faster R-CNN.

Counterpart of ``vilbert_multitask_tpu/detect/`` (reference capability:
``FeatureExtractor``, reference worker.py:59-223, which drives the
maskrcnn_benchmark X-152-32x8d-FPN C++/CUDA stack). Serving defaults to
precomputed features; this package serves the upload→answer flow for images
with no precomputed ``.npy``.
"""

from vilbert_multitask_tpu_torch.detect.extractor import (  # noqa: F401
    FallbackFeatureStore,
    LiveFeatureExtractor,
)
from vilbert_multitask_tpu_torch.detect.model import FasterRCNN  # noqa: F401
