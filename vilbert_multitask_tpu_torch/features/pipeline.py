"""Host-side region-feature preprocessing: detector output → fixed-shape
batch buffers.

Reference capability: the image half of ``custom_prediction`` (reference
worker.py:421-455):

- mean-pool the region features into a global feature and prepend it
  (worker.py:432-434);
- 5-dim spatial encoding per box: [x1/w, y1/h, x2/w, y2/h, area_fraction]
  with the global box [0, 0, 1, 1, 1] prepended (worker.py:436-444);
- image mask 1 per real region (worker.py:445);
- co-attention mask is all zeros at serving time (worker.py:455).

Divergence kept from the JAX package: buffers are padded to a static
``max_regions`` (101 = 100 detector boxes + global, reference
worker.py:71,433) so every request has the same shapes; the reference instead
shipped whatever dynamic shape the detector produced.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class RegionFeatures:
    """One image's detector output (the `.npy` schema fields that matter,
    reference worker.py:209-216).

    ``cls_prob`` (the detector's per-region class distribution, also in the
    reference schema) is optional — serving never reads it, but the
    masked-region pretraining objective uses it as the soft target
    (train/losses.py masked_region_loss)."""

    features: np.ndarray  # (num_boxes, feat_dim) fc6 features
    boxes: np.ndarray  # (num_boxes, 4) absolute xyxy pixel coords
    image_width: int
    image_height: int
    num_boxes: int | None = None  # defaults to features.shape[0]
    cls_prob: np.ndarray | None = None  # (num_boxes, n_classes) detector dist

    def __post_init__(self):
        if self.num_boxes is None:
            self.num_boxes = int(self.features.shape[0])


@dataclasses.dataclass
class EncodedImage:
    """Fixed-shape buffers for one image, ready to batch."""

    features: np.ndarray  # (max_regions, feat_dim) f32
    spatials: np.ndarray  # (max_regions, 5) f32
    image_mask: np.ndarray  # (max_regions,) i32


def build_spatials(boxes: np.ndarray, image_w: float, image_h: float) -> np.ndarray:
    """(N, 4) absolute xyxy → (N, 5) normalized [x1, y1, x2, y2, area_frac]."""
    out = np.zeros((boxes.shape[0], 5), np.float32)
    out[:, 0] = boxes[:, 0] / image_w
    out[:, 1] = boxes[:, 1] / image_h
    out[:, 2] = boxes[:, 2] / image_w
    out[:, 3] = boxes[:, 3] / image_h
    out[:, 4] = (
        (boxes[:, 3] - boxes[:, 1]) * (boxes[:, 2] - boxes[:, 0])
    ) / (image_w * image_h)
    return out


GLOBAL_BOX = np.array([0.0, 0.0, 1.0, 1.0, 1.0], np.float32)


def encode_image(region: RegionFeatures, max_regions: int = 101) -> EncodedImage:
    """Prepend global feature + pad to ``max_regions``."""
    n = int(region.num_boxes)
    feats = np.asarray(region.features[:n], np.float32)
    if n + 1 > max_regions:
        raise ValueError(f"{n} boxes + global exceeds max_regions={max_regions}")

    g_feat = feats.sum(axis=0, keepdims=True) / max(n, 1)
    spatials = build_spatials(np.asarray(region.boxes[:n], np.float32),
                              float(region.image_width), float(region.image_height))

    feat_dim = feats.shape[1]
    out_feats = np.zeros((max_regions, feat_dim), np.float32)
    out_feats[0] = g_feat
    out_feats[1 : n + 1] = feats
    out_spatials = np.zeros((max_regions, 5), np.float32)
    out_spatials[0] = GLOBAL_BOX
    out_spatials[1 : n + 1] = spatials
    mask = np.zeros((max_regions,), np.int32)
    mask[: n + 1] = 1
    return EncodedImage(out_feats, out_spatials, mask)


def clip_regions(regions: Sequence[RegionFeatures],
                 max_regions: int,
                 num_features: Optional[int] = None) -> list[RegionFeatures]:
    """Clip over-provisioned region sets to the budget (``max_regions`` - 1
    detector rows + the global row, tightened by ``num_features`` when the
    operator wants fewer boxes than the padded shape admits). Stores are
    confidence-ordered, so the clip keeps the top boxes. The ONE clip
    implementation — serving (engine.prepare) and training (train/loop)
    both use it, so a new per-region field only needs slicing here."""
    budget = max_regions - 1
    if num_features is not None:
        budget = min(budget, num_features)
    return [
        dataclasses.replace(
            r, features=r.features[:budget], boxes=r.boxes[:budget],
            num_boxes=min(r.num_boxes, budget),
            cls_prob=r.cls_prob[:budget] if r.cls_prob is not None else None)
        if r.num_boxes > budget else r
        for r in regions
    ]


def batch_images(
    images: Sequence[EncodedImage], pad_to: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-image buffers into (B, ...) arrays, optionally padding the
    batch dimension to a shape bucket (engine shape-bucket discipline)."""
    B = len(images)
    n = pad_to or B
    if n < B:
        raise ValueError(f"pad_to={pad_to} smaller than batch {B}")
    feat_dim = images[0].features.shape[-1]
    max_regions = images[0].features.shape[0]
    feats = np.zeros((n, max_regions, feat_dim), np.float32)
    spatials = np.zeros((n, max_regions, 5), np.float32)
    masks = np.zeros((n, max_regions), np.int32)
    for i, img in enumerate(images):
        feats[i] = img.features
        spatials[i] = img.spatials
        masks[i] = img.image_mask
    # Padded batch rows keep a single attended global region so softmaxes
    # stay well-defined; results for pad rows are discarded at decode.
    for i in range(B, n):
        masks[i, 0] = 1
        spatials[i, 0] = GLOBAL_BOX
    return feats, spatials, masks


def synthetic_regions(v_feature_size: int, *, n_boxes: int = 100,
                      rng=None, seed: int = 0,
                      image_w: int = 640, image_h: int = 480
                      ) -> RegionFeatures:
    """Plausibly-shaped random regions (x2>x1/y2>y1 boxes anchored inside
    the canvas — they may overhang the right/bottom edge, like loose
    detector output — N(0,1) features) for benches, smokes, and demos:
    the shared synthetic-input generator (bench round-robin, onboarding
    smoke). Not a source of normalized-spatial guarantees."""
    rng = rng or np.random.default_rng(seed)
    x1 = rng.random((n_boxes,)) * (image_w - 32)
    y1 = rng.random((n_boxes,)) * (image_h - 32)
    boxes = np.stack(
        [x1, y1, x1 + 16 + rng.random(n_boxes) * (image_w / 4),
         y1 + 16 + rng.random(n_boxes) * (image_h / 4)],
        axis=1).astype(np.float32)
    feats = rng.normal(size=(n_boxes, v_feature_size)).astype(np.float32)
    return RegionFeatures(feats, boxes, image_w, image_h)
