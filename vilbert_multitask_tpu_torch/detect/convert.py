"""Detector weights → this package's :class:`..detect.model.FasterRCNN`.

Counterpart of ``vilbert_multitask_tpu/detect/convert.py``, with the same
declarative name map (this package's copy of ``build_name_map``) between the
module tree's keys — the Flax tree's paths — and the torchvision-style keys
of a maskrcnn_benchmark checkpoint (``backbone.body.layer{n}``,
``backbone.fpn.fpn_inner{n}``, ``rpn.head``, ``roi_heads.box``):

- :func:`from_flax_params` carries a JAX-package parameter tree (numpy in,
  numpy out): a Flax conv kernel (kH, kW, I, O) becomes a torch weight
  (O, I, kH, kW), a Dense kernel (in, out) becomes (out, in), FrozenBN
  ``scale``/``bias`` and biases pass through;
- :func:`load_torch_detector` reads a maskrcnn ``.pth``
  (``torch.load(weights_only=True)``, the ``"model"`` wrapper unwrapped,
  ``module.`` stripped) and folds each FrozenBatchNorm (weight, bias,
  running mean, running var) into the affine ``scale = w / sqrt(var +
  1e-5)``, ``bias = b - mean * scale`` (:func:`fold_bn`). Every mapped key
  must exist; unknown keys are reported, as the JAX loader does.

The box head's fc6 reads the pooled (R, res, res, C) features flattened row
by row, as the JAX model does; maskrcnn's box head flattens (R, C, res,
res). So :func:`load_torch_detector` permutes ``fc6.weight``'s input columns
from maskrcnn's order into this one, and :func:`from_flax_params` (whose
kernel is already in this order) does not. The JAX package's own loader
transposes fc6 without that permutation (ROADMAP C).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np
import torch

from vilbert_multitask_tpu_torch.config import DetectorConfig

BN_EPS = 1e-5
Arr = np.ndarray
# (flax path, kind, torch prefix); kind: conv, conv_bias, bn, linear.
Entry = Tuple[Tuple[str, ...], str, str]


def fold_bn(weight: Arr, bias: Arr, mean: Arr, var: Arr,
            eps: float = BN_EPS) -> Tuple[Arr, Arr]:
    """FrozenBatchNorm (w, b, μ, σ²) → affine (scale, bias)."""
    scale = weight / np.sqrt(var + eps)
    return scale, bias - mean * scale


def build_name_map(cfg: DetectorConfig) -> List[Entry]:
    entries: List[Entry] = []
    B = ("backbone",)
    entries.append((B + ("stem_conv",), "conv", "backbone.body.stem.conv1"))
    entries.append((B + ("stem_bn",), "bn", "backbone.body.stem.bn1"))
    for stage, blocks in enumerate(cfg.stage_blocks):
        for b in range(blocks):
            fx = B + (f"stage{stage + 2}_block{b}",)
            tp = f"backbone.body.layer{stage + 1}.{b}"
            for i in (1, 2, 3):
                entries.append((fx + (f"conv{i}",), "conv", f"{tp}.conv{i}"))
                entries.append((fx + (f"bn{i}",), "bn", f"{tp}.bn{i}"))
            if b == 0:  # projection shortcut (stride or width change)
                entries.append((fx + ("downsample",), "conv",
                                f"{tp}.downsample.0"))
                entries.append((fx + ("downsample_bn",), "bn",
                                f"{tp}.downsample.1"))
    for i in range(4):  # FPN levels 2..5
        entries.append((("fpn", f"lateral{i + 2}"), "conv_bias",
                        f"backbone.fpn.fpn_inner{i + 1}"))
        entries.append((("fpn", f"output{i + 2}"), "conv_bias",
                        f"backbone.fpn.fpn_layer{i + 1}"))
    entries.append((("rpn", "conv"), "conv_bias", "rpn.head.conv"))
    entries.append((("rpn", "objectness"), "conv_bias",
                    "rpn.head.cls_logits"))
    entries.append((("rpn", "deltas"), "conv_bias", "rpn.head.bbox_pred"))
    entries.append((("fc6",), "linear", "roi_heads.box.feature_extractor.fc6"))
    entries.append((("fc7",), "linear", "roi_heads.box.feature_extractor.fc7"))
    entries.append((("cls_score",), "linear",
                    "roi_heads.box.predictor.cls_score"))
    return entries


def _get_path(tree: Dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def from_flax_params(params: Dict, cfg: DetectorConfig) -> Dict[str, Arr]:
    """Nested Flax param dict (numpy-valued) of the JAX ``FasterRCNN`` →
    this package's state dict (numpy arrays), loadable with
    ``load_state_dict(strict=True)``."""
    out: Dict[str, Arr] = {}
    for path, kind, _ in build_name_map(cfg):
        key = ".".join(path)
        node = _get_path(params, path)
        if kind == "bn":
            out[f"{key}.scale"] = np.asarray(node["scale"])
            out[f"{key}.bias"] = np.asarray(node["bias"])
            continue
        kernel = np.asarray(node["kernel"])
        out[f"{key}.weight"] = np.ascontiguousarray(
            kernel.T if kind == "linear" else kernel.transpose(3, 2, 0, 1))
        if kind != "conv":
            out[f"{key}.bias"] = np.asarray(node["bias"])
    return out


def fc6_from_maskrcnn(weight: Arr, cfg: DetectorConfig) -> Arr:
    """maskrcnn's fc6 weight (D, C·res·res), inputs in (C, res, res) order
    → the same weight with its inputs in this model's (res, res, C)
    order."""
    res, c = cfg.roi_resolution, cfg.fpn_channels
    d = weight.shape[0]
    return np.ascontiguousarray(
        weight.reshape(d, c, res, res).transpose(0, 2, 3, 1).reshape(d, -1))


def convert_maskrcnn_state_dict(sd: Dict[str, Arr], cfg: DetectorConfig
                                ) -> Dict[str, Arr]:
    """A maskrcnn-layout state dict (numpy) → this package's state dict:
    FrozenBN folded, fc6's inputs reordered. Raises ``KeyError`` when a
    mapped key is missing; logs the keys nothing consumed (the box
    predictor's ``bbox_pred`` is expected among them: the extractor uses
    proposals, class scores and fc6)."""
    out: Dict[str, Arr] = {}
    used, missing = set(), []
    for path, kind, prefix in build_name_map(cfg):
        key = ".".join(path)
        if kind == "bn":
            names = [f"{prefix}.{s}" for s in
                     ("weight", "bias", "running_mean", "running_var")]
        elif kind == "conv":
            names = [f"{prefix}.weight"]
        else:
            names = [f"{prefix}.weight", f"{prefix}.bias"]
        if any(n not in sd for n in names):
            missing += [n for n in names if n not in sd]
            continue
        used.update(names)
        vals = [np.asarray(sd[n]) for n in names]
        if kind == "bn":
            out[f"{key}.scale"], out[f"{key}.bias"] = fold_bn(*vals)
            continue
        weight = vals[0]
        if path == ("fc6",):
            weight = fc6_from_maskrcnn(weight, cfg)
        out[f"{key}.weight"] = weight
        if kind != "conv":
            out[f"{key}.bias"] = vals[1]
    if missing:
        raise KeyError(f"detector checkpoint lacks {len(missing)} mapped "
                       f"keys, e.g. {missing[:3]}")
    extra = set(sd) - used
    unknown = {k for k in extra
               if not (k.startswith("roi_heads") and "bbox_pred" in k)}
    if unknown:
        logging.getLogger(__name__).warning(
            "detector checkpoint has %d unconsumed keys (e.g. %s)",
            len(unknown), sorted(unknown)[:3])
    return out


def load_torch_detector(path: str, cfg: DetectorConfig) -> Dict[str, Arr]:
    """``torch.load`` a maskrcnn detector ``.pth`` (CPU-mapped, as the
    reference loads it, worker.py:83) and convert it."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:  # maskrcnn ckpt wrapper
        raw = raw["model"]
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          v.numpy() for k, v in raw.items()}
    return convert_maskrcnn_state_dict(sd, cfg)
