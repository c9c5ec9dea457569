"""Image preprocessing, region selection, and the offline feature CLI.

Counterpart of ``vilbert_multitask_tpu/features/extract.py``; reproduces the
reference's post-processing (SURVEY.md §7 hard part (b)):

- :func:`preprocess_image` (worker.py:91-121): scale so the short side
  targets 800 px without the long side passing 1333, bilinear resize, RGB→BGR,
  per-channel mean subtraction. The JAX package resizes with PIL on the host;
  here the resize runs in torch on the image's device (``F.interpolate``,
  bilinear with antialiasing, the filter PIL applies), in PIL's two passes
  (horizontal, then vertical), each rounded half up and clamped to uint8
  levels as PIL's are. It differs from PIL's by at most one level at a
  pixel, where PIL's fixed-point filter weights round otherwise
  (tests/test_torch_detect.py records how often).
- :func:`select_regions`: per-class NMS@0.5 over the class scores + top-100
  by max surviving confidence (worker.py:123-176), through
  :func:`..ops.nms.select_top_regions`: the NMS kernel on a CUDA tensor,
  the plain version on the CPU. Nothing copies 300 × 1601 scores to the
  host to select on it.
- :func:`extract_one` / :func:`main`: one ``.npz`` detector dump (``boxes
  (N,4)``, ``cls_scores (N,C)``, ``features (N,D)``, ``image_width``,
  ``image_height``) → one feature file in the reference ``.npy`` schema or
  the packed ``.vlfr`` format.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vilbert_multitask_tpu_torch.features.pipeline import RegionFeatures
from vilbert_multitask_tpu_torch.features.store import (
    save_reference_npy,
    save_vlfr,
)
from vilbert_multitask_tpu_torch.ops.nms import select_top_regions

# Per-channel BGR means the reference subtracts (maskrcnn PIXEL_MEAN
# convention driven from worker.py:102-107).
BGR_PIXEL_MEANS = np.array([102.9801, 115.9465, 122.7717], np.float32)


def preprocess_image(image: Union[np.ndarray, torch.Tensor],
                     min_size: int = 800, max_size: int = 1333,
                     ) -> Tuple[torch.Tensor, float]:
    """(H, W, 3) RGB uint8 (numpy, or a tensor on any device) → ((h, w, 3)
    BGR float32 mean-subtracted resized tensor on the image's device,
    scale)."""
    img = torch.as_tensor(image)
    if img.dim() != 3 or img.shape[2] != 3 or img.dtype != torch.uint8:
        raise ValueError(f"preprocess_image takes an (H, W, 3) uint8 RGB "
                         f"image, got {tuple(img.shape)} {img.dtype}")
    h, w = img.shape[:2]
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    x = img.permute(2, 0, 1)[None].float()
    # PIL's two passes, horizontal first, each rounded half up to uint8.
    for size, changed in (((h, new_w), new_w != w),
                          ((new_h, new_w), new_h != h)):
        if changed:
            x = F.interpolate(x, size=size, mode="bilinear", antialias=True,
                              align_corners=False)
            x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    means = torch.from_numpy(BGR_PIXEL_MEANS).to(x.device)
    bgr = x[0].flip(0).permute(1, 2, 0) - means
    return bgr, scale


def select_regions(boxes: np.ndarray, cls_scores: np.ndarray,
                   num_keep: int = 100, iou_threshold: float = 0.5,
                   device: str = "cuda"):
    """:func:`..ops.nms.select_top_regions` of numpy arrays, run on
    ``device`` (the kernel on the card, the plain version on the CPU);
    the results come back as numpy."""
    dev = torch.device(device)
    out = select_top_regions(
        torch.from_numpy(np.asarray(boxes, np.float32)).to(dev),
        torch.from_numpy(np.asarray(cls_scores, np.float32)).to(dev),
        num_keep=num_keep, iou_threshold=iou_threshold)
    return tuple(x.cpu().numpy() for x in out)


def extract_one(raw_path: str, out_dir: str, fmt: str = "npy",
                num_keep: int = 100, iou_threshold: float = 0.5,
                device: str = "cuda") -> str:
    """One ``.npz`` detector dump → one feature file (the selection runs on
    ``device``). Returns the out path."""
    raw = np.load(raw_path)
    boxes = np.asarray(raw["boxes"], np.float32)
    cls_scores = np.asarray(raw["cls_scores"], np.float32)
    features = np.asarray(raw["features"], np.float32)
    w, h = int(raw["image_width"]), int(raw["image_height"])

    keep, num_valid, _conf, objects, _max_conf = select_regions(
        boxes, cls_scores, num_keep=num_keep, iou_threshold=iou_threshold,
        device=device)
    n = int(min(num_valid, len(keep))) or 1  # at least one region
    keep = keep[:n]
    region = RegionFeatures(
        features=features[keep], boxes=boxes[keep],
        image_width=w, image_height=h, num_boxes=n)

    key = os.path.splitext(os.path.basename(raw_path))[0]
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{key}.{fmt}")
    if fmt == "npy":
        # cls_prob = the FULL per-region class distribution rows (reference
        # schema; also the MRM pretraining target).
        save_reference_npy(out_path, region, key, objects=objects[:n],
                           cls_prob=cls_scores[keep])
    elif fmt == "vlfr":
        save_vlfr(out_path, region)
    else:
        raise ValueError(f"unknown format {fmt!r} (npy|vlfr)")
    return out_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="offline feature extraction")
    p.add_argument("--raw", required=True,
                   help="detector-dump .npz file, directory, or glob")
    p.add_argument("--out", required=True, help="output feature directory")
    p.add_argument("--format", default="npy", choices=("npy", "vlfr"))
    p.add_argument("--num-keep", type=int, default=100)
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the selection runs (cuda raises without a "
                        "card)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")

    if os.path.isdir(args.raw):
        paths = sorted(glob.glob(os.path.join(args.raw, "*.npz")))
    elif any(ch in args.raw for ch in "*?["):
        paths = sorted(glob.glob(args.raw))
    else:
        paths = [args.raw]
    for path in paths:
        print(extract_one(path, args.out, args.format, args.num_keep,
                          args.iou_threshold, args.device))


if __name__ == "__main__":
    main()
