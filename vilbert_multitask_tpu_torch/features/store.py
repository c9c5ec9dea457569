"""Precomputed region-feature store.

Per BASELINE.json, the GPU Faster R-CNN in the serving loop (reference
worker.py:59-223) is replaced by a precomputed-feature loader. Two formats:

1. The reference ``.npy`` schema — a pickled dict per image with keys
   ``image_id, features[N,2048], bbox[N,4], num_boxes, objects, cls_prob,
   image_width, image_height`` (written at reference worker.py:209-216) —
   so feature dumps produced by the reference tooling drop straight in.
2. A packed little-endian binary format (``.vlfr``) with a fixed header,
   read here with plain numpy.

The store is keyed the way the reference keys features: by image-file
basename without extension (worker.py:210-211).
"""

from __future__ import annotations

import os
import struct
from collections import OrderedDict
from typing import Iterable

import numpy as np

from vilbert_multitask_tpu_torch.features.pipeline import RegionFeatures

_VLFR_MAGIC = b"VLFR\x01"


def load_reference_npy(path: str) -> RegionFeatures:
    """Read one image's features in the reference ``.npy`` dict schema."""
    raw = np.load(path, allow_pickle=True).item()
    cls_prob = np.asarray(raw.get("cls_prob", ()), np.float32)
    return RegionFeatures(
        features=np.asarray(raw["features"], np.float32),
        boxes=np.asarray(raw["bbox"], np.float32),
        image_width=int(raw["image_width"]),
        image_height=int(raw["image_height"]),
        num_boxes=int(raw.get("num_boxes", len(raw["features"]))),
        cls_prob=cls_prob if cls_prob.size else None,
    )


def save_reference_npy(path: str, region: RegionFeatures, image_id: str,
                       objects: np.ndarray | None = None,
                       cls_prob: np.ndarray | None = None) -> None:
    """Write the reference schema (what the offline extractor emits)."""
    info = {
        "image_id": image_id,
        "features": np.asarray(region.features, np.float32),
        "bbox": np.asarray(region.boxes, np.float32),
        "num_boxes": int(region.num_boxes),
        "image_width": int(region.image_width),
        "image_height": int(region.image_height),
        "objects": objects if objects is not None else np.zeros((0,), np.int64),
        "cls_prob": (cls_prob if cls_prob is not None
                     else region.cls_prob if region.cls_prob is not None
                     else np.zeros((0, 0), np.float32)),
    }
    np.save(path, info)


def save_vlfr(path: str, region: RegionFeatures) -> None:
    """Packed binary: header(magic, n, d, w, h) + f32 features + f32 boxes.

    The format carries the SERVING fields only — ``cls_prob`` (the MRM
    pretraining target) is dropped; a pretraining run against a .vlfr
    store falls back to uniform targets, so warn when it's discarded here.
    """
    if region.cls_prob is not None:
        import logging

        logging.getLogger(__name__).warning(
            ".vlfr stores no cls_prob: %s loses the detector class "
            "distribution — MRM pretraining against this store will use "
            "uniform targets (keep the .npy for pretraining data)", path)
    feats = np.ascontiguousarray(region.features, dtype="<f4")
    boxes = np.ascontiguousarray(region.boxes, dtype="<f4")
    n, d = feats.shape
    with open(path, "wb") as f:
        f.write(_VLFR_MAGIC)
        f.write(struct.pack("<IIII", n, d, int(region.image_width),
                            int(region.image_height)))
        f.write(feats.tobytes())
        f.write(boxes.tobytes())


def load_vlfr(path: str) -> RegionFeatures:
    with open(path, "rb") as f:
        magic = f.read(5)
        if magic != _VLFR_MAGIC:
            raise ValueError(f"{path}: not a VLFR file")
        n, d, w, h = struct.unpack("<IIII", f.read(16))
        feats = np.frombuffer(f.read(n * d * 4), dtype="<f4").reshape(n, d)
        boxes = np.frombuffer(f.read(n * 4 * 4), dtype="<f4").reshape(n, 4)
    return RegionFeatures(features=feats.copy(), boxes=boxes.copy(),
                          image_width=w, image_height=h, num_boxes=n)


def image_key(image_path: str) -> str:
    """Image path → store key (basename sans extension, worker.py:210-211)."""
    return os.path.basename(image_path).split(".")[0]


def file_identity(path: str) -> str:
    """Content-stable cache identity for a file: path + mtime + size."""
    st = os.stat(path)
    return f"{path}:{st.st_mtime_ns}:{st.st_size}"


class FeatureStore:
    """Directory-backed feature store with an LRU cache.

    Fixes a reference inefficiency while keeping its contract: the reference
    re-reads label pickles and feature data per request (SURVEY.md §2.4);
    here repeated images hit the in-memory LRU.
    """

    def __init__(self, root: str, max_cached: int = 256):
        self.root = root
        self.max_cached = max_cached
        self._cache: "OrderedDict[str, RegionFeatures]" = OrderedDict()

    def path_for(self, key: str) -> str:
        for ext, loader in ((".npy", load_reference_npy), (".vlfr", load_vlfr)):
            p = os.path.join(self.root, key + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"no feature file for key '{key}' under {self.root} (.npy/.vlfr)"
        )

    def identity(self, image_path: str) -> str:
        """Content-stable identity for this image's features: resolved file
        path + mtime + size (what :meth:`fetch` returns beside them)."""
        return file_identity(self.path_for(image_key(image_path)))

    def fetch(self, image_path: str) -> tuple[RegionFeatures, str]:
        """(features, content identity) — the identity is captured BEFORE
        the read, so a file replaced mid-request can at worst bind an OLD
        key to NEW content (which the next request's fresh stat misses and
        re-reads), never a new key to stale content."""
        path = self.path_for(image_key(image_path))
        key = file_identity(path)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key], key
        if path.endswith(".npy"):
            region = load_reference_npy(path)
        else:
            region = load_vlfr(path)
        self._cache[key] = region
        if len(self._cache) > self.max_cached:
            self._cache.popitem(last=False)
        return region, key

    def get(self, image_path: str) -> RegionFeatures:
        return self.fetch(image_path)[0]

    def get_batch(self, image_paths: Iterable[str]) -> list[RegionFeatures]:
        return [self.get(p) for p in image_paths]
