"""Live feature extraction + the serving fallback for novel uploads.

Counterpart of ``vilbert_multitask_tpu/detect/extractor.py``. Reference
capability: ``FeatureExtractor.extract_features`` (reference
worker.py:218-223) — every request ran the detector live. Precomputed
features stay the default; live extraction serves every image that has no
precomputed file, so the demo's upload→answer flow works end to end:

    upload → media/demo/x.png → job → FeatureStore miss →
    LiveFeatureExtractor (preprocess → FasterRCNN → select_top_regions) →
    RegionFeatures → ViLBERT forward → answer

On the card the whole extraction runs on the device: the resize, the
detector (cuDNN convolutions, the hand-written NMS and ROIAlign kernels),
and the per-class selection; only the kept rows come back to the host.

Each stage is an ``obs`` span: ``detect.decode`` (PIL), ``detect.preprocess``,
``detect.enqueue`` (the host's enqueue of the detector's forward, with
its device time from events on the extractor's stream, ``device_ms``;
the model's own ``detect.backbone`` / ``fpn`` / ``rpn`` / ``roi_align`` /
``box_head`` inside it), ``detect.select`` and ``detect.host_copy``.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.config import DetectorConfig
from vilbert_multitask_tpu_torch.detect.model import (
    FasterRCNN,
    init_state_dict,
)
from vilbert_multitask_tpu_torch.features.extract import preprocess_image
from vilbert_multitask_tpu_torch.features.pipeline import RegionFeatures
from vilbert_multitask_tpu_torch.features.store import file_identity
from vilbert_multitask_tpu_torch.ops.nms import select_top_regions
from vilbert_multitask_tpu_torch.utils import contained_path

# cuDNN's TF32 switch is process-wide: extractors that set it differently
# must not run their convolutions at the same time. (The trunk has no
# convolutions, and its matmuls keep their own precision setting.)
_CONV_FLAGS_LOCK = threading.Lock()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("LiveFeatureExtractor(device='cuda') but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class LiveFeatureExtractor:
    """One detector per process: image file/array → RegionFeatures.

    ``params`` is a state dict in this package's keys
    (:func:`..detect.convert.from_flax_params` or
    :func:`..detect.convert.load_torch_detector`); without one the weights
    are drawn from ``seed`` (:func:`..detect.model.init_state_dict`).

    Precision: f32 weights and activations, as the JAX extractor's. On the
    card cuDNN would run f32 convolutions in TF32 by default; this
    extractor sets ``allow_tf32`` (default False: full f32) around its own
    forward only, and leaves matmul precision alone.

    One lock serialises the extractor's forwards (replicas of a serving
    pool share one extractor). On the card each forward runs on the
    extractor's own stream, and only that stream is waited on, once, before
    the kept rows are read on the host."""

    def __init__(self, cfg: Optional[DetectorConfig] = None, *,
                 params: Optional[Dict] = None, seed: int = 0,
                 num_keep: int = 100, device="cuda",
                 allow_tf32: bool = False):
        self.cfg = cfg or DetectorConfig()
        self.num_keep = num_keep
        self.device = _device(device)
        self.allow_tf32 = allow_tf32
        if params is None:
            params = init_state_dict(self.cfg, seed)
        sd = {k: torch.as_tensor(np.asarray(v, np.float32))
              if not torch.is_tensor(v) else v.float()
              for k, v in params.items()}
        model = FasterRCNN(self.cfg)
        model.load_state_dict(sd, strict=True)
        self.model = model.to(self.device,
                               memory_format=torch.channels_last).eval()
        self._lock = threading.Lock()
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            torch.cuda.current_stream(self.device).synchronize()

    @contextlib.contextmanager
    def _context(self):
        """Inference mode; on the card also the extractor's stream and its
        cuDNN flags."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            if self._stream is not None:
                stack.enter_context(_CONV_FLAGS_LOCK)
                stack.enter_context(torch.cuda.stream(self._stream))
                stack.enter_context(torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=False,
                    allow_tf32=self.allow_tf32))
            yield

    def forward(self, bgr: torch.Tensor, image_hw) -> tuple:
        """The detector on one preprocessed (h, w, 3) image, padded to the
        canvas: (proposals, cls, fc6) on the device, unsynchronised. The
        caller holds the context (:meth:`extract_array` does)."""
        canvas = self.cfg.canvas
        padded = torch.zeros((canvas, canvas, 3), dtype=torch.float32,
                             device=self.device)
        padded[:bgr.shape[0], :bgr.shape[1]] = bgr
        return self.model(padded, image_hw)

    def warmup(self) -> None:
        """One forward on a blank canvas: cuDNN's plans, the kernels'
        builds and the anchors are made before the first upload."""
        canvas = self.cfg.canvas
        with self._lock, self._context():
            blank = torch.zeros((canvas, canvas, 3), dtype=torch.float32,
                                device=self.device)
            out = self.model(blank, (canvas, canvas))
            select_top_regions(out[0], out[1], num_keep=self.num_keep)
            if self._stream is not None:
                self._stream.synchronize()

    # ----------------------------------------------------------- extraction
    def extract_array(self, rgb: np.ndarray) -> RegionFeatures:
        """(H, W, 3) RGB uint8 → RegionFeatures in original pixel coords."""
        h, w = rgb.shape[:2]
        # Reference preprocessing contract, scaled to fit the fixed canvas.
        canvas = self.cfg.canvas
        max_size = min(1333, canvas)
        min_size = min(800, max_size)
        with self._lock, self._context():
            with obs.span("detect.preprocess"):
                image = torch.from_numpy(np.require(
                    rgb, np.uint8, ("C_CONTIGUOUS", "WRITEABLE"))).to(
                        self.device)
                bgr, scale = preprocess_image(image, min_size=min_size,
                                              max_size=max_size)
            with obs.span("detect.enqueue") as enqueue:
                events = None
                if enqueue.recording and self._stream is not None:
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record(self._stream)
                boxes, cls_scores, feats = self.forward(
                    bgr, (bgr.shape[0], bgr.shape[1]))
                if events is not None:
                    events[1].record(self._stream)
            with obs.span("detect.select"):
                keep, num_valid, _conf, _obj, _top = select_top_regions(
                    boxes, cls_scores, num_keep=self.num_keep)
            with obs.span("detect.host_copy"):
                rows = [num_valid.reshape(1).to(torch.float32), boxes[keep],
                        feats[keep], cls_scores[keep]]
                host = [torch.empty(r.shape, dtype=r.dtype,
                                    pin_memory=self._stream is not None)
                        for r in rows]
                for dst, src in zip(host, rows):
                    dst.copy_(src, non_blocking=True)
                if self._stream is not None:
                    self._stream.synchronize()
            if events is not None:
                enqueue.set(device_ms=events[0].elapsed_time(events[1]))
        n_valid, kept_boxes, kept_feats, kept_cls = (t.numpy() for t in host)
        n = int(min(int(n_valid[0]), len(kept_boxes))) or 1
        return RegionFeatures(
            features=kept_feats[:n].copy(),
            boxes=kept_boxes[:n] / scale,  # back to original pixel coords
            image_width=w, image_height=h, num_boxes=n,
            cls_prob=kept_cls[:n].copy())

    def extract(self, image_path: str) -> RegionFeatures:
        from PIL import Image

        with obs.span("detect.decode"):
            rgb = np.asarray(Image.open(image_path).convert("RGB"))
        return self.extract_array(rgb)


class FallbackFeatureStore:
    """FeatureStore interface, with live extraction on a miss.

    Lookup order per key: (1) the precomputed store, (2) an in-memory cache
    of previous live extractions, keyed by the image file's content
    identity, (3) run the detector on the image file the key names
    (absolute path, or relative to ``media_root``). Matches the reference
    demo's behavior where uploads always work because the detector runs per
    request (worker.py:556-558).
    """

    def __init__(self, store, extractor: LiveFeatureExtractor, *,
                 media_root: str = "media", max_cached: int = 64):
        self.store = store
        self.extractor = extractor
        self.media_root = media_root
        self.max_cached = max_cached
        # LRU, same pattern as FeatureStore: ~1.5 MB per entry at the
        # serving num_keep (fc6 features + the full cls_prob rows the MRM
        # pretraining target needs); unbounded growth would exhaust a
        # long-lived demo's memory.
        self._cache: "OrderedDict[str, RegionFeatures]" = OrderedDict()
        self._lock = threading.Lock()

    def _resolve_image(self, key: str) -> Optional[str]:
        """Map a job's image key to a file STRICTLY under media_root.

        The key is client-supplied (it rides in the job payload), so the
        resolved path must stay confined — the same ``contained_path`` rule
        the HTTP media handler uses (utils.py). An absolute path is
        accepted only if it already points inside media_root (that is
        exactly what /upload_image returns).
        """
        candidates = [key, os.path.join(self.media_root, key),
                      os.path.join(self.media_root, "demo",
                                   os.path.basename(key))]
        for c in candidates:
            full = contained_path(self.media_root, c)
            if full is not None and os.path.isfile(full):
                return full
        return None

    def identity(self, key: str) -> str:
        """Content-stable identity (see FeatureStore.fetch): precomputed
        feature file when one exists, else the resolved image file —
        path + mtime + size, so a replaced upload never hits a stale
        device/host cache entry."""
        ident = getattr(self.store, "identity", None)
        if ident is not None:
            try:
                return ident(key)
            except (KeyError, FileNotFoundError):
                pass
        path = self._resolve_image(key)
        if path is None:
            raise KeyError(f"no features or image file for {key!r}")
        return file_identity(path)

    def fetch(self, key: str):
        """(features, content identity); the identity is stat'd BEFORE the
        read or extraction — see FeatureStore.fetch for why that ordering.
        The precomputed store is ALWAYS consulted first (the documented
        lookup order): a duck-typed store with only get() still wins — its
        hit just carries a None identity (host upload, no device
        caching)."""
        store_fetch = getattr(self.store, "fetch", None)
        if store_fetch is not None:
            try:
                return store_fetch(key)
            except (KeyError, FileNotFoundError):
                pass
        else:
            try:
                return self.store.get(key), None
            except (KeyError, FileNotFoundError):
                pass
        path = self._resolve_image(key)
        if path is None:
            raise KeyError(
                f"no precomputed features for {key!r} and no image file "
                f"under media_root to extract from")
        cache_key = file_identity(path)
        with self._lock:
            if cache_key in self._cache:  # content identity: one per version
                self._cache.move_to_end(cache_key)
                return self._cache[cache_key], cache_key
        region = self.extractor.extract(path)
        with self._lock:
            self._cache[cache_key] = region
            self._cache.move_to_end(cache_key)
            while len(self._cache) > self.max_cached:
                self._cache.popitem(last=False)
        return region, cache_key

    def get(self, key: str) -> RegionFeatures:
        return self.fetch(key)[0]

    def get_batch(self, keys: Sequence[str]):
        return [self.get(k) for k in keys]
