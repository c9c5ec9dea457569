"""The one traffic generator: every mix is a data file of parameters
(``portbench/traffic/<name>.json``) that these functions read.

- ``gallery``: precomputed feature files in the demo's ``.npy`` schema,
  ``n_images`` of ``n_boxes`` regions (N(0, 1) features, boxes inside the
  image), written under the run's temporary directory; an image is drawn
  with Zipf(``zipf_s``) popularity over a seeded permutation of the files.
- ``questions``: the demo's eight UI tasks in ``task_shares``; a question
  of ``words`` = [lo, hi] vocabulary words; NLVR2 on two images, retrieval
  on ``retrieval_images`` = [lo, hi] images drawn uniformly.
- ``uploads``: ``n_files`` JPEG photos, smooth seeded images (not white
  noise, so the files have a photo's size), in every aspect ratio of
  ``aspects`` and long side of ``long_sides``, drawn in the seed's own
  order and returned in the order of :func:`upload_sizes`, so that a
  stream that takes them round by index serves every seed the same sizes.
- ``arrivals``: open-loop arrival times at ``rate`` a second, the gaps the
  quantiles of an exponential law, cut into blocks of ``arrival_block_s``
  seconds that each hold the same set of gaps in the seed's own order, so
  each seed offers the same load in every stretch of the window and draws
  its own bursts.

Everything is drawn from the run's seed; the same seed gives the same
traffic.
"""

from __future__ import annotations

import dataclasses
import io
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from portbench.reference.inputs import tokenizer

# The UI's task ids: VQA, GQA, Visual7W, RefCOCO, GuessWhat, SNLI-VE,
# NLVR2, retrieval.
TASK_IDS = {"vqa": 1, "gqa": 15, "visual7w": 4, "refcoco": 11,
            "guesswhat": 16, "snli_ve": 13, "nlvr2": 12, "retrieval": 7}
SINGLE_IMAGE = ("vqa", "gqa", "visual7w", "refcoco", "guesswhat", "snli_ve")


@dataclasses.dataclass
class Question:
    task_id: int
    text: str
    images: List[str]  # gallery paths (empty for an upload's question)


def vocabulary_words() -> List[str]:
    """The whole lower-case words of the served vocabulary."""
    return sorted(w for w in tokenizer().vocab
                  if w.isalpha() and w.islower() and not w.startswith("#"))


def _sentence(rng, words: Sequence[str], lo: int, hi: int) -> str:
    n = int(rng.integers(lo, hi + 1))
    return " ".join(words[i] for i in rng.integers(0, len(words), n))


def question_text(rng, task: str, words: Sequence[str], lo: int,
                  hi: int) -> str:
    if task == "guesswhat":  # a dialog of q/a turns, as GuessWhat sends
        turns = int(rng.integers(1, 4))
        per = max(lo // turns, 2), max(hi // turns, 3)
        return " ".join(
            f"q: {_sentence(rng, words, *per)}? a: "
            f"{'yes' if rng.random() < 0.5 else 'no'}"
            for _ in range(turns))
    text = _sentence(rng, words, lo, hi)
    return text + "?" if task in ("vqa", "gqa", "visual7w") else text


# ----------------------------------------------------------------- gallery
@dataclasses.dataclass
class Gallery:
    root: str
    paths: List[str]  # by popularity rank
    cdf: np.ndarray

    def draw(self, rng, n: int = 1) -> List[str]:
        idx = np.searchsorted(self.cdf, rng.random(n), side="right")
        return [self.paths[min(int(i), len(self.paths) - 1)] for i in idx]


def write_gallery(params: dict, seed: int, root: str, feature_size: int,
                  device="cpu") -> Gallery:
    """``params["n_images"]`` feature files of ``params["n_boxes"]`` regions
    under ``root``; features drawn on ``device`` in one call."""
    import torch

    n, boxes_n = int(params["n_images"]), int(params["n_boxes"])
    rng = np.random.default_rng([seed, 11])
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    feats = torch.randn((n, boxes_n, feature_size), generator=gen,
                        device=device).cpu().numpy()
    aspects = [tuple(a) for a in params["aspects"]]
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        aw, ah = aspects[i % len(aspects)]
        long_side = int(rng.integers(480, 1025))
        w, h = ((long_side, long_side * ah // aw) if aw >= ah
                else (long_side * aw // ah, long_side))
        x1 = rng.random(boxes_n) * (w - 32)
        y1 = rng.random(boxes_n) * (h - 32)
        bx = np.stack([x1, y1, np.minimum(x1 + 16 + rng.random(boxes_n)
                                          * (w / 3), w),
                       np.minimum(y1 + 16 + rng.random(boxes_n) * (h / 3), h)],
                      axis=1).astype(np.float32)
        path = os.path.join(root, f"g{i:04d}.npy")
        np.save(path, np.array({
            "image_id": f"g{i:04d}", "features": feats[i], "bbox": bx,
            "num_boxes": boxes_n, "image_width": w, "image_height": h,
            "objects": np.zeros((0,), np.int64),
            "cls_prob": np.zeros((0, 0), np.float32)}, dtype=object))
        paths.append(path)
    order = rng.permutation(n)
    weights = 1.0 / np.arange(1, n + 1) ** float(params["zipf_s"])
    return Gallery(root, [paths[i] for i in order],
                   np.cumsum(weights) / weights.sum())


def read_gallery_file(path: str) -> Dict:
    """One gallery file as the reference reads it (files this benchmark
    wrote itself)."""
    raw = np.load(path, allow_pickle=True).item()
    return {"features": np.asarray(raw["features"], np.float32),
            "boxes": np.asarray(raw["bbox"], np.float32),
            "width": int(raw["image_width"]),
            "height": int(raw["image_height"])}


# --------------------------------------------------------------- questions
def question_stream(params: dict, seed: int, gallery: Optional[Gallery],
                    tasks: Optional[Sequence[str]] = None
                    ) -> Iterator[Question]:
    """An endless seeded stream of questions over the gallery (or, with no
    gallery, single-image questions for uploads)."""
    rng = np.random.default_rng([seed, 12])
    words = vocabulary_words()
    shares = params["task_shares"]
    names = list(tasks) if tasks is not None else list(shares)
    p = np.array([float(shares[t]) for t in names])
    p = p / p.sum()
    lo, hi = params["words"]
    r_lo, r_hi = params["retrieval_images"]
    while True:
        task = names[int(rng.choice(len(names), p=p))]
        n_img = (2 if task == "nlvr2" else
                 int(rng.integers(r_lo, r_hi + 1)) if task == "retrieval"
                 else 1)
        text = question_text(rng, task, words, lo, hi)
        images = gallery.draw(rng, n_img) if gallery is not None else []
        yield Question(TASK_IDS[task], text, images)


# ------------------------------------------------------------------ uploads
def upload_sizes(params: dict) -> List[tuple]:
    """(width, height) of every upload file, the same for every seed."""
    sizes = []
    for long_side in params["long_sides"]:
        for aw, ah in params["aspects"]:
            if aw >= ah:
                sizes.append((int(long_side), int(long_side) * ah // aw))
            else:
                sizes.append((int(long_side) * aw // ah, int(long_side)))
    return sizes


def write_uploads(params: dict, seed: int, root: str, device="cpu"
                  ) -> List[str]:
    """One JPEG per size of :func:`upload_sizes`, in its order: a seeded
    low-frequency field (a few cells a side, upsampled bicubically) with
    seeded detail on top, as uint8 RGB."""
    import torch
    import torch.nn.functional as F
    from PIL import Image

    sizes = upload_sizes(params)
    rng = np.random.default_rng([seed, 13])
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    os.makedirs(root, exist_ok=True)
    paths = [""] * len(sizes)
    order = rng.permutation(len(sizes))
    for i in order:
        w, h = sizes[i]
        coarse = torch.rand((1, 3, 6, 8), generator=gen, device=device)
        mid = torch.rand((1, 3, 48, 64), generator=gen, device=device)
        img = (F.interpolate(coarse, size=(h, w), mode="bicubic",
                             align_corners=False) * 200.0
               + F.interpolate(mid, size=(h, w), mode="bilinear",
                               align_corners=False) * 55.0)
        rgb = img.clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
        buf = io.BytesIO()
        Image.fromarray(rgb.cpu().numpy()).save(
            buf, format="JPEG", quality=int(params["jpeg_quality"]))
        path = os.path.join(root, f"u{i:03d}.jpg")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        paths[i] = path
    return paths


# ----------------------------------------------------------------- arrivals
def arrivals(rate: float, seconds: float, seed: int, block_s: float,
             purpose: int) -> np.ndarray:
    """Due times in [0, ``seconds``) of an open-loop stream at ``rate``.

    The window is cut into blocks of about ``block_s`` seconds, each with
    the same number of arrivals; a block's gaps are the mid-quantiles of
    Exp(rate) at that number of points, in an order the seed draws for
    each block. Every seed thus offers the same load in every block, and
    its own bursts inside them."""
    n = max(1, int(round(rate * seconds)))
    blocks = max(1, min(n, int(round(seconds / block_s))))
    rng = np.random.default_rng([int(seed), purpose])
    gaps = []
    for b in range(blocks):
        m = n // blocks + (1 if b < n % blocks else 0)
        q = (np.arange(m) + 0.5) / m
        gaps.append(rng.permutation(-np.log1p(-q) / rate))
    g = np.concatenate(gaps)
    g *= seconds / g.sum()  # the last one lands just inside
    return np.concatenate([[0.0], np.cumsum(g)[:-1]])
