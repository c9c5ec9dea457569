"""Greedy NMS and the detector's top-K region selection: the hand-written
CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``vilbert_multitask_tpu/ops/nms.py`` (``box_iou``,
``nms_mask``, ``select_top_regions``), which the JAX package computes with
XLA: a ``lax.fori_loop`` over an IoU matrix, vmapped over the detector's
classes. The reference ran maskrcnn_benchmark's CUDA NMS (worker.py:51)
inside the per-class selection loop of worker.py:123-176.

- :func:`nms_mask` takes a batch of groups: scores ``(G, N)``, boxes
  ``(G, N, 4)`` or one shared ``(N, 4)`` set (passed on as a stride-0 view,
  never copied), and an optional per-group count of valid boxes (the RPN's
  levels hold different counts). On a CUDA tensor it launches
  ``csrc/nms.cu`` (one call, counted in ``nms_mask.launches``: the IoU
  bitmask kernel, then the greedy walk); anything else raises. On a CPU
  tensor it calls :func:`nms_mask_plain`.
- :func:`nms_mask_plain` is the same greedy walk in torch ops, vectorised
  over groups with a Python loop over the sorted boxes, as the
  ``fori_loop`` is: the CPU path, and what the kernel is held to on the card.
- Every ``top_k`` of the JAX package is :func:`top_k` here: a stable
  descending sort, so ties go to the lower index as ``lax.top_k`` gives
  them (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from vilbert_multitask_tpu_torch import _build

Valid = Optional[Union[Sequence[int], torch.Tensor]]


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of 1-D ``x`` and their indices, descending,
    ties in index order (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xyxy, (..., M, 4) xyxy → (..., N, M) IoU, in the JAX
    function's order of operations (so the same bits on one device)."""
    area_a = ((boxes_a[..., 2] - boxes_a[..., 0])
              * (boxes_a[..., 3] - boxes_a[..., 1]))
    area_b = ((boxes_b[..., 2] - boxes_b[..., 0])
              * (boxes_b[..., 3] - boxes_b[..., 1]))
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _batched(boxes: torch.Tensor, scores: torch.Tensor, valid: Valid):
    """(boxes (G, N, 4) view, scores (G, N), valid (G,) int64 on the
    scores' device, whether the caller passed 1-D scores)."""
    single = scores.dim() == 1
    s = scores[None] if single else scores
    if s.dim() != 2:
        raise ValueError(f"scores must be (N,) or (G, N), got "
                         f"{tuple(scores.shape)}")
    G, N = s.shape
    if boxes.dim() == 2:
        boxes = boxes.expand(G, *boxes.shape)
    if tuple(boxes.shape) != (G, N, 4):
        raise ValueError(f"boxes must be (N, 4) or (G, N, 4) for scores "
                         f"{tuple(scores.shape)}, got {tuple(boxes.shape)}")
    if boxes.device != s.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {s.device}")
    if valid is None:
        n_valid = torch.full((G,), N, dtype=torch.int64, device=s.device)
    else:
        n_valid = torch.as_tensor(valid, dtype=torch.int64).to(s.device)
        if tuple(n_valid.shape) != (G,):
            raise ValueError(f"valid must hold one count per group ({G}), "
                             f"got {tuple(n_valid.shape)}")
    return boxes, s, n_valid, single


def _order(s: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Per group, positions by descending score with ties in index order
    (``jnp.argsort(-scores)``); positions past the valid count go last."""
    N = s.shape[1]
    pad = torch.arange(N, device=s.device)[None, :] >= n_valid[:, None]
    s = s.masked_fill(pad, float("-inf"))
    return torch.sort(s, dim=1, descending=True, stable=True).indices


def nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float = 0.5, *,
                   valid: Valid = None) -> torch.Tensor:
    """Greedy NMS keep mask in torch ops (the kernel's plain version): per
    group, a box is kept iff no box kept before it in descending score
    order has IoU > ``iou_threshold`` with it. Same shapes and arguments as
    :func:`nms_mask`."""
    b, s, n_valid, single = _batched(boxes, scores, valid)
    G, N = s.shape
    order = _order(s, n_valid)
    thresh = torch.tensor(iou_threshold, dtype=torch.float32)
    shared = G == 1 or b.stride(0) == 0
    # IoU > thresh in the original order (IoU is symmetric bit for bit).
    over = box_iou(b[0], b[0]) > thresh if shared else box_iou(b, b) > thresh
    kept = torch.zeros((G, N), dtype=torch.bool, device=s.device)
    groups = torch.arange(G, device=s.device)
    for i in range(N):
        cur = order[:, i]
        rows = over[cur] if shared else over[groups, cur]
        ok = ~(rows & kept).any(dim=1) & (i < n_valid)
        kept[groups, cur] = ok
    return kept[0] if single else kept


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_nms
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i64, i64, i64, p, p, i, i, ctypes.c_float, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(b: torch.Tensor, s: torch.Tensor, n_valid: torch.Tensor,
            iou_threshold: float, *, lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch ``csrc/nms.cu`` on CUDA tensors checked by :func:`nms_mask`;
    returns the (G, N) keep mask. Counts nothing."""
    lib = lib or _build.load("nms")
    G, N = s.shape
    max_boxes = lib.vmt_nms_max_boxes()
    if N > max_boxes or G > 65535:
        raise ValueError(f"the NMS kernel takes N <= {max_boxes} boxes and "
                         f"G <= 65535 groups, got G={G} N={N}")
    order = _order(s, n_valid).contiguous()
    valid32 = n_valid.to(torch.int32)
    words = (N + 63) // 64
    mask = torch.empty((G, N, words), dtype=torch.int64, device=s.device)
    keep = torch.empty((G, N), dtype=torch.bool, device=s.device)
    sg, sn, sc = b.stride()
    rc = _bind(lib)(b.data_ptr(), sg, sn, sc, order.data_ptr(),
                    valid32.data_ptr(), G, N, float(iou_threshold),
                    mask.data_ptr(), keep.data_ptr(),
                    torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {rc}")
    return keep


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5, *, valid: Valid = None
             ) -> torch.Tensor:
    """Greedy NMS → bool keep mask shaped like ``scores``: ``(N,)`` or
    ``(G, N)`` groups, boxes ``(N, 4)`` (shared) or ``(G, N, 4)`` xyxy f32,
    ``valid`` the per-group count of boxes to consider (the first ones; the
    rest are never kept). CUDA tensors go to the kernel (counted in
    ``nms_mask.launches``), CPU tensors to the plain version."""
    if scores.device.type == "cpu":
        return nms_mask_plain(boxes, scores, iou_threshold, valid=valid)
    if scores.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {scores.device}")
    b, s, n_valid, single = _batched(boxes, scores, valid)
    if b.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError(f"nms_mask takes float32 boxes and scores, got "
                        f"{b.dtype} and {s.dtype}")
    keep = _launch(b, s, n_valid, iou_threshold)
    if torch.cuda.is_current_stream_capturing():
        rec = nms_mask.recorded
        rec.n = getattr(rec, "n", 0) + 1
    else:
        nms_mask.launches += 1
    return keep[0] if single else keep


# Kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after); CPU calls never count.
nms_mask.launches = 0
# Calls recorded into a CUDA graph by this thread's capture (see
# engine/graphs.py): they launch nothing now, and a replay adds them.
nms_mask.recorded = threading.local()


def select_top_regions(boxes: torch.Tensor, class_scores: torch.Tensor,
                       num_keep: int = 100, iou_threshold: float = 0.5,
                       conf_threshold: float = 0.0,
                       background: bool = False):
    """Per-class NMS → per-box max surviving confidence → top-``num_keep``.

    The reference selection loop (worker.py:136-163), as the JAX function
    computes it: for each class, NMS on that class's scores over the shared
    boxes (one :func:`nms_mask` call for all classes); a box's ``max_conf``
    is the best score it reached in a class where NMS kept it and the score
    beat ``conf_threshold``; keep the ``num_keep`` highest. Returns
    ``(keep_indices (num_keep,), num_valid (), max_conf (N,), objects
    (num_keep,), top_class_conf (num_keep,))``: ``num_valid`` counts kept
    boxes with nonzero confidence, ``objects`` is each kept box's class
    argmax over the non-background columns and ``top_class_conf`` its
    score."""
    start = 0 if background else 1
    s = class_scores[:, start:]
    n, c = s.shape
    per_class = nms_mask(boxes.expand(c, n, 4), s.t(), iou_threshold).t()
    eligible = per_class & (s > conf_threshold)
    max_conf = torch.where(eligible, s, torch.zeros_like(s)).amax(dim=1)
    top_conf, keep_indices = top_k(max_conf, num_keep)
    num_valid = (top_conf > 0).sum()
    kept_scores = s[keep_indices]
    objects = kept_scores.argmax(dim=1)
    cls_prob = kept_scores.amax(dim=1)
    return keep_indices, num_valid, max_conf, objects, cls_prob
