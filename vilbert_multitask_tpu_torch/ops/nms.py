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
  ``csrc/nms.cu`` (one call, counted in ``nms_mask.launches``), which
  orders each group itself and reads boxes and scores through their
  strides; :func:`plan_launch` picks its route and launch numbers from the
  shape alone (a shared box set: one IoU bitmask for every group, then a
  sort-and-walk kernel; own boxes: a sort, a per-group bitmask in sorted
  order, a walk 64 boxes at a time). Anything else raises. On a CPU
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
import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.ops import routes

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
    scores' device or None for every box, whether the caller passed 1-D
    scores)."""
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
    n_valid = None
    if valid is not None:
        n_valid = torch.as_tensor(valid, dtype=torch.int64).to(
            s.device).contiguous()
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
    if n_valid is None:
        n_valid = torch.full((G,), N, dtype=torch.int64, device=s.device)
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


# csrc/nms.cu's limits: boxes per group (128 mask words of 64) and the
# dynamic shared memory of one H100 block.
MAX_BOXES = 8192
SMEM_PER_BLOCK = 232448
MAX_GROUPS_PER_BLOCK = 8  # warps of the shared-set walk, one group each
SORT_GROUPS_PER_BLOCK = 2  # warps of the shared-set sort kernel (kSortThreads)
SEGMENT_MAX_BOXES = 512  # shared sets walked 8 lanes a group (8 mask words)


@dataclasses.dataclass(frozen=True)
class NmsPlan:
    """How ``csrc/nms.cu`` runs one call, from the shape alone.

    ``shared``: one box set for every group (group stride 0), its IoU
    bitmask made once, in the original order. Up to 512 boxes
    (``segments``) a sort kernel orders each group (a warp a group,
    ``groups_per_block`` warps a block; its first blocks make the bitmask)
    and a walk kernel gives each group 8 lanes, one mask word each; above
    that, one kernel sorts and walks each group with a warp, staging the
    mask in shared memory when it fits (``staged``). Otherwise each group
    has its own boxes: a sort kernel, the group's bitmask in its sorted
    order, and a walk of 64 boxes at a time. ``sort_len`` keys are sorted
    per group (a power of two ≥ N and ≥ 32); ``walk_smem`` is the dynamic
    shared memory of the walk block and ``scratch_bytes`` what the wrapper
    allocates for the masks and orders."""

    shared: bool
    segments: bool
    words: int
    sort_len: int
    groups_per_block: int
    staged: bool
    walk_smem: int
    scratch_bytes: int
    kernels: Tuple[str, ...]


def _aligned(n_bytes: int) -> int:
    return -(-n_bytes // 256) * 256


def plan_launch(G: int, N: int, shared: bool) -> NmsPlan:
    """The launch of ``G`` groups of ``N`` boxes (see :class:`NmsPlan`);
    raises ``ValueError`` for a shape the kernel does not take."""
    if not (1 <= N <= MAX_BOXES) or G < 1 or (not shared and G > 65535):
        raise ValueError(f"the NMS kernel takes 1 <= N <= {MAX_BOXES} boxes "
                         f"and G >= 1 groups (<= 65535 with own boxes), got "
                         f"G={G} N={N}")
    words = -(-N // 64)
    sort_len = max(32, 1 << (N - 1).bit_length())
    mask = 8 * N * words
    if shared and sort_len <= SEGMENT_MAX_BOXES:
        return NmsPlan(True, True, words, sort_len, SORT_GROUPS_PER_BLOCK,
                       True, mask + 8 * 32 * words + 2 * 32 * N,
                       _aligned(mask) + 2 * 32 * -(-G // 32) * N,
                       ("nms_sort_kernel", "nms_walk_segments_kernel"))
    if shared:
        per_group = 8 * (sort_len + 1 + words)  # sorted keys, kept words
        staged = mask + per_group <= SMEM_PER_BLOCK
        room = SMEM_PER_BLOCK - (mask if staged else 0)
        groups = min(MAX_GROUPS_PER_BLOCK, room // per_group, G)
        return NmsPlan(True, False, words, sort_len, groups, staged,
                       (mask if staged else 0) + groups * per_group, mask,
                       ("nms_pairs_kernel", "nms_walk_shared_kernel"))
    return NmsPlan(False, False, words, sort_len, 1, False,
                   8 * (64 + 2) * words, _aligned(4 * G * N) + G * mask,
                   ("nms_order_kernel", "nms_sorted_pairs_kernel",
                    "nms_walk_own_kernel"))


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_nms
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i64, i64, i64, p, i64, i64, p, i, i,
                       ctypes.c_float, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(b: torch.Tensor, s: torch.Tensor, valid: Optional[torch.Tensor],
            iou_threshold: float, *, lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch ``csrc/nms.cu`` on CUDA tensors checked by :func:`nms_mask`
    (``valid`` an int64 count per group on the card, or None for all);
    returns the (G, N) keep mask. Counts nothing."""
    G, N = s.shape
    plan = plan_launch(G, N, b.stride(0) == 0)
    lib = lib or _build.load("nms")
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=s.device)
    keep = torch.empty((G, N), dtype=torch.bool, device=s.device)
    rc = _bind(lib)(b.data_ptr(), *b.stride(), s.data_ptr(), *s.stride(),
                    None if valid is None else valid.data_ptr(), G, N,
                    float(iou_threshold), plan.sort_len,
                    plan.groups_per_block, int(plan.staged),
                    scratch.data_ptr(), keep.data_ptr(),
                    torch.cuda.current_stream(s.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError {rc}")
    return keep


@routes.kernel_wrapper("nms")
def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5, *, valid: Valid = None
             ) -> torch.Tensor:
    """Greedy NMS → bool keep mask shaped like ``scores``: ``(N,)`` or
    ``(G, N)`` groups, boxes ``(N, 4)`` (shared) or ``(G, N, 4)`` xyxy f32,
    ``valid`` the per-group count of boxes to consider (the first ones; the
    rest are never kept). CUDA tensors go to the kernel (counted in
    ``nms_mask.launches``), CPU tensors to the plain version
    (``ops/routes.py``)."""

    def launch():
        b, s, n_valid, single = _batched(boxes, scores, valid)
        if b.dtype != torch.float32 or s.dtype != torch.float32:
            raise TypeError(f"nms_mask takes float32 boxes and scores, got "
                            f"{b.dtype} and {s.dtype}")
        keep = _launch(b, s, n_valid, iou_threshold)
        return keep[0] if single else keep

    return routes.launch_or_plain(
        "nms", (boxes, scores),
        lambda: nms_mask_plain(boxes, scores, iou_threshold, valid=valid),
        launch)


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
