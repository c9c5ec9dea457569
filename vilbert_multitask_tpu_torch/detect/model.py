"""Faster R-CNN in PyTorch: ResNeXt-FPN backbone, RPN, ROIAlign box head.

Counterpart of ``vilbert_multitask_tpu/detect/model.py`` (the Flax model the
JAX package's live extractor runs), itself a redesign of the
maskrcnn_benchmark X-152-32x8d-FPN the reference drives from
worker.py:78-89,192-193. The same graph, on the same fixed canvas:

- the public function keeps JAX's layout: :meth:`FasterRCNN.forward` takes
  a ``(canvas, canvas, 3)`` BGR mean-subtracted image and its valid
  ``(h, w)`` and returns ``(proposals (R, 4), cls (R, C), fc6 (R, D))``.
  Inside, NCHW tensors run in ``torch.channels_last`` memory format (the
  (H, W, 3) canvas is one already, viewed as NCHW), so cuDNN gets its fast
  layout and ROIAlign reads each level map as (H, W, C) without a copy;
- frozen BatchNorm is the affine ``x * scale + bias``; grouped convs are
  ``groups=32``; Flax's padding is carried exactly: ``padding=1``/``3``
  symmetric, the 1×1 convs unpadded (Flax's ``SAME`` pads nothing for a
  1×1 kernel), the stem max-pool padded with −inf, P6 the stride-2
  subsample of P5, and the FPN's nearest resize an exact 2× step
  (asserted);
- every ``lax.top_k`` is a stable descending sort (:func:`..ops.nms.top_k`);
- NMS is :func:`..ops.nms.nms_mask`, one batched call for the five RPN
  levels; ROIAlign is :func:`roi_align`, one call for the 300 proposals
  over P2..P5 (the kernel chooses each box's level as :func:`fpn_level`
  does). On CUDA tensors each launches its hand-written kernel
  (``csrc/nms.cu``, ``csrc/roi_align.cu``); on CPU tensors each runs its
  plain version.

The module tree's keys are the Flax tree's paths (``backbone.stage2_block0.
conv1.weight``, ``fpn.lateral2.bias``, ``rpn.objectness.weight``,
``fc6.weight``, FrozenBN ``scale``/``bias``); detect/convert.py carries a
Flax tree or a maskrcnn checkpoint into them.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vilbert_multitask_tpu_torch import _build, obs
from vilbert_multitask_tpu_torch.config import DetectorConfig
from vilbert_multitask_tpu_torch.ops.nms import nms_mask, top_k

FPN_STRIDES = (4, 8, 16, 32, 64)  # P2..P6
ROI_LEVELS = 4  # the box head pools from P2..P5 (P6 is RPN-only)


class FrozenBN(nn.Module):
    """Inference-mode BatchNorm: y = x * scale + bias (per channel)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0,
          groups: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias=bias)


class BottleneckX(nn.Module):
    """ResNeXt bottleneck: 1x1 → grouped 3x3 → 1x1, residual."""

    def __init__(self, in_channels: int, out_channels: int, groups: int,
                 group_width: int, stride: int = 1):
        super().__init__()
        mid = groups * group_width
        self.conv1 = _conv(in_channels, mid, 1)
        self.bn1 = FrozenBN(mid)
        self.conv2 = _conv(mid, mid, 3, stride=stride, padding=1,
                           groups=groups)
        self.bn2 = FrozenBN(mid)
        self.conv3 = _conv(mid, out_channels, 1)
        self.bn3 = FrozenBN(out_channels)
        self.project = in_channels != out_channels or stride != 1
        if self.project:
            self.downsample = _conv(in_channels, out_channels, 1,
                                    stride=stride)
            self.downsample_bn = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = (self.downsample_bn(self.downsample(x)) if self.project
                    else x)
        return F.relu(h + residual)


class Backbone(nn.Module):
    """Stem + 4 ResNeXt stages → (C2, C3, C4, C5), strides 4 to 32."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        c = cfg
        self.stem_conv = _conv(3, c.stem_channels, 7, stride=2, padding=3)
        self.stem_bn = FrozenBN(c.stem_channels)
        self.stages: List[List[str]] = []
        cin = c.stem_channels
        for stage, (blocks, channels) in enumerate(
                zip(c.stage_blocks, c.stage_channels)):
            names = []
            for b in range(blocks):
                name = f"stage{stage + 2}_block{b}"
                self.add_module(name, BottleneckX(
                    cin, channels, c.groups, c.width_per_group * 2 ** stage,
                    stride=2 if (b == 0 and stage > 0) else 1))
                names.append(name)
                cin = channels
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(self.stem_bn(self.stem_conv(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            outs.append(h)
        return outs


class FPN(nn.Module):
    """Top-down pyramid: (C2..C5) → (P2..P5, P6)."""

    def __init__(self, in_channels: Sequence[int], channels: int):
        super().__init__()
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}", _conv(cin, channels, 1,
                                                     bias=True))
            self.add_module(f"output{i + 2}", _conv(channels, channels, 3,
                                                    padding=1, bias=True))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral{i + 2}")(f)
                    for i, f in enumerate(feats)]
        out = [laterals[-1]]
        for lat in laterals[-2::-1]:
            top = out[0]
            # jax.image.resize(..., "nearest") equals this only at exact
            # 2x steps (output i reads input i // 2 in both).
            if (lat.shape[2] != 2 * top.shape[2]
                    or lat.shape[3] != 2 * top.shape[3]):
                raise ValueError(f"FPN levels {tuple(top.shape[2:])} → "
                                 f"{tuple(lat.shape[2:])} are not a 2x step; "
                                 f"the canvas must be a multiple of 32")
            out.insert(0, lat + F.interpolate(top, scale_factor=2.0,
                                              mode="nearest"))
        pyramid = [getattr(self, f"output{i + 2}")(p)
                   for i, p in enumerate(out)]
        # P6: stride-2 subsample of P5 (maskrcnn LastLevelMaxPool).
        return pyramid + [pyramid[-1][:, :, ::2, ::2]]


class RPNHead(nn.Module):
    """Shared 3x3 conv + per-anchor objectness / box deltas."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = _conv(channels, channels, 3, padding=1, bias=True)
        self.objectness = _conv(channels, num_anchors, 1, bias=True)
        self.deltas = _conv(channels, 4 * num_anchors, 1, bias=True)

    def forward(self, feats: List[torch.Tensor]):
        outs = []
        for f in feats:
            h = F.relu(self.conv(f))
            outs.append((self.objectness(h), self.deltas(h)))
        return outs


# --------------------------------------------------------------- box math
def make_anchors(h: int, w: int, stride: int, size: int,
                 aspect_ratios: Sequence[float]) -> np.ndarray:
    """(h*w*A, 4) xyxy anchors for one level (host-side, static)."""
    ys = (np.arange(h) + 0.5) * stride
    xs = (np.arange(w) + 0.5) * stride
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    anchors = []
    for ar in aspect_ratios:
        aw = size * math.sqrt(1.0 / ar)
        ah = size * math.sqrt(ar)
        anchors.append(np.stack(
            [cx - aw / 2, cy - ah / 2, cx + aw / 2, cy + ah / 2], axis=-1))
    return np.stack(anchors, axis=2).reshape(-1, 4).astype(np.float32)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """maskrcnn box decoding: (dx, dy, dw, dh) on (cx, cy, w, h)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    dx, dy, dw, dh = deltas.unbind(1)
    # clamp like maskrcnn (log(1000/16)) so exp can't overflow
    dw = torch.clamp(dw, max=math.log(1000.0 / 16))
    dh = torch.clamp(dh, max=math.log(1000.0 / 16))
    cx = acx + dx * aw
    cy = acy + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=1)


def _true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded once, as the JAX function divides: PyTorch
    multiplies a CUDA tensor by the reciprocal of a Python-number divisor,
    which can move a sample point by an ulp (and the kernel divides)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def fpn_level(boxes: torch.Tensor) -> torch.Tensor:
    """The box head's level per box, 0..3 for P2..P5:
    ``clip(floor(4 + log2(sqrt(max(area, 1)) / 224)), 2, 5) - 2``."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    level = torch.floor(4 + torch.log2(
        _true_div(torch.sqrt(torch.clamp_min(area, 1.0)), 224.0)))
    return torch.clamp(level, 2, 5).to(torch.int64) - 2


def roi_align_level(feat: torch.Tensor, boxes: torch.Tensor, stride: float,
                    resolution: int, sampling: int) -> torch.Tensor:
    """(H, W, C) level map + (R, 4) pixel boxes → (R, res, res, C), in
    torch ops: the JAX function ``roi_align`` (bilinear sampling at
    ``sampling``² points per output bin, averaged)."""
    H, W, C = feat.shape
    n = resolution * sampling
    x1, y1, x2, y2 = (boxes / stride).unbind(1)
    steps = torch.arange(n, dtype=feat.dtype, device=feat.device) + 0.5
    gy = y1[:, None] + _true_div(steps[None, :] * (y2 - y1)[:, None], n)
    gx = x1[:, None] + _true_div(steps[None, :] * (x2 - x1)[:, None], n)
    yy = torch.clamp(gy, 0.0, H - 1.0)
    xx = torch.clamp(gx, 0.0, W - 1.0)
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, H - 2)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, W - 2)
    wy = (yy - y0)[:, :, None, None]
    wx = (xx - x0)[:, None, :, None]
    ry, rx = y0[:, :, None], x0[:, None, :]
    vals = (feat[ry, rx] * (1 - wy) * (1 - wx)
            + feat[ry, rx + 1] * (1 - wy) * wx
            + feat[ry + 1, rx] * wy * (1 - wx)
            + feat[ry + 1, rx + 1] * wy * wx)  # (R, n, n, C)
    return vals.reshape(-1, resolution, sampling, resolution, sampling,
                        C).mean(dim=(2, 4))


def _check_roi(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
               strides: Sequence[float]) -> None:
    if len(feats) != ROI_LEVELS or len(strides) != ROI_LEVELS:
        raise ValueError(f"roi_align takes {ROI_LEVELS} level maps and "
                         f"strides, got {len(feats)} and {len(strides)}")
    C = feats[0].shape[-1]
    for f in feats:
        if f.dim() != 3 or f.shape[-1] != C or min(f.shape[:2]) < 2:
            raise ValueError(f"level maps must be (H >= 2, W >= 2, {C}), got "
                             f"{[tuple(x.shape) for x in feats]}")
        if f.device != boxes.device or f.dtype != boxes.dtype:
            raise ValueError("level maps and boxes must share device and "
                             "dtype")
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (R, 4), got {tuple(boxes.shape)}")


def roi_align_plain(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                    strides: Sequence[float], resolution: int,
                    sampling: int) -> torch.Tensor:
    """Multi-level ROIAlign in torch ops (the kernel's plain version): each
    box pooled from ``feats[fpn_level(box)]`` as :func:`roi_align_level`
    pools it."""
    _check_roi(feats, boxes, strides)
    level = fpn_level(boxes)[:, None, None, None]
    out = None
    for lvl, (feat, stride) in enumerate(zip(feats, strides)):
        # every box at every level, then each box's own: no data-dependent
        # shapes, so the plain version needs no host sync (and runs inside
        # a CUDA graph, where chip_smoke.py times it)
        pooled = roi_align_level(feat, boxes, float(stride), resolution,
                                 sampling)
        out = pooled if out is None else torch.where(level == lvl, pooled,
                                                     out)
    return out


def _bind_roi(lib: ctypes.CDLL):
    fn = lib.vmt_roi_align
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, i64, i64, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


ROI_VECTOR_BYTES = 16  # the float4 instance's load and store
ROI_MAX_SAMPLES = 64  # resolution * sampling per axis (csrc/roi_align.cu)
ROI_MAX_BOXES = 65535  # one grid row of blocks per box
_INT32_LIMIT = 2 ** 31 - 1  # the kernel's 32-bit indices


def roi_vector_width(feats: Sequence[torch.Tensor]) -> int:
    """Channels per thread of ``csrc/roi_align.cu`` for these (H, W, C)
    level maps, from their shapes and addresses alone: 4 (16-byte loads)
    when C % 4 == 0 and every map's base, row and column strides lie on
    16 bytes, else 1 (the scalar instance). Needs no card."""
    step = ROI_VECTOR_BYTES // 4
    for f in feats:
        if (f.shape[-1] % step or f.data_ptr() % ROI_VECTOR_BYTES
                or f.stride(0) % step or f.stride(1) % step):
            return 1
    return step


def _check_launchable_roi(feats, boxes, resolution: int,
                          sampling: int) -> None:
    """Raise unless ``csrc/roi_align.cu`` can read these maps and boxes
    (checked by :func:`_check_roi`) as they lie. Needs no card."""
    if boxes.dtype != torch.float32:
        raise TypeError(f"the ROIAlign kernel takes float32, got "
                        f"{boxes.dtype}")
    if not (1 <= resolution * sampling <= ROI_MAX_SAMPLES) or sampling < 1:
        raise ValueError(f"the ROIAlign kernel takes 1 <= resolution x "
                         f"sampling <= {ROI_MAX_SAMPLES}, got {resolution} x "
                         f"{sampling}")
    R, C = boxes.shape[0], feats[0].shape[-1]
    if R > ROI_MAX_BOXES or R * resolution ** 2 * C > _INT32_LIMIT:
        raise ValueError(f"the ROIAlign kernel takes R <= {ROI_MAX_BOXES} "
                         f"boxes and fewer than 2^31 output elements, got "
                         f"R={R}, C={C}")
    for f in feats:
        H, W, _ = f.shape
        if f.stride(2) != 1:
            raise ValueError("the ROIAlign kernel reads level maps with "
                             "contiguous channels (channels-last)")
        if (H - 1) * f.stride(0) + (W - 1) * f.stride(1) + C > _INT32_LIMIT:
            raise ValueError(f"a level map of {tuple(f.shape)} with strides "
                             f"{f.stride()} is beyond the kernel's 32-bit "
                             f"indices")


def _launch_roi(feats, boxes, strides, resolution, sampling, *,
                lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch ``csrc/roi_align.cu`` on CUDA tensors checked by
    :func:`roi_align` (the kernel chooses each box's level); counts
    nothing."""
    _check_launchable_roi(feats, boxes, resolution, sampling)
    R, C = boxes.shape[0], feats[0].shape[-1]
    out = torch.empty((R, resolution, resolution, C), dtype=torch.float32,
                      device=boxes.device)
    if R == 0:
        return out

    def arr(ctype, values):
        return (ctype * ROI_LEVELS)(*values)

    rc = _bind_roi(lib or _build.load("roi_align"))(
        arr(ctypes.c_void_p, [f.data_ptr() for f in feats]),
        arr(ctypes.c_int, [f.shape[0] for f in feats]),
        arr(ctypes.c_int, [f.shape[1] for f in feats]),
        arr(ctypes.c_longlong, [f.stride(0) for f in feats]),
        arr(ctypes.c_longlong, [f.stride(1) for f in feats]),
        arr(ctypes.c_float, [float(s) for s in strides]),
        boxes.data_ptr(), boxes.stride(0), boxes.stride(1), R, C,
        resolution, sampling, roi_vector_width(feats), out.data_ptr(),
        torch.cuda.current_stream(boxes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError {rc}")
    return out


def roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
              strides: Sequence[float], resolution: int,
              sampling: int) -> torch.Tensor:
    """Multi-level ROIAlign: four (H, W, C) level maps (P2..P5), (R, 4)
    pixel boxes → (R, res, res, C), each box from its :func:`fpn_level`.
    CUDA tensors go to the kernel (counted in ``roi_align.launches``), CPU
    tensors to :func:`roi_align_plain`."""
    if boxes.device.type == "cpu":
        return roi_align_plain(feats, boxes, strides, resolution, sampling)
    if boxes.device.type != "cuda":
        raise ValueError(f"no ROIAlign kernel for device {boxes.device}")
    _check_roi(feats, boxes, strides)
    out = _launch_roi(feats, boxes, strides, resolution, sampling)
    if torch.cuda.is_current_stream_capturing():
        rec = roi_align.recorded
        rec.n = getattr(rec, "n", 0) + 1
    else:
        roi_align.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after); CPU calls never count.
roi_align.launches = 0
# Calls recorded into a CUDA graph by this thread's capture (see
# engine/graphs.py): they launch nothing now, and a replay adds them.
roi_align.recorded = threading.local()


class FasterRCNN(nn.Module):
    """The full extractor graph: image canvas → proposals, scores, fc6.

    Output contract as the JAX model's (and what the reference's
    post-processing consumes, worker.py:123-176): proposal boxes
    (``rpn_post_nms_top_n``, 4), class scores (R, num_classes) softmaxed
    with background col 0, and relu'd fc6 features (R,
    representation_size) — which then feed :func:`..ops.nms.
    select_top_regions`."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        c = self.cfg = cfg
        self.backbone = Backbone(c)
        self.fpn = FPN(c.stage_channels, c.fpn_channels)
        self.rpn = RPNHead(c.fpn_channels, len(c.aspect_ratios))
        flat = c.roi_resolution ** 2 * c.fpn_channels
        self.fc6 = nn.Linear(flat, c.representation_size)
        self.fc7 = nn.Linear(c.representation_size, c.representation_size)
        self.cls_score = nn.Linear(c.representation_size, c.num_classes)
        # Per device and level size: anchors and the RPN's per-level box
        # counts, made once (host numpy, as the JAX model's are static).
        self._static: Dict[tuple, tuple] = {}

    def _level_static(self, shapes: Tuple[Tuple[int, int], ...],
                      device: torch.device):
        key = (str(device), shapes)
        got = self._static.get(key)
        if got is None:
            c = self.cfg
            anchors = [torch.from_numpy(make_anchors(
                h, w, stride, size, c.aspect_ratios)).to(device)
                for (h, w), stride, size in zip(shapes, FPN_STRIDES,
                                                c.anchor_sizes)]
            counts = [min(c.rpn_pre_nms_top_n, a.shape[0]) for a in anchors]
            got = (anchors, counts,
                   torch.tensor(counts, dtype=torch.int64).to(device))
            self._static[key] = got
        return got

    def features(self, image: torch.Tensor) -> List[torch.Tensor]:
        """(canvas, canvas, 3) image → P2..P6, NCHW in channels-last."""
        x = image.permute(2, 0, 1)[None]  # a channels-last NCHW view
        with obs.span("detect.backbone"):
            feats = self.backbone(x)
        with obs.span("detect.fpn"):
            return self.fpn(feats)

    def propose(self, feats: List[torch.Tensor], image_hw: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RPN: per level decode, clip, kill degenerate boxes, top-k and
        NMS (one batched call for all levels), then the global top
        ``rpn_post_nms_top_n`` → (proposals (R, 4), their objectness
        scores (R,), 0 where suppressed or degenerate)."""
        c = self.cfg
        img_h, img_w = (float(v) for v in image_hw)
        anchors, counts, n_valid = self._level_static(
            tuple(tuple(f.shape[2:]) for f in feats), feats[0].device)
        sels, tops = [], []
        for (logit, delta), anc, k in zip(self.rpn(feats), anchors, counts):
            scores = torch.sigmoid(logit.permute(0, 2, 3, 1).reshape(-1))
            boxes = decode_boxes(anc, delta.permute(0, 2, 3, 1).reshape(-1, 4))
            # clip to the valid image region, kill degenerate/out-of-image
            boxes = torch.stack([
                torch.clamp(boxes[:, 0], 0, img_w - 1),
                torch.clamp(boxes[:, 1], 0, img_h - 1),
                torch.clamp(boxes[:, 2], 0, img_w - 1),
                torch.clamp(boxes[:, 3], 0, img_h - 1)], dim=1)
            degenerate = ((boxes[:, 2] - boxes[:, 0] < 1)
                          | (boxes[:, 3] - boxes[:, 1] < 1))
            scores = torch.where(degenerate, torch.zeros_like(scores), scores)
            top, idx = top_k(scores, k)
            sels.append(boxes[idx])
            tops.append(top)
        n = max(counts)
        keep = nms_mask(
            torch.stack([F.pad(b, (0, 0, 0, n - b.shape[0])) for b in sels]),
            torch.stack([F.pad(t, (0, n - t.shape[0])) for t in tops]),
            c.rpn_nms_thresh, valid=n_valid)
        boxes = torch.cat(sels)
        scores = torch.cat([torch.where(keep[g, :k], t, torch.zeros_like(t))
                            for g, (t, k) in enumerate(zip(tops, counts))])
        top, idx = top_k(scores, c.rpn_post_nms_top_n)
        return boxes[idx], top

    def box_head(self, feats: List[torch.Tensor], proposals: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ROIAlign over P2..P5, fc6 → fc7 → class softmax: (cls, fc6)."""
        c = self.cfg
        maps = [f.permute(0, 2, 3, 1)[0] for f in feats[:ROI_LEVELS]]
        with obs.span("detect.roi_align"):
            pooled = roi_align(maps, proposals, FPN_STRIDES[:ROI_LEVELS],
                               c.roi_resolution, c.roi_sampling)
        with obs.span("detect.box_head"):
            fc6 = F.relu(self.fc6(pooled.reshape(pooled.shape[0], -1)))
            fc7 = F.relu(self.fc7(fc6))
            cls = torch.softmax(self.cls_score(fc7), dim=-1)
        return cls, fc6

    def forward(self, image: torch.Tensor, image_hw: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """image (canvas, canvas, 3) BGR mean-subtracted; image_hw the valid
        (h, w) of the canvas (host numbers). Returns (proposals, cls,
        fc6)."""
        feats = self.features(image)
        with obs.span("detect.rpn"):
            proposals, _ = self.propose(feats, image_hw)
        cls, fc6 = self.box_head(feats, proposals)
        return proposals, cls, fc6


def init_state_dict(cfg: DetectorConfig, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """Seeded random weights as an f32 CPU state dict (this module tree's
    keys), from one ``torch.Generator``: conv and linear weights
    lecun-normal as Flax draws them (N(0, 1/fan_in), truncated at 2σ),
    biases 0, FrozenBN scale 1 and bias 0 — except two scales, so that 50
    residual blocks and unit-less pixel inputs leave the RPN sigmoids and
    the class softmax unsaturated (their score spread is what the checks
    of the selection compare): ``stem_bn.scale`` 1/64 (the mean-subtracted
    pixels' spread is ~70) and every block's ``bn3.scale`` 0.2 (each
    residual branch then adds ~1% of its input's variance, not ~25%)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = FasterRCNN(cfg)
    sd: Dict[str, torch.Tensor] = {}
    for name, p in shapes.named_parameters():
        module_name, _, leaf = name.rpartition(".")
        module = shapes.get_submodule(module_name)
        if isinstance(module, FrozenBN):
            value = torch.ones(p.shape) if leaf == "scale" else \
                torch.zeros(p.shape)
            if leaf == "scale" and module_name == "backbone.stem_bn":
                value = value / 64.0
            elif leaf == "scale" and module_name.endswith(".bn3"):
                value = value * 0.2
        elif leaf == "bias":
            value = torch.zeros(p.shape)
        else:
            fan_in = p[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            value = torch.randn(p.shape, generator=gen).clamp_(-2, 2) * std
        sd[name] = value
    return sd
