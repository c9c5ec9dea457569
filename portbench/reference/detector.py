"""Plain PyTorch reference of the demo's region extractor: Faster R-CNN with
a ResNeXt-152 32x8d backbone and an FPN (maskrcnn-benchmark's
X-152-32x8d-FPN), seeded, on one image.

Over a state dict in the served extractor's keys (``backbone.stage2_block0.
conv1.weight``, ``fpn.lateral2.bias``, ``rpn.objectness.weight``,
``fc6.weight``, frozen BatchNorm as ``scale``/``bias``), in float32 with TF32
off, NCHW, with no kernels:

- preprocessing: the short side to 800 px unless the long side then passes
  1333; bilinear with antialiasing in two passes (horizontal, then
  vertical), each rounded half up to uint8 levels as PIL's are; RGB to BGR
  less the per-channel means; the image at the top left of a zero canvas;
- backbone: 7x7/2 stem, 3x3/2 max-pool padded with -inf, bottleneck blocks
  (1x1, grouped 3x3, 1x1; the first block of stages 3-5 strides 2);
- FPN: 1x1 laterals, nearest 2x top-down sums, 3x3 outputs, P6 the
  stride-2 subsample of P5;
- RPN: per level and anchor (sizes 32-512, ratios 0.5/1/2) the sigmoid
  objectness and the decoded box clipped to the image, degenerate boxes
  scored 0, each level's 1000 best, greedy NMS at 0.7 per level, the 300
  best overall;
- box head: ROIAlign (7x7 bins, 2x2 samples, the level by
  ``floor(4 + log2(sqrt(area) / 224))`` clipped to P2-P5), fc6 and fc7 with
  ReLU, a softmax over the 1601 classes;
- selection: greedy NMS at 0.5 per class (background left out) over the
  300 boxes, each box's best surviving score, the 100 best boxes, stable on
  ties.

Every sort is stable and descending, so ties go to the lower index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BGR_PIXEL_MEANS = (102.9801, 115.9465, 122.7717)
STRIDES = (4, 8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class DetDims:
    stem_channels: int = 64
    stage_blocks: Tuple[int, ...] = (3, 8, 36, 3)
    groups: int = 32
    width_per_group: int = 8
    stage_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    fpn_channels: int = 256
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_pre_nms_top_n: int = 1000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    roi_resolution: int = 7
    roi_sampling: int = 2
    representation_size: int = 2048
    num_classes: int = 1601
    canvas: int = 1344
    num_keep: int = 100

    @classmethod
    def from_config(cls, cfg: dict) -> "DetDims":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k in names}
        return cls(**kw)


def param_shapes(d: DetDims):
    """(key, shape, kind) of every leaf; kind is ``conv`` (or ``linear``),
    ``bias``, ``bn_scale``, ``bn_bias``, which the seeded weights read;
    the stem's and each block's last BatchNorm are named by the key."""
    def conv(key, cout, cin, k, bias=False):
        yield f"{key}.weight", (cout, cin, k, k), "conv"
        if bias:
            yield f"{key}.bias", (cout,), "bias"

    def bn(key, n):
        yield f"{key}.scale", (n,), "bn_scale"
        yield f"{key}.bias", (n,), "bn_bias"

    yield from conv("backbone.stem_conv", d.stem_channels, 3, 7)
    yield from bn("backbone.stem_bn", d.stem_channels)
    cin = d.stem_channels
    for s, (blocks, cout) in enumerate(zip(d.stage_blocks, d.stage_channels)):
        mid = d.groups * d.width_per_group * 2 ** s
        for b in range(blocks):
            p = f"backbone.stage{s + 2}_block{b}"
            yield from conv(f"{p}.conv1", mid, cin, 1)
            yield from bn(f"{p}.bn1", mid)
            yield from conv(f"{p}.conv2", mid, mid // d.groups, 3)
            yield from bn(f"{p}.bn2", mid)
            yield from conv(f"{p}.conv3", cout, mid, 1)
            yield from bn(f"{p}.bn3", cout)
            if cin != cout or (b == 0 and s > 0):
                yield from conv(f"{p}.downsample", cout, cin, 1)
                yield from bn(f"{p}.downsample_bn", cout)
            cin = cout
    for i, c in enumerate(d.stage_channels):
        yield from conv(f"fpn.lateral{i + 2}", d.fpn_channels, c, 1, True)
        yield from conv(f"fpn.output{i + 2}", d.fpn_channels, d.fpn_channels,
                        3, True)
    a = len(d.aspect_ratios)
    yield from conv("rpn.conv", d.fpn_channels, d.fpn_channels, 3, True)
    yield from conv("rpn.objectness", a, d.fpn_channels, 1, True)
    yield from conv("rpn.deltas", 4 * a, d.fpn_channels, 1, True)
    flat = d.roi_resolution ** 2 * d.fpn_channels
    for key, n_out, n_in in (("fc6", d.representation_size, flat),
                             ("fc7", d.representation_size,
                              d.representation_size),
                             ("cls_score", d.num_classes,
                              d.representation_size)):
        yield f"{key}.weight", (n_out, n_in), "linear"
        yield f"{key}.bias", (n_out,), "bias"


# ------------------------------------------------------------ preprocessing
def preprocess(rgb: np.ndarray, d: DetDims, device
               ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """(H, W, 3) uint8 RGB → ((1, 3, canvas, canvas) f32 BGR less the means,
    scale, resized (h, w))."""
    h, w = rgb.shape[:2]
    max_size = min(1333, d.canvas)
    min_size = min(800, max_size)
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    x = torch.from_numpy(np.array(rgb, dtype=np.uint8)).to(device)
    x = x.permute(2, 0, 1)[None].float()
    for size, changed in (((h, nw), nw != w), ((nh, nw), nh != h)):
        if changed:
            x = F.interpolate(x, size=size, mode="bilinear", antialias=True,
                              align_corners=False)
            x = torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)
    means = torch.tensor(BGR_PIXEL_MEANS, device=device)[None, :, None, None]
    bgr = x.flip(1) - means
    canvas = torch.zeros((1, 3, d.canvas, d.canvas), device=device)
    canvas[:, :, :nh, :nw] = bgr
    return canvas, scale, (nh, nw)


# ---------------------------------------------------------------- backbone
def _bn(w, key, x):
    return x * w[f"{key}.scale"][:, None, None] + w[f"{key}.bias"][:, None,
                                                                  None]


def _block(w, p, x, groups, stride):
    h = F.relu(_bn(w, f"{p}.bn1", F.conv2d(x, w[f"{p}.conv1.weight"])))
    h = F.relu(_bn(w, f"{p}.bn2", F.conv2d(h, w[f"{p}.conv2.weight"],
                                           stride=stride, padding=1,
                                           groups=groups)))
    h = _bn(w, f"{p}.bn3", F.conv2d(h, w[f"{p}.conv3.weight"]))
    if f"{p}.downsample.weight" in w:
        x = _bn(w, f"{p}.downsample_bn",
                F.conv2d(x, w[f"{p}.downsample.weight"], stride=stride))
    return F.relu(h + x)


def pyramid(w: Dict[str, torch.Tensor], d: DetDims, image: torch.Tensor
            ) -> List[torch.Tensor]:
    """(1, 3, canvas, canvas) → P2..P6 (NCHW)."""
    h = F.relu(_bn(w, "backbone.stem_bn",
                   F.conv2d(image, w["backbone.stem_conv.weight"], stride=2,
                            padding=3)))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    stages = []
    for s, blocks in enumerate(d.stage_blocks):
        for b in range(blocks):
            h = _block(w, f"backbone.stage{s + 2}_block{b}", h, d.groups,
                       2 if (b == 0 and s > 0) else 1)
        stages.append(h)
    lat = [F.conv2d(c, w[f"fpn.lateral{i + 2}.weight"],
                    w[f"fpn.lateral{i + 2}.bias"])
           for i, c in enumerate(stages)]
    tops = [lat[-1]]
    for x in lat[-2::-1]:
        tops.insert(0, x + F.interpolate(tops[0], scale_factor=2.0,
                                         mode="nearest"))
    outs = [F.conv2d(p, w[f"fpn.output{i + 2}.weight"],
                     w[f"fpn.output{i + 2}.bias"], padding=1)
            for i, p in enumerate(tops)]
    return outs + [outs[-1][:, :, ::2, ::2]]


# --------------------------------------------------------------------- RPN
def top_k(x: torch.Tensor, k: int):
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
             n_valid: torch.Tensor) -> torch.Tensor:
    """Greedy NMS of G groups: boxes (G, N, 4) or one shared (N, 4) set,
    scores (G, N), the first ``n_valid[g]`` boxes of each group considered;
    a box is kept iff no box kept before it in descending score order
    overlaps it by IoU > ``thresh``."""
    G, N = scores.shape
    pad = torch.arange(N, device=scores.device)[None] >= n_valid[:, None]
    order = torch.sort(scores.masked_fill(pad, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    over = box_iou(boxes, boxes) > thresh
    kept = torch.zeros((G, N), dtype=torch.bool, device=scores.device)
    groups = torch.arange(G, device=scores.device)
    for i in range(N):
        cur = order[:, i]
        rows = over[cur] if boxes.dim() == 2 else over[groups, cur]
        kept[groups, cur] = ~(rows & kept).any(dim=1) & (i < n_valid)
    return kept


def anchors(h: int, w: int, stride: int, size: int,
            ratios: Sequence[float]) -> np.ndarray:
    ys = (np.arange(h) + 0.5) * stride
    xs = (np.arange(w) + 0.5) * stride
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    out = []
    for r in ratios:
        aw, ah = size * math.sqrt(1.0 / r), size * math.sqrt(r)
        out.append(np.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2,
                             cy + ah / 2], axis=-1))
    return np.stack(out, axis=2).reshape(-1, 4).astype(np.float32)


def decode(anc: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    aw, ah = anc[:, 2] - anc[:, 0], anc[:, 3] - anc[:, 1]
    cx, cy = anc[:, 0] + aw / 2, anc[:, 1] + ah / 2
    dx, dy, dw, dh = deltas.unbind(1)
    dw = torch.clamp(dw, max=math.log(1000.0 / 16))
    dh = torch.clamp(dh, max=math.log(1000.0 / 16))
    px, py = cx + dx * aw, cy + dy * ah
    pw, ph = aw * torch.exp(dw), ah * torch.exp(dh)
    return torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2],
                       dim=1)


def propose(w, d: DetDims, feats: List[torch.Tensor], hw: Tuple[int, int]
            ) -> torch.Tensor:
    img_h, img_w = float(hw[0]), float(hw[1])
    sels, tops, counts = [], [], []
    for f, stride, size in zip(feats, STRIDES, d.anchor_sizes):
        h = F.relu(F.conv2d(f, w["rpn.conv.weight"], w["rpn.conv.bias"],
                            padding=1))
        logit = F.conv2d(h, w["rpn.objectness.weight"],
                         w["rpn.objectness.bias"])
        delta = F.conv2d(h, w["rpn.deltas.weight"], w["rpn.deltas.bias"])
        anc = torch.from_numpy(anchors(f.shape[2], f.shape[3], stride, size,
                                       d.aspect_ratios)).to(f.device)
        scores = torch.sigmoid(logit.permute(0, 2, 3, 1).reshape(-1))
        boxes = decode(anc, delta.permute(0, 2, 3, 1).reshape(-1, 4))
        boxes = torch.stack([boxes[:, 0].clamp(0, img_w - 1),
                             boxes[:, 1].clamp(0, img_h - 1),
                             boxes[:, 2].clamp(0, img_w - 1),
                             boxes[:, 3].clamp(0, img_h - 1)], dim=1)
        bad = ((boxes[:, 2] - boxes[:, 0] < 1)
               | (boxes[:, 3] - boxes[:, 1] < 1))
        scores = torch.where(bad, torch.zeros_like(scores), scores)
        k = min(d.rpn_pre_nms_top_n, scores.shape[0])
        top, idx = top_k(scores, k)
        sels.append(boxes[idx])
        tops.append(top)
        counts.append(k)
    n = max(counts)
    keep = nms_keep(
        torch.stack([F.pad(b, (0, 0, 0, n - b.shape[0])) for b in sels]),
        torch.stack([F.pad(t, (0, n - t.shape[0])) for t in tops]),
        d.rpn_nms_thresh, torch.tensor(counts, device=feats[0].device))
    scores = torch.cat([torch.where(keep[g, :k], t, torch.zeros_like(t))
                        for g, (t, k) in enumerate(zip(tops, counts))])
    _, idx = top_k(scores, d.rpn_post_nms_top_n)
    return torch.cat(sels)[idx]


# ---------------------------------------------------------------- box head
def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def roi_align(maps: Sequence[torch.Tensor], boxes: torch.Tensor,
              res: int, sampling: int) -> torch.Tensor:
    """P2..P5 as (H, W, C) + (R, 4) pixel boxes → (R, res, res, C): each
    box from its level, bilinear at ``sampling``² points a bin, averaged."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    level = torch.clamp(torch.floor(4 + torch.log2(_div(
        torch.sqrt(torch.clamp_min(area, 1.0)), 224.0))), 2, 5).long() - 2
    out = None
    n = res * sampling
    for lvl, feat in enumerate(maps):
        H, W, C = feat.shape
        x1, y1, x2, y2 = (boxes / float(STRIDES[lvl])).unbind(1)
        steps = torch.arange(n, dtype=feat.dtype, device=feat.device) + 0.5
        gy = y1[:, None] + _div(steps[None] * (y2 - y1)[:, None], n)
        gx = x1[:, None] + _div(steps[None] * (x2 - x1)[:, None], n)
        yy, xx = torch.clamp(gy, 0.0, H - 1.0), torch.clamp(gx, 0.0, W - 1.0)
        y0 = torch.clamp(torch.floor(yy).long(), 0, H - 2)
        x0 = torch.clamp(torch.floor(xx).long(), 0, W - 2)
        wy = (yy - y0)[:, :, None, None]
        wx = (xx - x0)[:, None, :, None]
        ry, rx = y0[:, :, None], x0[:, None, :]
        vals = (feat[ry, rx] * (1 - wy) * (1 - wx)
                + feat[ry, rx + 1] * (1 - wy) * wx
                + feat[ry + 1, rx] * wy * (1 - wx)
                + feat[ry + 1, rx + 1] * wy * wx)
        pooled = vals.reshape(-1, res, sampling, res, sampling,
                              C).mean(dim=(2, 4))
        sel = (level == lvl)[:, None, None, None]
        out = pooled if out is None else torch.where(sel, pooled, out)
    return out


def box_head(w, d: DetDims, feats, proposals):
    maps = [f[0].permute(1, 2, 0) for f in feats[:4]]
    pooled = roi_align(maps, proposals, d.roi_resolution, d.roi_sampling)
    fc6 = F.relu(F.linear(pooled.reshape(pooled.shape[0], -1),
                          w["fc6.weight"], w["fc6.bias"]))
    fc7 = F.relu(F.linear(fc6, w["fc7.weight"], w["fc7.bias"]))
    cls = torch.softmax(F.linear(fc7, w["cls_score.weight"],
                                 w["cls_score.bias"]), dim=-1)
    return cls, fc6


def select(boxes: torch.Tensor, cls: torch.Tensor, num_keep: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(kept indices, number with a nonzero score, each box's best
    surviving score)."""
    s = cls[:, 1:]
    n, c = s.shape
    kept = nms_keep(boxes, s.t().contiguous(), 0.5,
                    torch.full((c,), n, device=s.device)).t()
    best = torch.where(kept & (s > 0), s, torch.zeros_like(s)).amax(dim=1)
    top, keep = top_k(best, num_keep)
    return keep, (top > 0).sum(), best


@dataclasses.dataclass
class Regions:
    """One image's extracted regions, the fields the question path reads,
    and what the comparison reads besides."""

    features: np.ndarray  # (n, representation_size) fc6
    boxes: np.ndarray  # (n, 4) original pixel coordinates
    width: int
    height: int
    # The comparison's handles on the reference's own state.
    feature_maps: List[torch.Tensor] = dataclasses.field(repr=False,
                                                         default=None)
    scale: float = 1.0
    best_score: np.ndarray = None  # (300,) each proposal's best score
    proposals: np.ndarray = None  # (300, 4) canvas pixel coordinates


def extract(w: Dict[str, torch.Tensor], d: DetDims, rgb: np.ndarray,
            device) -> Regions:
    """The extractor's regions of one (H, W, 3) uint8 RGB image."""
    h, wd = rgb.shape[:2]
    image, scale, hw = preprocess(rgb, d, device)
    feats = pyramid(w, d, image)
    proposals = propose(w, d, feats, hw)
    cls, fc6 = box_head(w, d, feats, proposals)
    keep, n_valid, best = select(proposals, cls, d.num_keep)
    n = int(min(int(n_valid), keep.shape[0])) or 1
    keep = keep[:n]
    return Regions(features=fc6[keep].cpu().numpy(),
                   boxes=(proposals[keep] / scale).cpu().numpy(),
                   width=wd, height=h, feature_maps=feats[:4], scale=scale,
                   best_score=best.cpu().numpy(),
                   proposals=proposals.cpu().numpy())


def pooled_features(w: Dict[str, torch.Tensor], d: DetDims, regions: Regions,
                    boxes: np.ndarray) -> np.ndarray:
    """The reference's fc6 features of any boxes (original pixel
    coordinates) on its own feature maps: how the comparison reads the
    features a served box should carry."""
    dev = regions.feature_maps[0].device
    b = torch.from_numpy(np.asarray(boxes, np.float32)).to(dev) * \
        regions.scale
    maps = [f[0].permute(1, 2, 0) for f in regions.feature_maps]
    pooled = roi_align(maps, b, d.roi_resolution, d.roi_sampling)
    return F.relu(F.linear(pooled.reshape(pooled.shape[0], -1),
                           w["fc6.weight"], w["fc6.bias"])).cpu().numpy()
