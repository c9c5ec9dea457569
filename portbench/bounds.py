"""The yardstick's arithmetic, frozen here so that a later change to the
program cannot move it: FLOPs of a served forward and of the detector, the
least time of each hand-written kernel's launch, the card's peaks, and
the union of device intervals.

- :func:`serving_forward_flops` is a copy of the program's
  ``engine/flops.py`` count (matmul FLOPs, 2·m·n·k, of one served forward:
  embeddings, both encoders, the bridges, the poolers and the nine heads,
  text padded to 37 tokens and regions to 101).
- :func:`attention_bound_s` and :func:`layer_norm_bound_s` are the bytes
  and operations of ``chip_smoke.py``'s kernel checks: each input read
  once and each output written once at the HBM rate, against the
  attention's 4·B·H·Nq·Nk·D FLOP at the bf16 tensor-core peak or the
  LayerNorm's 8 operations an element on the CUDA cores.
- :func:`union_s` is ``engine/profile_run.py``'s ``_union_us``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense rates (the card reports "NVIDIA H100
# 80GB HBM3"): bf16 tensor cores, float32 outside them, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989.4e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
LN_FLOP_PER_ELEMENT = 8  # add, sum, square and sum, subtract, scale, fma


def _dense(n: int, d_in: int, d_out: int) -> int:
    return 2 * n * d_in * d_out


def _self_attn_layer(n: int, hidden: int, inter: int) -> int:
    return (_dense(n, hidden, 3 * hidden) + 2 * 2 * n * n * hidden
            + _dense(n, hidden, hidden)
            + _dense(n, hidden, inter) + _dense(n, inter, hidden))


def _bridge(nt: int, nv: int, m: dict) -> int:
    h, hv, bi = m["hidden_size"], m["v_hidden_size"], m["bi_hidden_size"]
    t_dir = (_dense(nt, h, bi) + 2 * _dense(nv, hv, bi)
             + 2 * 2 * nt * nv * bi + _dense(nt, bi, h))
    v_dir = (_dense(nv, hv, bi) + 2 * _dense(nt, h, bi)
             + 2 * 2 * nv * nt * bi + _dense(nv, bi, hv))
    ffns = (_dense(nt, h, m["intermediate_size"])
            + _dense(nt, m["intermediate_size"], h)
            + _dense(nv, hv, m["v_intermediate_size"])
            + _dense(nv, m["v_intermediate_size"], hv))
    return t_dir + v_dir + ffns


def serving_forward_flops(m: dict, e: dict, batch: int) -> int:
    """Matmul FLOPs of one served forward of ``batch`` rows; ``m`` and ``e``
    are a configuration file's ``model`` and ``engine`` groups."""
    nt, nv = e["max_text_len"], e["max_regions"]
    bi = m["bi_hidden_size"]
    per_row = (_dense(nv, m["v_feature_size"], m["v_hidden_size"])
               + _dense(nv, 5, m["v_hidden_size"])
               + m["num_hidden_layers"] * _self_attn_layer(
                   nt, m["hidden_size"], m["intermediate_size"])
               + m["v_num_hidden_layers"] * _self_attn_layer(
                   nv, m["v_hidden_size"], m["v_intermediate_size"])
               + len(m["v_biattention_id"]) * _bridge(nt, nv, m)
               + _dense(1, m["hidden_size"], bi) + _dense(1, m["v_hidden_size"],
                                                          bi)
               + _dense(1, bi, 2 * bi) + _dense(1, 2 * bi, m["num_labels"])
               + _dense(1, bi, 2 * bi) + _dense(1, 2 * bi,
                                                m["gqa_num_labels"])
               + _dense(1, bi, 1) + _dense(1, bi, 3)
               + (_dense(1, 2 * bi, 4 * bi) + _dense(1, 4 * bi, 2)) // 2
               + _dense(nv, m["v_hidden_size"], 1)
               + _dense(nt, m["hidden_size"], 1))
    return batch * per_row


def attention_bound_s(B, Nq, Nk, H, D, itemsize=2) -> float:
    n_bytes = itemsize * (2 * B * Nq * H * D + 2 * B * Nk * H * D + B * Nk)
    flops = 4 * B * H * Nq * Nk * D
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def layer_norm_bound_s(n: int, residual: bool, width: int, itemsize=2,
                       param_itemsize=4) -> float:
    n_bytes = (itemsize * n * (3 if residual else 2)
               + param_itemsize * width * 2)
    return max(n_bytes / PEAK_BYTES_PER_S,
               LN_FLOP_PER_ELEMENT * n / PEAK_F32_FLOPS)


def forward_kernel_bounds(m: dict, e: dict, B: int
                          ) -> Dict[str, Tuple[int, float]]:
    """(launches, summed least seconds) of each hand-written kernel family
    in one bf16 forward of ``B`` rows: ``flash_attn`` (the 12 bridge
    directions and the 6 visual self-attentions), ``dense_attention`` (the
    12 text self-attentions), ``add_layer_norm`` (both embeddings, two a
    layer, four a bridge, the label pair's and, at an even B, the NLVR2
    head's)."""
    nt, nv = e["max_text_len"] + 1, e["max_regions"]
    h, hv, bi = m["hidden_size"], m["v_hidden_size"], m["bi_hidden_size"]
    hb, hvh = m["bi_num_attention_heads"], m["v_num_attention_heads"]
    n_bridges = len(m["v_biattention_id"])
    flash = (n_bridges * (attention_bound_s(B, nt, nv, hb, bi // hb)
                          + attention_bound_s(B, nv, nt, hb, bi // hb))
             + m["v_num_hidden_layers"] * attention_bound_s(
                 B, nv, nv, hvh, hv // hvh))
    th = m["num_attention_heads"]
    dense = m["num_hidden_layers"] * attention_bound_s(B, nt, nt, th, h // th)
    t_ln = layer_norm_bound_s(B * nt * h, True, h)
    v_ln = layer_norm_bound_s(B * nv * hv, True, hv)
    ln = (layer_norm_bound_s(B * nt * h, False, h) + v_ln
          + 2 * m["num_hidden_layers"] * t_ln
          + 2 * m["v_num_hidden_layers"] * v_ln
          + n_bridges * 2 * (t_ln + v_ln)
          + layer_norm_bound_s(B * 2 * 2 * bi, False, 2 * 2 * bi))
    n_ln = 2 + 2 * m["num_hidden_layers"] + 2 * m["v_num_hidden_layers"] \
        + 4 * n_bridges + 1
    if B % 2 == 0:
        ln += layer_norm_bound_s(B // 2 * 2 * bi, False, 2 * bi)
        n_ln += 1
    return {"flash_attn": (2 * n_bridges + m["v_num_hidden_layers"], flash),
            "dense_attention": (m["num_hidden_layers"], dense),
            "add_layer_norm": (n_ln, ln)}


# The kernels' names in a device trace.
KERNEL_NAMES = {"flash_attn": "flash_attn", "dense_attention":
                "dense_attention_kernel", "add_layer_norm":
                "add_layer_norm_kernel"}


def _conv(cin, cout, k, h, w, groups=1) -> int:
    return 2 * (cin // groups) * k * k * cout * h * w


def detector_flops(d: dict, h: int, w: int) -> int:
    """Convolution and Linear FLOPs (2 per multiply-add) of the extractor
    on an ``h`` x ``w`` input: the stem, the ResNeXt stages, the FPN, the
    RPN head on P2-P6 and the box head on ``rpn_post_nms_top_n``
    proposals."""
    H, W = math.ceil(h / 2), math.ceil(w / 2)
    total = _conv(3, d["stem_channels"], 7, H, W)
    H, W = math.ceil(H / 2), math.ceil(W / 2)
    cin = d["stem_channels"]
    sizes = []
    for s, (blocks, cout) in enumerate(zip(d["stage_blocks"],
                                           d["stage_channels"])):
        mid = d["groups"] * d["width_per_group"] * 2 ** s
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            Ho, Wo = math.ceil(H / stride), math.ceil(W / stride)
            total += _conv(cin, mid, 1, H, W)
            total += _conv(mid, mid, 3, Ho, Wo, d["groups"])
            total += _conv(mid, cout, 1, Ho, Wo)
            if cin != cout or stride != 1:
                total += _conv(cin, cout, 1, Ho, Wo)
            H, W, cin = Ho, Wo, cout
        sizes.append((H, W, cout))
    f = d["fpn_channels"]
    levels = []
    for H, W, c in sizes:
        total += _conv(c, f, 1, H, W) + _conv(f, f, 3, H, W)
        levels.append((H, W))
    levels.append((math.ceil(levels[-1][0] / 2), math.ceil(levels[-1][1] / 2)))
    a = len(d["aspect_ratios"])
    for H, W in levels:
        total += (_conv(f, f, 3, H, W) + _conv(f, a, 1, H, W)
                  + _conv(f, 4 * a, 1, H, W))
    r, rep = d["rpn_post_nms_top_n"], d["representation_size"]
    total += (_dense(r, d["roi_resolution"] ** 2 * f, rep)
              + _dense(r, rep, rep) + _dense(r, rep, d["num_classes"]))
    return total


def padded_input(width: int, height: int, d: dict) -> Tuple[int, int]:
    """The (h, w) an image of ``width`` x ``height`` is resized to (short
    side 800, long side at most 1333, within the canvas), each rounded up
    to a multiple of 32."""
    max_size = min(1333, d["canvas"])
    min_size = min(800, max_size)
    scale = min_size / min(height, width)
    if max(height, width) * scale > max_size:
        scale = max_size / max(height, width)
    nh, nw = int(round(height * scale)), int(round(width * scale))
    return 32 * math.ceil(nh / 32), 32 * math.ceil(nw / 32)


def union_s(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
