"""Analytic FLOP count of one serving forward, and the serving roofline.

Counterpart of ``vilbert_multitask_tpu/engine/flops.py``. Counts matmul
FLOPs (2·m·n·k per dense / attention product) of the serving graph:
embeddings, both single-stream encoders, the co-attention bridges, poolers
and the classifier heads, without the pretraining heads (the engine never
computes them). Elementwise, LayerNorm and softmax FLOPs are ignored; on
this model they are under 2% of the matmul count, so the figure is a
tight lower bound, the conservative direction for MFU (model FLOPs
utilisation: the share of the card's peak FLOP rate a forward uses).

It counts the same work at the same padded shapes as the JAX function, so
a share of peak reads the same whatever runs the forward.
``tests/test_torch_flops.py`` holds it equal to the JAX integers and within
the JAX test's band of what ``torch.utils.flop_counter.FlopCounterMode``
counts over the port's forward.

Peak rates are keyed on substrings of ``torch.cuda.get_device_name()``;
a card gets an entry only with a named source. Unknown kinds (CPU runs)
state the roofline against the reference card, the H100 SXM, and say so.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch

from vilbert_multitask_tpu_torch.config import EngineConfig, ViLBertConfig


def _dense(n: int, d_in: int, d_out: int) -> int:
    return 2 * n * d_in * d_out


def _self_attn_layer(n: int, hidden: int, inter: int) -> int:
    """Q/K/V projections, attention, output projection and FFN of one
    single-stream layer (models/layers.py:TransformerLayer)."""
    return (
        _dense(n, hidden, 3 * hidden)  # query, key, value
        + 2 * 2 * n * n * hidden  # scores + probs·V
        + _dense(n, hidden, hidden)  # attention output projection
        + _dense(n, hidden, inter) + _dense(n, inter, hidden)  # FFN
    )


def _bridge(nt: int, nv: int, cfg: ViLBertConfig) -> int:
    """One ConnectionLayer: both cross-attention directions, the per-stream
    output projections and FFNs (models/layers.py:ConnectionLayer)."""
    h, hv, bi = cfg.hidden_size, cfg.v_hidden_size, cfg.bi_hidden_size
    t_dir = (
        _dense(nt, h, bi)  # text queries
        + 2 * _dense(nv, hv, bi)  # image keys + values
        + 2 * 2 * nt * nv * bi  # scores + probs·V
        + _dense(nt, bi, h)  # text output projection
    )
    v_dir = (
        _dense(nv, hv, bi)
        + 2 * _dense(nt, h, bi)
        + 2 * 2 * nv * nt * bi
        + _dense(nv, bi, hv)
    )
    ffns = (
        _dense(nt, h, cfg.intermediate_size)
        + _dense(nt, cfg.intermediate_size, h)
        + _dense(nv, hv, cfg.v_intermediate_size)
        + _dense(nv, cfg.v_intermediate_size, hv)
    )
    return t_dir + v_dir + ffns


def serving_forward_flops(mcfg: ViLBertConfig, ecfg: EngineConfig,
                          batch: int) -> int:
    """Matmul FLOPs of one serving forward of ``batch`` rows (text always
    padded to ``max_text_len``, regions to ``max_regions``)."""
    nt, nv = ecfg.max_text_len, ecfg.max_regions
    per_row = 0
    # Image embeddings: feature + location projections.
    per_row += _dense(nv, mcfg.v_feature_size, mcfg.v_hidden_size)
    per_row += _dense(nv, 5, mcfg.v_hidden_size)
    # Encoders.
    per_row += mcfg.num_hidden_layers * _self_attn_layer(
        nt, mcfg.hidden_size, mcfg.intermediate_size)
    per_row += mcfg.v_num_hidden_layers * _self_attn_layer(
        nv, mcfg.v_hidden_size, mcfg.v_intermediate_size)
    per_row += mcfg.num_connection_layers * _bridge(nt, nv, mcfg)
    # Poolers into bi_hidden (models/heads.py:Pooler).
    bi = mcfg.bi_hidden_size
    per_row += (_dense(1, mcfg.hidden_size, bi)
                + _dense(1, mcfg.v_hidden_size, bi))
    # Classifier heads over the fused pooled vector.
    per_row += _dense(1, bi, 2 * bi) + _dense(1, 2 * bi, mcfg.num_labels)
    per_row += _dense(1, bi, 2 * bi) + _dense(1, 2 * bi, mcfg.gqa_num_labels)
    per_row += _dense(1, bi, 1) + _dense(1, bi, 3)  # vil_logit, tri
    # The paired NLVR2 head runs on batch/2 rows of width 2·bi.
    per_row += (_dense(1, 2 * bi, 4 * bi) + _dense(1, 4 * bi, 2)) // 2
    # Per-token grounding logits (vision_logit / linguisic_logit).
    per_row += (_dense(nv, mcfg.v_hidden_size, 1)
                + _dense(nt, mcfg.hidden_size, 1))
    return batch * per_row


# Peak dense bf16 tensor-core FLOP/s per card, keyed on substrings of
# torch.cuda.get_device_name(). Source: NVIDIA H100 Tensor Core GPU
# datasheet, H100 SXM column ("BF16 Tensor Core 1,979 teraFLOPS" with
# sparsity: half of it dense). "H100 80GB HBM3" is the name the SXM part
# reports.
PEAK_BF16_FLOPS = (
    ("h100 80gb hbm3", 989.4e12),
)

# Peak HBM bandwidth per card (bytes/s), same keying and source (H100 SXM:
# "GPU memory bandwidth 3.35TB/s").
PEAK_HBM_BYTES_PER_S = (
    ("h100 80gb hbm3", 3.35e12),
)

# Off the card (CPU runs, unknown device names) the roofline is stated
# against the reference card, and the reason string names the substitution.
_REFERENCE_CARD = ("NVIDIA H100 80GB HBM3 (H100 SXM)", 989.4e12, 3.35e12)


def peak_flops_for(device_kind: str) -> Optional[float]:
    dk = device_kind.lower()
    for key, peak in PEAK_BF16_FLOPS:
        if key in dk:
            return peak
    return None


def peak_hbm_bw_for(device_kind: str) -> Optional[float]:
    dk = device_kind.lower()
    for key, bw in PEAK_HBM_BYTES_PER_S:
        if key in dk:
            return bw
    return None


def param_tree_bytes(params: Any) -> int:
    """Total bytes of a state dict (nested dicts of tensors or arrays): the
    weight-read term of the serving roofline, every forward reading every
    parameter once. It sums what the tree stores, so an int8 tree (1-byte
    values plus their f32 scales, quant.py) reports its own footprint."""
    if isinstance(params, Mapping):
        return sum(param_tree_bytes(v) for v in params.values())
    if torch.is_tensor(params):
        return params.numel() * params.element_size()
    return int(np.asarray(params).nbytes)


def weight_bytes_per_row(param_bytes: int, batch: int) -> float:
    """Weight bytes read per batch row at ``batch``: what bigger batches
    and smaller storage dtypes both shrink."""
    return param_bytes / max(1, batch)


def _rates(device_kind: str):
    """(peak FLOP/s, HBM bytes/s, the reference card's name or None)."""
    peak = peak_flops_for(device_kind)
    bw = peak_hbm_bw_for(device_kind)
    if peak is None or bw is None:
        ref, peak, bw = _REFERENCE_CARD
        return peak, bw, ref
    return peak, bw, None


def knee_rows(mcfg: ViLBertConfig, ecfg: EngineConfig, device_kind: str,
              param_bytes: int) -> int:
    """The batch where the roofline verdict flips from weight-read-bound to
    compute-bound: the smallest ``batch`` with ``t_compute >= t_mem``.
    FLOPs grow linearly in batch while the weight reads stay flat, so the
    knee is ``ceil(param_bytes · peak / (bw · flops_per_row))``. Unknown
    device kinds compute against the reference card, as
    :func:`serving_roofline` does."""
    peak, bw, _ = _rates(device_kind)
    flops_per_row = serving_forward_flops(mcfg, ecfg, 1)
    return max(1, math.ceil(param_bytes * peak / (bw * flops_per_row)))


def serving_roofline(mcfg: ViLBertConfig, ecfg: EngineConfig, batch: int,
                     device_kind: str, param_bytes: int) -> dict:
    """Roofline cap on serving MFU at ``batch`` rows: a forward reads all
    ``param_bytes`` from HBM once (t_mem) and executes the analytic FLOPs
    (t_compute); achievable_mfu = t_compute / max(t_compute, t_mem).

    Well below 1 the forward is weight-read-bound: fewer weight bytes
    (``EngineConfig.param_dtype="int8"``) or bigger batches move it, more
    tensor-core throughput does not. Returns ``{"achievable_mfu",
    "reason"}``; unknown device kinds compute against the reference card so
    the fields are always present."""
    peak, bw, ref = _rates(device_kind)
    note = ("" if ref is None else
            f" [no spec table entry for {device_kind!r}; roofline stated "
            f"against {ref}]")
    flops = serving_forward_flops(mcfg, ecfg, batch)
    t_compute = flops / peak
    t_mem = param_bytes / bw
    mfu = t_compute / max(t_compute, t_mem)
    if t_mem > t_compute:
        reason = (
            f"weight-read-bound at batch {batch}: {param_bytes / 1e6:.0f} MB "
            f"params / {bw / 1e9:.0f} GB/s = {t_mem * 1e3:.2f} ms HBM vs "
            f"{t_compute * 1e3:.2f} ms compute — MFU caps at {mfu:.3f}")
    else:
        reason = (
            f"compute-bound at batch {batch}: {t_compute * 1e3:.2f} ms "
            f"compute vs {t_mem * 1e3:.2f} ms weight reads — MFU can "
            f"approach 1.0")
    return {"achievable_mfu": round(mfu, 4), "reason": reason + note}
