"""Weight-only int8 quantization for the serving state.

Counterpart of ``vilbert_multitask_tpu/quant.py``, over this package's flat
upstream-key state dicts (numpy arrays or tensors). With
``EngineConfig.param_dtype="int8"`` every floating leaf with ``ndim >= 2``
is stored as a per-channel symmetric pair ``{"int8": q, "scale": s}`` and
dequantized next to the product that reads it (ops/int8_linear.py).

Scheme, the JAX package's exactly:

- ``scale[c] = max|x[..., c]| / 127`` over every axis but the channel axis;
  a zero channel gets 1.0;
- ``q = clip(round(x / scale), -127, 127)`` as int8, rounding half to even;
- only floating leaves with ``ndim >= 2`` are quantized; vectors (biases,
  LayerNorm parameters) stay floating;
- already-quantized pairs pass through, so quantizing twice (a restore,
  then ``load_params``) changes nothing.

The channel axis. The JAX package quantizes over the last axis of its
``(in, out)`` kernels: one scale per output column. This package keeps
torch's ``(out, in)`` Linear weights, so that axis is the FIRST here: one
scale per output row (:func:`channel_axis`). Embedding tables are ``(rows,
hidden)`` in both packages, and their scale runs per hidden column (the
last axis). The JAX model fuses q/k/v into one ``qkv`` kernel; with one
scale per output column, splitting it into the upstream query/key/value
Linears leaves every value and scale the same.

Quantization runs on the host in f32 with numpy, the JAX host path's own
operations (``quant.py:76-80`` there), so the values are bit-equal to it;
a CUDA tensor is copied to the host first. Dequantizing in a dtype is
``q.to(dtype) * s.to(dtype)`` along the channel axis, as
``dequantize_leaf`` does in JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

QVALUES = "int8"
QSCALE = "scale"

_QKEYS = frozenset((QVALUES, QSCALE))
# Upstream keys of the (rows, hidden) lookup tables (and the masked-LM
# decoder tied to the word table): quantized per hidden column.
_TABLE_KEY = re.compile(
    r"(^|\.)(word|position|token_type|task)_embeddings\.weight$"
    r"|^cls\.predictions\.decoder\.weight$")


def is_quantized_leaf(x: Any) -> bool:
    """True for one ``{"int8": values, "scale": scales}`` pair."""
    return isinstance(x, Mapping) and set(x.keys()) == _QKEYS


def tree_is_quantized(params: Any) -> bool:
    """True when the tree (nested dicts, lists or tuples) holds at least one
    quantized pair. Matches the pair's structure, not leaf names."""
    if is_quantized_leaf(params):
        return True
    if isinstance(params, Mapping):
        return any(tree_is_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(tree_is_quantized(v) for v in params)
    return False


def channel_axis(key: str) -> int:
    """The axis that keeps one scale per entry for the leaf at upstream key
    ``key``: -1 for the embedding tables, 0 (the output rows) for every
    Linear weight."""
    return -1 if _TABLE_KEY.search(key) else 0


def leaf_to(value, device=None):
    """A state-dict value (array, tensor or pair) as tensors, on ``device``
    when one is given."""
    if is_quantized_leaf(value):
        return {k: leaf_to(v, device) for k, v in value.items()}
    if isinstance(value, np.ndarray) and not value.flags.writeable:
        value = value.copy()  # torch wraps only writable arrays
    t = torch.as_tensor(value)
    return t if device is None else t.to(device)


def _host_f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def quantize_leaf(x, axis: int = -1, *, jit_arithmetic: bool = False
                  ) -> dict:
    """One floating leaf (ndim >= 2) -> ``{"int8": q, "scale": s}``: ``q``
    keeps the leaf's shape, ``s`` is f32 with one entry per index of
    ``axis``. Numpy in, numpy out; a tensor in gives CPU tensors out.

    ``jit_arithmetic`` reproduces the JAX function under ``jax.jit``
    rather than on the host: there XLA turns ``amax / 127`` into
    ``amax * f32(1 / 127)``, which differs from the division by an ulp of
    some scales (the JAX engine quantizes host trees on the host and its
    head slabs under jit)."""
    xf = _host_f32(x)
    axis = axis % xf.ndim
    axes = tuple(a for a in range(xf.ndim) if a != axis)
    amax = np.max(np.abs(xf), axis=axes)
    step = amax * np.float32(1.0 / 127.0) if jit_arithmetic else amax / 127.0
    scale = np.where(amax == 0.0, np.ones_like(amax),
                     step).astype(np.float32)
    q = np.clip(np.round(xf / np.expand_dims(scale, axes)), -127,
                127).astype(np.int8)
    if torch.is_tensor(x):
        return {QVALUES: torch.from_numpy(q), QSCALE: torch.from_numpy(scale)}
    return {QVALUES: q, QSCALE: scale}


def dequantize_leaf(pair: Mapping, dtype: torch.dtype,
                    axis: int = -1) -> torch.Tensor:
    """``{"int8", "scale"}`` -> a dense tensor in ``dtype``:
    ``q.to(dtype) * s.to(dtype)`` with ``s`` along ``axis``."""
    q = torch.as_tensor(pair[QVALUES])
    s = torch.as_tensor(pair[QSCALE]).to(q.device)
    axis = axis % q.dim()
    shape = [1] * q.dim()
    shape[axis] = q.shape[axis]
    return q.to(dtype) * s.to(dtype).reshape(shape)


def quantize_tree(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Quantize every floating ``ndim >= 2`` leaf of an upstream-key state
    dict along its :func:`channel_axis`; pairs and everything else pass
    through untouched."""
    out: Dict[str, Any] = {}
    for key, x in params.items():
        if (not is_quantized_leaf(x) and _is_float(x)
                and len(x.shape) >= 2):
            x = quantize_leaf(x, channel_axis(key))
        out[key] = x
    return out


def dequantize_tree(params: Mapping[str, Any],
                    dtype: torch.dtype) -> Dict[str, Any]:
    """Every pair back to a dense ``dtype`` tensor and every other floating
    leaf cast to ``dtype``: the view the JAX engine's forward computes
    with (``quant.dequantize_tree``)."""
    out: Dict[str, Any] = {}
    for key, x in params.items():
        if is_quantized_leaf(x):
            x = dequantize_leaf(x, dtype, channel_axis(key))
        elif _is_float(x):
            x = torch.as_tensor(x).to(dtype)
        out[key] = x
    return out


def _is_float(x) -> bool:
    if torch.is_tensor(x):
        return x.is_floating_point()
    return isinstance(x, np.ndarray) and x.dtype.kind == "f"
