"""Partition rules (Megatron tp, dp batches) over the port's state dicts.

Counterpart of ``vilbert_multitask_tpu/parallel/sharding.py``, restated
over the upstream torch keys the port's modules carry (separate
``query``/``key``/``value`` where the JAX tree has one fused ``qkv``;
torch weights are ``(out, in)``, so output features are dim 0):

- expanding products shard their output features: the single-stream
  layers' query/key/value and ``intermediate.dense``, the bridges'
  ``biattention.{query,key,value}{1,2}`` and the classifiers' first
  product (``logit_fc.0``, JAX ``dense1``);
- contracting products shard their input features and keep their bias
  whole: ``attention.output.dense``, ``output.dense``, the bridges'
  ``biOutput.dense{1,2}`` and the classifiers' ``logit_fc.3`` (JAX
  ``dense2``);
- the word table shards its vocabulary, and with it the tied masked-LM
  decoder; the decoder's bias stays whole (the JAX rule for it,
  ``.*/cls_text/decoder_bias``, needs a path component before
  ``cls_text``, which sits at the top of the tree, so it never matches);
- everything else is replicated: LayerNorms, poolers, the image
  embeddings, the pretraining transforms, the small heads, and the
  bridges' own feed-forwards (``c_layer.*.{v,t}_intermediate`` /
  ``{v,t}_output``), which the JAX rules' ``.*/ffn/`` patterns do not
  reach either (their Flax names are ``v_ffn`` / ``t_ffn``);
- a leaf whose sharded dimension does not divide by tp is replicated
  (``_spec_fits``): the full vocabulary, 30522, divides by tp = 2 and not
  by 4.

A spec is a tuple of axis names per dimension, as a JAX ``PartitionSpec``
reads: ``("tp", None)`` for a column shard of a weight, ``(None, "tp")``
for a row shard, ``()`` for a replicated leaf. An int8 pair
(models/int8.py) shards its values like the weight; its per-channel scale
is sliced with the values when the shard runs along the scale's own axis
(a column shard of a Linear), and replicated otherwise. The JAX package
replicates every scale because XLA re-slices it; here the slicing is ours.

Each rank holds its own shards, so the JAX names that place arrays on
devices (``param_shardings``, ``batch_shardings``, ``shard_params``) have
no counterpart: :func:`param_specs`, :func:`shard_state_dict` and
:func:`place_batch` are the port's. The JAX ``cast_floating`` is the
port's ``checkpoint.store.cast_params``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vilbert_multitask_tpu_torch import quant
from vilbert_multitask_tpu_torch.parallel import comm
from vilbert_multitask_tpu_torch.parallel.mesh import axis as mesh_axis

_STREAM = r"bert\.encoder\.(layer|v_layer)\.\d+\."
_BRIDGE = r"bert\.encoder\.c_layer\.\d+\."
_CLASSIFIER = r"(vil_prediction|vil_prediction_gqa|vil_binary_prediction)"

# (regex over the upstream key, the torch dim sharded on tp). First match
# wins; no match is replicated.
_RULES: List[Tuple[str, int]] = [
    # --- expanding products: shard output features (weight rows, bias) ---
    (_STREAM + r"attention\.self\.(query|key|value)\.(weight|bias)$", 0),
    (_BRIDGE + r"biattention\.(query|key|value)[12]\.(weight|bias)$", 0),
    (_STREAM + r"intermediate\.dense\.(weight|bias)$", 0),
    (_CLASSIFIER + r"\.logit_fc\.0\.(weight|bias)$", 0),
    # --- contracting products: shard input features, bias whole ---
    (_STREAM + r"(attention\.output|output)\.dense\.weight$", 1),
    (_BRIDGE + r"biOutput\.dense[12]\.weight$", 1),
    (_CLASSIFIER + r"\.logit_fc\.3\.weight$", 1),
    # --- the vocabulary (the tied masked-LM decoder shards with it) ---
    (r"bert\.embeddings\.word_embeddings\.weight$", 0),
    (r"cls\.predictions\.decoder\.weight$", 0),
]


def shard_dim(key: str, shape, tp: int) -> Optional[int]:
    """The dim of the leaf at ``key`` (of global ``shape``) sharded over a
    tp axis of size ``tp``, or None (replicated)."""
    if tp <= 1:
        return None
    for pattern, dim in _RULES:
        if re.match(pattern, key):
            if dim >= len(shape) or shape[dim] % tp:
                return None  # _spec_fits: replicate what does not divide
            return dim
    return None


def _shape(value) -> tuple:
    if quant.is_quantized_leaf(value):
        value = value[quant.QVALUES]
    return tuple(value.shape)


def _scale_sharded(key: str, values_ndim: int, dim: Optional[int]) -> bool:
    return dim is not None and quant.channel_axis(key) % values_ndim == dim


def _spec(ndim: int, dim: Optional[int]) -> tuple:
    if dim is None:
        return ()
    return tuple("tp" if d == dim else None for d in range(ndim))


def param_specs(params: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """The spec of every leaf of a global state dict (a pair gets a
    ``{"int8": spec, "scale": spec}``)."""
    tp = mesh_axis(mesh, "tp").size
    out: Dict[str, Any] = {}
    for key, value in params.items():
        shape = _shape(value)
        dim = shard_dim(key, shape, tp)
        if quant.is_quantized_leaf(value):
            out[key] = {quant.QVALUES: _spec(len(shape), dim),
                        quant.QSCALE: _spec(1, 0) if _scale_sharded(
                            key, len(shape), dim) else ()}
        else:
            out[key] = _spec(len(shape), dim)
    return out


class ShardedStateDict(dict):
    """A state dict holding one rank's shards (``shard_state_dict``), so a
    loader can tell it from a global one."""


def _slice(t, dim: int, ax) -> torch.Tensor:
    t = quant.leaf_to(t)
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n).contiguous().clone()


def shard_state_dict(params: Mapping[str, Any], mesh) -> ShardedStateDict:
    """This rank's shard of a global state dict (arrays, tensors or int8
    pairs; on the host or a device): each tp-sharded leaf sliced to its
    tp index, the rest as they are. A dict that is already sharded passes
    through."""
    if isinstance(params, ShardedStateDict):
        return params
    ax = mesh_axis(mesh, "tp")
    out = ShardedStateDict()
    for key, value in params.items():
        shape = _shape(value)
        dim = shard_dim(key, shape, ax.size)
        if dim is None:
            out[key] = value
        elif quant.is_quantized_leaf(value):
            scale = value[quant.QSCALE]
            out[key] = {
                quant.QVALUES: _slice(value[quant.QVALUES], dim, ax),
                quant.QSCALE: (_slice(scale, 0, ax)
                               if _scale_sharded(key, len(shape), dim)
                               else scale)}
        else:
            out[key] = _slice(value, dim, ax)
    return out


def gather_state_dict(params: Mapping[str, Any], mesh,
                      global_shapes: Mapping[str, tuple]
                      ) -> Dict[str, Any]:
    """The inverse of :func:`shard_state_dict` (for checkpoints): every
    sharded leaf all-gathered over tp, given each key's global shape.
    Collective over the tp axis: every rank of it calls it."""
    ax = mesh_axis(mesh, "tp")
    out: Dict[str, Any] = {}
    for key in sorted(params):
        value = params[key]
        shape = tuple(global_shapes[key])
        dim = shard_dim(key, shape, ax.size)
        if dim is None:
            out[key] = value
        elif quant.is_quantized_leaf(value):
            scale = value[quant.QSCALE]
            out[key] = {
                quant.QVALUES: comm.all_gather(value[quant.QVALUES], ax,
                                               dim),
                quant.QSCALE: (comm.all_gather(scale, ax, 0)
                               if _scale_sharded(key, len(shape), dim)
                               else scale)}
        else:
            out[key] = comm.all_gather(quant.leaf_to(value), ax, dim)
    return {k: out[k] for k in params}


def batch_spec() -> tuple:
    """Activations: batch dim sharded over dp, everything else replicated."""
    return ("dp",)


def shards_batch(rows: int, dp: int) -> bool:
    """Whether a batch of ``rows`` shards over dp: the rows divide, and
    the paired NLVR2 head's pairs (rows 2k, 2k+1) stay on one rank (an even
    batch splits into even shards)."""
    if dp <= 1 or rows % dp:
        return False
    return rows % 2 == 1 or (rows // dp) % 2 == 0


def place_batch(batch: Mapping[str, Any], mesh, *, global_batch: bool = False,
                device=None) -> Dict[str, torch.Tensor]:
    """This rank's part of a batch (arrays or tensors), on ``device``: a
    leaf whose leading dim shards over dp (:func:`shards_batch`) is sliced
    to this rank's rows, the rest whole.

    One rank alone places the batch as it is. On a mesh of several ranks
    the only supported placement is ``global_batch=True``: the caller
    guarantees every rank holds the IDENTICAL global batch (the trainer
    draws from the global step; the engine's rank 0 broadcasts its
    dispatch first). Per-rank serving batches cannot be stitched into a
    global one, so the default raises."""
    from vilbert_multitask_tpu_torch.parallel.mesh import world_axis

    if world_axis(mesh).size > 1 and not global_batch:
        raise NotImplementedError(
            "batch placement on a mesh spanning processes needs "
            "global_batch=True (identical batch on every process) — "
            "per-host serving batches cannot shard onto a cross-process "
            "mesh; route requests per host instead")
    dp = mesh_axis(mesh, "dp")
    out = {}
    for key, leaf in batch.items():
        t = torch.as_tensor(np.asarray(leaf) if not torch.is_tensor(leaf)
                            else leaf)
        if t.dim() and shards_batch(t.shape[0], dp.size):
            n = t.shape[0] // dp.size
            t = t[dp.index * n:(dp.index + 1) * n]
        out[key] = t.to(device) if device is not None else t
    return out
