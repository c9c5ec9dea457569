"""Megatron tensor parallelism: the tp operators and the sharded layers.

In the JAX package XLA inserts the collectives that the partition rules
(parallel/sharding.py) imply; here they are written out, as three
``torch.autograd.Function`` s over the tp axis (an :class:`..mesh.Axis`):

- :func:`copy_to_tp`: the identity forward, an all-reduce of the gradient
  backward (the input of a column-parallel product is replicated, and each
  rank's product sees only its columns);
- :func:`reduce_from_tp`: an all-reduce forward, the identity backward
  (the close of a row-parallel product). ``torch.distributed.nn.
  functional.all_reduce`` is not this operator: its backward all-reduces
  again, which multiplies the gradient by tp;
- :func:`gather_from_tp`: an all-gather along a dimension forward, this
  rank's slice of the gradient backward (every rank then holds the whole
  activation and computes the same loss on it).

On top of them the layers keep ``nn.Linear`` / ``nn.Embedding``'s state-
dict keys with this rank's shard of the tensors:

- :class:`ColumnParallelLinear` holds its rows of the weight (output
  features, torch's dim 0) and of the bias;
- :class:`RowParallelLinear` holds its columns of the weight (input
  features, dim 1) and the whole bias, added once after the reduce;
- :class:`VocabParallelEmbedding` holds its rows of the table: ids outside
  them look up row 0, their rows are zeroed, and the tp sum fills them;
- the int8 forms over models/int8.py's pairs: a column shard slices the
  int8 rows and their per-row scales, a row shard slices the int8 columns
  and keeps every scale (the scale is per output row), and the vocabulary
  shard slices rows and keeps the per-column scales.

:func:`parallelize` swaps a model's modules for these by the rules, on the
meta device, before the model gets storage. An attention whose heads tp
does not divide stays whole on every rank, with the products that read its
context (XLA re-lays such shards out; here the rank computes every head).
:func:`layout` reports, for a parallelized model, the dim each state-dict
leaf is sharded on: the one answer ``parallel/sharding.py`` slices and
gathers by.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vilbert_multitask_tpu_torch.models.int8 import (
    QuantEmbedding,
    QuantLinear,
)
from vilbert_multitask_tpu_torch.ops.int8_linear import int8_linear
from vilbert_multitask_tpu_torch.parallel import comm


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, grad):
        return comm.all_reduce(grad.contiguous().clone(), ctx.axis), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return comm.all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return comm.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.shape[ctx.dim] // ctx.axis.size
        return (grad.narrow(ctx.dim, ctx.axis.index * part, part)
                .contiguous(), None, None)


class _ScatterToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        part = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * part, part).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return comm.all_gather(grad, ctx.axis, ctx.dim), None, None


def copy_to_tp(x: torch.Tensor, axis) -> torch.Tensor:
    if axis.size == 1:
        return x
    return _CopyToTp.apply(x, axis)


def reduce_from_tp(x: torch.Tensor, axis) -> torch.Tensor:
    if axis.size == 1:
        return x
    return _ReduceFromTp.apply(x, axis)


def gather_from_tp(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    if axis.size == 1:
        return x
    return _GatherFromTp.apply(x, axis, dim % x.dim())


def scatter_to_tp(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """This rank's slice of a replicated activation along ``dim`` (the
    gradient is all-gathered back)."""
    if axis.size == 1:
        return x
    return _ScatterToTp.apply(x, axis, dim % x.dim())


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear`` holding this rank's ``out / tp`` output rows; its
    output is this rank's slice of the features, or, with
    ``gather_output``, all of them (for a LayerNorm that follows, as in
    the classifiers)."""

    gather_output = False

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 axis, device=None, dtype=None):
        super().__init__(in_features, out_features // axis.size, bias,
                         device=device, dtype=dtype)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(copy_to_tp(x, self.axis), self.weight, self.bias)
        return gather_from_tp(y, self.axis) if self.gather_output else y


class RowParallelLinear(nn.Linear):
    """``nn.Linear`` holding this rank's ``in / tp`` input columns and the
    whole bias: the partial products are summed over tp, then the bias is
    added once. Its input is this rank's slice of the features, or, with
    ``input_is_parallel = False``, all of them (sliced here)."""

    input_is_parallel = True

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 axis, device=None, dtype=None):
        super().__init__(in_features // axis.size, out_features, bias,
                         device=device, dtype=dtype)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = scatter_to_tp(x, self.axis)
        y = reduce_from_tp(F.linear(x, self.weight), self.axis)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _masked_ids(ids: torch.Tensor, rows: int, axis):
    """This rank's row of each id (0 outside its range) and the mask of
    the ids outside it."""
    start = axis.index * rows
    outside = (ids < start) | (ids >= start + rows)
    return (ids - start).masked_fill(outside, 0), outside


class VocabParallelEmbedding(nn.Embedding):
    """``nn.Embedding`` holding this rank's ``rows / tp`` rows."""

    def __init__(self, num_embeddings: int, embedding_dim: int, axis,
                 device=None, dtype=None):
        super().__init__(num_embeddings // axis.size, embedding_dim,
                         device=device, dtype=dtype)
        self.axis = axis

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local, outside = _masked_ids(ids, self.num_embeddings, self.axis)
        out = F.embedding(local, self.weight).masked_fill(
            outside[..., None], 0.0)
        return reduce_from_tp(out, self.axis)


class QuantColumnParallelLinear(QuantLinear):
    """:class:`..models.int8.QuantLinear` holding this rank's output rows
    and their scales (``gather_output`` as :class:`ColumnParallelLinear`)."""

    gather_output = False

    def __init__(self, lin: QuantLinear, axis, device=None):
        super().__init__(lin.in_features, lin.out_features // axis.size,
                         lin.bias is not None,
                         compute_dtype=lin.compute_dtype, device=device)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(copy_to_tp(x, self.axis))
        return gather_from_tp(y, self.axis) if self.gather_output else y


class QuantRowParallelLinear(QuantLinear):
    """:class:`..models.int8.QuantLinear` holding this rank's input
    columns, every row's scale and the whole bias (``input_is_parallel``
    as :class:`RowParallelLinear`)."""

    input_is_parallel = True

    def __init__(self, lin: QuantLinear, axis, device=None):
        super().__init__(lin.in_features // axis.size, lin.out_features,
                         lin.bias is not None,
                         compute_dtype=lin.compute_dtype, device=device)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = scatter_to_tp(x, self.axis)
        y = reduce_from_tp(int8_linear(
            x, self.qweight, self.kernel_scale, None,
            scale_bf16=self.compute_dtype == torch.bfloat16), self.axis)
        return y if self.kernel_bias is None else y + self.kernel_bias


class QuantVocabParallelEmbedding(QuantEmbedding):
    """:class:`..models.int8.QuantEmbedding` holding this rank's rows and
    every column's scale."""

    def __init__(self, emb: QuantEmbedding, axis, device=None):
        super().__init__(emb.num_embeddings // axis.size, emb.embedding_dim,
                         compute_dtype=emb.compute_dtype, device=device)
        self.axis = axis

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local, outside = _masked_ids(ids, self.num_embeddings, self.axis)
        out = super().forward(local).masked_fill(outside[..., None], 0.0)
        return reduce_from_tp(out, self.axis)


def _sharded(module: nn.Module, dim: int, axis) -> nn.Module:
    """The tp form of ``module`` for a shard of its weight's ``dim``."""
    dev = next(iter(module.buffers() if isinstance(
        module, (QuantLinear, QuantEmbedding)) else module.parameters())
    ).device
    if isinstance(module, QuantLinear):
        cls = QuantColumnParallelLinear if dim == 0 else \
            QuantRowParallelLinear
        return cls(module, axis, device=dev)
    if isinstance(module, QuantEmbedding):
        return QuantVocabParallelEmbedding(module, axis, device=dev)
    if isinstance(module, nn.Embedding):
        return VocabParallelEmbedding(module.num_embeddings,
                                      module.embedding_dim, axis,
                                      device=dev, dtype=module.weight.dtype)
    cls = ColumnParallelLinear if dim == 0 else RowParallelLinear
    return cls(module.in_features, module.out_features,
               module.bias is not None, axis, device=dev,
               dtype=module.weight.dtype)


def _weight_shape(module: nn.Module) -> Optional[tuple]:
    if isinstance(module, QuantLinear):
        return (module.out_features, module.in_features)
    if isinstance(module, QuantEmbedding):
        return (module.num_embeddings, module.embedding_dim)
    if isinstance(module, (nn.Linear, nn.Embedding)):
        return tuple(module.weight.shape)
    return None


def _whole_attentions(model: nn.Module, tp: int) -> set:
    """Ids of the modules kept whole on every rank: each attention whose
    ``num_heads`` tp does not divide, with the products that read its
    context (a self-attention's ``output``; both streams' ``biOutput`` of a
    bridge). Decided per attention, not per weight: a projection's columns
    often divide where its heads do not (the tiny visual q/k/v's 32
    columns over tp = 4, 2 heads; the full width's 8 visual and bridge
    heads at tp = 3)."""
    from vilbert_multitask_tpu_torch.models.layers import (
        ConnectionLayer,
        SelfAttentionBlock,
    )

    whole = set()
    for mod in model.modules():
        if isinstance(mod, SelfAttentionBlock):
            parts = (mod,) if mod.self.num_heads % tp else ()
        elif isinstance(mod, ConnectionLayer):
            parts = ((mod.biattention, mod.biOutput)
                     if mod.biattention.num_heads % tp else ())
        else:
            continue
        whole.update(id(m) for part in parts for m in part.modules())
    return whole


def parallelize(model: nn.Module, mesh) -> nn.Module:
    """Swap, in place, every Linear / Embedding (or its int8 form) whose
    weight the rules shard over tp (parallel/sharding.py:
    :func:`..sharding.shard_dim`) for its tp form, and give each sharded
    attention the count of heads its shard holds. An attention whose heads
    tp does not divide stays whole, with its output products
    (:func:`_whole_attentions`). Call it on the meta device, after
    ``models.int8.quantize_modules`` for an int8 model and before
    ``to_empty``; the tied masked-LM decoder follows the word table.
    Returns ``model``."""
    from vilbert_multitask_tpu_torch.models.heads import (
        SimpleClassifier,
        TextPredictionHead,
    )
    from vilbert_multitask_tpu_torch.models.int8 import TiedTableDecoder
    from vilbert_multitask_tpu_torch.models.layers import BiAttention
    from vilbert_multitask_tpu_torch.ops.attention import FusedSelfAttention
    from vilbert_multitask_tpu_torch.parallel.mesh import axis as mesh_axis
    from vilbert_multitask_tpu_torch.parallel.sharding import shard_dim

    tp = mesh_axis(mesh, "tp")
    if tp.size == 1:
        return model
    names = {id(m): n for n, m in model.named_modules()}
    whole = _whole_attentions(model, tp.size)
    swapped = {}  # id of the old module -> (the old module, its tp form)
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            shape = _weight_shape(child)
            if (shape is None or id(child) in whole
                    or isinstance(child, TiedTableDecoder)):
                continue
            key = f"{names[id(child)]}.weight"
            if key == "cls.predictions.decoder.weight":
                continue  # tied to the word table: follows it below
            dim = shard_dim(key, shape, tp.size)
            if dim is not None:
                new = _sharded(child, dim, tp)
                swapped[id(child)] = (child, new)
                setattr(parent, child_name, new)
    tables = {id(old.weight): new for old, new in swapped.values()
              if isinstance(old, nn.Embedding)}
    for mod in model.modules():
        if isinstance(mod, TiedTableDecoder):
            old = mod._table[0]
            mod._table = (swapped.get(id(old), (old, old))[1],)
        elif isinstance(mod, TextPredictionHead):
            table = (tables.get(id(mod.decoder.weight))
                     if isinstance(mod.decoder, nn.Linear) else None)
            if table is not None:
                dec = ColumnParallelLinear(
                    mod.decoder.in_features, mod.decoder.out_features,
                    False, tp, device=table.weight.device,
                    dtype=table.weight.dtype)
                dec.weight = table.weight
                mod.decoder = dec
                mod.tp_axis = tp
        elif isinstance(mod, SimpleClassifier):
            # dense1 → GELU → LayerNorm → dense2: the LayerNorm needs every
            # feature, so dense1 gathers its output and dense2 slices it.
            first, last = mod.logit_fc[0], mod.logit_fc[3]
            if hasattr(first, "gather_output"):
                first.gather_output = True
            if hasattr(last, "input_is_parallel"):
                last.input_is_parallel = False
        elif isinstance(mod, (FusedSelfAttention, BiAttention)):
            query = (mod.query if isinstance(mod, FusedSelfAttention)
                     else mod.query1)
            if isinstance(query, (ColumnParallelLinear,
                                  QuantColumnParallelLinear)):
                mod.num_heads //= tp.size
    return model


def layout(model: nn.Module) -> Dict[str, int]:
    """State-dict key → the dim its tp layer shards, for every leaf of
    ``model.state_dict()`` that is a tp shard: column and vocabulary
    layers (their int8 forms and the tied decoder included) dim 0 of the
    weight and the bias; row layers dim 1 of the weight, the bias whole.
    Every other leaf, a whole attention's among them, is replicated. Empty
    off a mesh."""
    from vilbert_multitask_tpu_torch.models.int8 import TiedTableDecoder

    out: Dict[str, int] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, TiedTableDecoder):
            mod = mod._table[0]
        if isinstance(mod, (ColumnParallelLinear, VocabParallelEmbedding,
                            QuantColumnParallelLinear,
                            QuantVocabParallelEmbedding)):
            out[pre + "weight"] = 0
            if getattr(mod, "bias", None) is not None:
                out[pre + "bias"] = 0
        elif isinstance(mod, (RowParallelLinear, QuantRowParallelLinear)):
            out[pre + "weight"] = 1
    return out


def layout_for(cfg, mesh) -> Dict[str, int]:
    """:func:`layout` of a ``ViLBertConfig``'s model on ``mesh`` (built and
    parallelized on the meta device): how a state dict of that model
    shards when no model is at hand (``checkpoint.restore_params(...,
    mesh=)``)."""
    from vilbert_multitask_tpu_torch.models.vilbert import ViLBertForVLTasks

    with torch.device("meta"):
        return layout(parallelize(ViLBertForVLTasks(cfg), mesh))


def shard_dims(model: nn.Module) -> dict:
    """Parameter name → the dim its tp layer shards (:func:`layout`
    restricted to ``model``'s parameters)."""
    params = dict(model.named_parameters())
    return {k: d for k, d in layout(model).items() if k in params}
