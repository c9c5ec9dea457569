"""The int8 storage mode's modules (``EngineConfig.param_dtype="int8"``).

:func:`quantize_modules` swaps, in place, every ``nn.Linear`` of a model
for a :class:`QuantLinear`, every ``nn.Embedding`` for a
:class:`QuantEmbedding` and every ``LayerNorm`` for a
:class:`RoundedLayerNorm`, so the module tree, and with it every upstream
state-dict key, stays what it was:

- ``model.load_state_dict(sd, strict=True)`` takes an f32 tree, quantized
  at load (``quant.quantize_leaf`` along the key's channel axis, on the
  host), or an already-quantized one (``{"int8", "scale"}`` pairs pass
  through);
- ``model.state_dict()`` returns the quantized tree: a pair under each
  matrix's key, the other leaves in f32.

Numerics are the JAX int8 engine's, whose forward computes with
``quant.dequantize_tree(params, compute_dtype)`` (every pair dequantized
as ``q.astype(dt) * s.astype(dt)``, every other floating leaf cast to dt):

- a :class:`QuantLinear` runs ``ops/int8_linear.py`` with its scale rounded
  to the compute dtype and its bias in it (flax ``Dense``'s two roundings);
- a :class:`QuantEmbedding` gathers int8 rows and dequantizes them after
  the gather, which is bit-equal to dequantizing the table first and reads
  only the rows used;
- a :class:`RoundedLayerNorm` keeps its f32 parameters (they are what the
  state dict holds) and computes with them rounded to the compute dtype,
  then promoted back to f32 as flax's ``LayerNorm`` does with bf16
  parameters (statistics and the affine step in f32): on the card the
  LayerNorm kernel reads the bf16 copies and promotes them in registers.

The masked-LM decoder is tied to the word table (:class:`TiedTableDecoder`):
its state-dict entry is that table's pair, and it is not served (no engine
forward computes the pretraining heads).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vilbert_multitask_tpu_torch import quant
from vilbert_multitask_tpu_torch.models.layers import LayerNorm
from vilbert_multitask_tpu_torch.ops import layer_norm as ln_ops
from vilbert_multitask_tpu_torch.ops.int8_linear import (
    int8_linear,
    padded_width,
)


def _pair(value, key: str, axis: int):
    """The ``{"int8", "scale"}`` pair of a state-dict value: quantized here
    (on the host, in f32) unless it is one already."""
    if not quant.is_quantized_leaf(value):
        value = quant.quantize_leaf(torch.as_tensor(value), axis)
    return (torch.as_tensor(value[quant.QVALUES]),
            torch.as_tensor(value[quant.QSCALE]))


def _check_unexpected(state_dict, prefix, names, strict, unexpected_keys):
    if strict:
        unexpected_keys.extend(
            k for k in state_dict
            if k.startswith(prefix) and k[len(prefix):] not in names)


def _copy(dst: torch.Tensor, src, key: str, error_msgs) -> None:
    src = torch.as_tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        error_msgs.append(f"size mismatch for {key}: copying a param with "
                          f"shape {tuple(src.shape)}, the model holds "
                          f"{tuple(dst.shape)}")
        return
    dst.copy_(src)


class QuantLinear(nn.Module):
    """An ``nn.Linear`` stored as int8 ``(out, in)`` rows (padded to 16
    bytes: the kernel's copy size), an f32 scale per output row and an f32
    bias; ``forward`` launches the int8 GEMM."""

    def __init__(self, in_features: int, out_features: int, bias: bool, *,
                 compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        kw = dict(device=device)
        # The padded rows; ``qweight`` is their (out, in) view.
        self.register_buffer("qrows", torch.zeros(
            out_features, padded_width(in_features), dtype=torch.int8, **kw),
            persistent=False)
        self.register_buffer("scale", torch.ones(out_features, **kw),
                             persistent=False)
        # The scale and the bias as the kernel takes them: the scale
        # rounded to the compute dtype (held in f32), the bias in it.
        self.register_buffer("kernel_scale", torch.ones(out_features, **kw),
                             persistent=False)
        self.register_buffer("bias", torch.zeros(out_features, **kw)
                             if bias else None, persistent=False)
        self.register_buffer("kernel_bias", torch.zeros(
            out_features, dtype=compute_dtype, **kw) if bias else None,
            persistent=False)

    @property
    def qweight(self) -> torch.Tensor:
        return self.qrows[:, :self.in_features]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.qweight, self.kernel_scale,
                           self.kernel_bias,
                           scale_bf16=self.compute_dtype == torch.bfloat16)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix + "weight"] = {quant.QVALUES: self.qweight,
                                          quant.QSCALE: self.scale}
        if self.bias is not None:
            destination[prefix + "bias"] = self.bias

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        names = ("weight", "bias") if self.bias is not None else ("weight",)
        _check_unexpected(state_dict, prefix, names, strict, unexpected_keys)
        with torch.no_grad():
            key = prefix + "weight"
            if key not in state_dict:
                missing_keys.append(key)
            else:
                q, s = _pair(state_dict[key], key, 0)
                _copy(self.qweight, q, key, error_msgs)
                _copy(self.scale, s, key + ".scale", error_msgs)
                self.kernel_scale.copy_(
                    self.scale.to(self.compute_dtype).float())
            if self.bias is not None:
                key = prefix + "bias"
                if key not in state_dict:
                    missing_keys.append(key)
                else:
                    _copy(self.bias, state_dict[key], key, error_msgs)
                    self.kernel_bias.copy_(self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, int8, compute {self.compute_dtype}")


class QuantEmbedding(nn.Module):
    """An ``nn.Embedding`` stored as an int8 ``(rows, dim)`` table with an
    f32 scale per column: rows are gathered as int8 and dequantized in the
    compute dtype."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.compute_dtype = compute_dtype
        self.register_buffer("qweight", torch.zeros(
            num_embeddings, embedding_dim, dtype=torch.int8, device=device),
            persistent=False)
        self.register_buffer("scale", torch.ones(embedding_dim,
                                                 device=device),
                             persistent=False)
        self.register_buffer("kernel_scale", torch.ones(
            embedding_dim, dtype=compute_dtype, device=device),
            persistent=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return (F.embedding(ids, self.qweight).to(self.compute_dtype)
                * self.kernel_scale)

    def pair(self) -> dict:
        return {quant.QVALUES: self.qweight, quant.QSCALE: self.scale}

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix + "weight"] = self.pair()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        _check_unexpected(state_dict, prefix, ("weight",), strict,
                          unexpected_keys)
        key = prefix + "weight"
        if key not in state_dict:
            missing_keys.append(key)
            return
        with torch.no_grad():
            q, s = _pair(state_dict[key], key, -1)
            _copy(self.qweight, q, key, error_msgs)
            _copy(self.scale, s, key + ".scale", error_msgs)
            self.kernel_scale.copy_(self.scale)

    def extra_repr(self) -> str:
        return (f"{self.num_embeddings}, {self.embedding_dim}, int8, compute "
                f"{self.compute_dtype}")


class TiedTableDecoder(nn.Module):
    """The masked-LM decoder of an int8 model, tied to the word table: its
    state-dict entry is that table's pair (loading it reads nothing; the
    table loads its own key). Not served: calling it raises."""

    def __init__(self, table: QuantEmbedding):
        super().__init__()
        self._table = (table,)  # not a submodule: its keys are the table's

    def forward(self, x):
        raise NotImplementedError(
            "the int8 storage mode serves the task heads only; the masked-LM "
            "decoder (a product with the word table) is not computed")

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        destination[prefix + "weight"] = self._table[0].pair()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        _check_unexpected(state_dict, prefix, ("weight",), strict,
                          unexpected_keys)
        if prefix + "weight" not in state_dict:
            missing_keys.append(prefix + "weight")


class RoundedLayerNorm(LayerNorm):
    """A LayerNorm whose f32 parameters compute rounded to the compute
    dtype (copies refreshed at every load)."""

    def __init__(self, norm: LayerNorm, compute_dtype: torch.dtype):
        super().__init__(norm.normalized_shape, eps=norm.eps,
                         device=norm.weight.device)
        self.compute_dtype = compute_dtype
        for name in ("weight", "bias"):
            self.register_buffer(f"rounded_{name}", torch.ones(
                norm.normalized_shape, dtype=compute_dtype,
                device=norm.weight.device), persistent=False)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ln_ops.layer_norm(x, residual, self.rounded_weight,
                                 self.rounded_bias, self.eps)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        with torch.no_grad():
            self.rounded_weight.copy_(self.weight)
            self.rounded_bias.copy_(self.bias)


def quantize_modules(model: nn.Module, compute_dtype: torch.dtype
                     ) -> nn.Module:
    """Swap ``model``'s Linear, Embedding and LayerNorm modules for their
    int8-mode forms, in place, on the device the model's parameters are
    on; returns ``model``. Loading weights (``load_state_dict``) comes
    after."""
    device = next(model.parameters()).device

    def swap(kind, make):
        for parent in list(model.modules()):
            for name, child in list(parent.named_children()):
                if isinstance(child, kind):
                    setattr(parent, name, make(child))

    tables = {}

    def embedding(e):
        new = QuantEmbedding(e.num_embeddings, e.embedding_dim,
                             compute_dtype=compute_dtype, device=device)
        tables[id(e.weight)] = new
        return new

    def linear(lin):
        if id(lin.weight) in tables:  # tied to a table (the MLM decoder)
            return TiedTableDecoder(tables[id(lin.weight)])
        return QuantLinear(lin.in_features, lin.out_features,
                           lin.bias is not None, compute_dtype=compute_dtype,
                           device=device)

    swap(nn.Embedding, embedding)
    swap(nn.Linear, linear)
    swap(LayerNorm, lambda n: RoundedLayerNorm(n, compute_dtype))
    return model
