"""Ring attention: sequence-parallel exact attention over the mesh's sp axis.

Counterpart of ``vilbert_multitask_tpu/parallel/ring.py``. Each rank of
the sp axis keeps one block of the queries and computes their attention
over the whole key sequence by passing the key/value blocks (and their
mask bias) around the ring, folding each block in with the online-softmax
update (running max, denominator and numerator), so no rank ever holds
the (Nq, Nk) score matrix:

- the scores and the accumulator are at ``dtype`` (the model passes
  ``promote(compute dtype, float32)``, as the JAX model does);
- the bias rotates with its K/V block;
- ``p - 1`` rotations, then the last block is consumed without one;
- the result divides by ``max(l, 1e-30)``.

A rotation is one ``batch_isend_irecv`` within the sp group
(parallel/comm.py ``shift``; staged through host memory for CUDA tensors
on gloo) and is differentiable: its backward sends the gradient the other
way round. The per-block product is plain torch, as the JAX ring is
``jnp`` and not Pallas.

In the model (``ViLBertForVLTasks(..., ring_v=)``) the activations are
replicated over sp: :func:`ring_self_attention` slices this rank's block
of Q/K/V, runs the ring and all-gathers the output along the sequence,
which is the JAX model's reshard at the ring's entry and exit. The
batch rows and heads it sees are already this rank's (dp shards rows, tp
shards heads), so each (dp, tp) position runs a ring of its own, as the
JAX ring does with its batch and head axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vilbert_multitask_tpu_torch.ops.attention import _inv_sqrt, mask_to_bias
from vilbert_multitask_tpu_torch.parallel import comm
from vilbert_multitask_tpu_torch.parallel.mesh import Axis
from vilbert_multitask_tpu_torch.parallel.mesh import axis as mesh_axis
from vilbert_multitask_tpu_torch.parallel.tp import (
    copy_to_tp,
    gather_from_tp,
)


@dataclasses.dataclass(frozen=True)
class RingContext:
    """What the model needs to route the visual self-attention through the
    ring: this rank's sp axis and the region-count threshold (below it the
    dense path or the flash kernel runs)."""

    axis: Axis
    min_seq: int = 256  # the serving knob: EngineConfig.ring_min_regions

    @classmethod
    def from_mesh(cls, mesh, *, min_seq: int,
                  sp_axis: str = "sp") -> Optional["RingContext"]:
        """The one construction rule the engine and the trainer share:
        None unless the mesh has a real sp axis."""
        ax = mesh_axis(mesh, sp_axis)
        if ax.size <= 1:
            return None
        return cls(ax, min_seq=min_seq)

    def engages(self, seq_len: int) -> bool:
        """Ring only when the sp axis is real, the sequence clears the
        threshold and divides by sp. (The JAX rule also asks the global
        batch to divide by dp; here each rank holds its rows already, and
        a batch that did not shard runs whole on every dp rank.)"""
        sp = self.axis.size
        return sp > 1 and seq_len >= self.min_seq and seq_len % sp == 0


class _Shift(torch.autograd.Function):
    """One rotation of K, V and the bias one place along the ring; the
    gradients rotate back."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        return tuple(comm.shift(tensors, axis, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *comm.shift([g.contiguous() for g in grads],
                                  ctx.axis, -1))


def _consume(carry, qf, k_blk, v_blk, bias_blk, dtype):
    """The online-softmax update for one K/V block (the JAX
    ``_online_update``): carry = (m, l, acc) in (B, H, Nq, ·)."""
    m, l, acc = carry
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.to(dtype))
    scores = scores + bias_blk.to(dtype)
    new_m = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m)
    new_l = l * correction + p.sum(dim=-1, keepdim=True)
    new_acc = acc * correction + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.to(dtype))
    return new_m, new_l, new_acc


def ring_attention_shard(q, k, v, kv_bias, *, axis: Axis,
                         dtype=torch.float32) -> torch.Tensor:
    """This rank's queries against the whole K/V of the ring.

    Shapes (this rank's blocks): q (B, Nq, H, D), k/v (B, Nk, H, D),
    kv_bias (B, 1, 1, Nk) additive bias of the local K/V block (it rotates
    with it), or None. Returns (B, Nq, H, D) in q's dtype."""
    b, nq, h, d = q.shape
    qf = q.to(dtype) * _inv_sqrt(d, dtype)
    m = torch.full((b, h, nq, 1), torch.finfo(dtype).min, dtype=dtype,
                   device=q.device)
    l = torch.zeros((b, h, nq, 1), dtype=dtype, device=q.device)
    acc = torch.zeros((b, h, nq, d), dtype=dtype, device=q.device)
    if kv_bias is None:
        kv_bias = torch.zeros((b, 1, 1, k.shape[1]), dtype=dtype,
                              device=q.device)
    carry = (m, l, acc)
    for _ in range(axis.size - 1):
        carry = _consume(carry, qf, k, v, kv_bias, dtype)
        k, v, kv_bias = _Shift.apply(axis, k, v, kv_bias)
    m, l, acc = _consume(carry, qf, k, v, kv_bias, dtype)
    out = acc / torch.clamp_min(l, 1e-30)  # (B, H, Nq, D)
    return out.transpose(1, 2).to(q.dtype)


def _block(t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    n = t.shape[dim]
    if n % ax.size:
        raise ValueError(f"length {n} does not divide by the {ax.name} "
                         f"axis' {ax.size} ranks")
    blk = n // ax.size
    return t.narrow(dim, ax.index * blk, blk)


def ring_self_attention(ctx: RingContext, q, k, v, mask_bias, *,
                        dtype=torch.float32) -> torch.Tensor:
    """Sequence-parallel self-attention inside the model: q/k/v (B, N, H,
    D) and ``mask_bias`` (B, 1, 1, N) or None, replicated over sp; returns
    the (B, N, H, D) context, replicated again. Counts one call.

    Differentiable: each rank's gradient reaches only its own block of
    q/k/v, so q/k/v enter through ``copy_to_tp`` over sp, whose backward
    sums the blocks' gradients (every rank then holds the whole one, as it
    holds the whole activation)."""
    ring_self_attention.calls += 1
    ax = ctx.axis
    if mask_bias is None:
        mask_bias = torch.zeros((q.shape[0], 1, 1, k.shape[1]), dtype=dtype,
                                device=q.device)
    q, k, v = (copy_to_tp(t, ax) for t in (q, k, v))
    out = ring_attention_shard(
        _block(q, 1, ax), _block(k, 1, ax), _block(v, 1, ax),
        _block(mask_bias.to(dtype), 3, ax), axis=ax, dtype=dtype)
    return gather_from_tp(out, ax, 1)


# Calls since the last reset (the chip smoke zeroes it before a path and
# reads it after, as it reads a kernel wrapper's ``launches``).
ring_self_attention.calls = 0


def make_ring_attention(mesh, *, sp_axis: str = "sp",
                        batch_axis: Optional[str] = None,
                        dtype=torch.float32):
    """Ring attention over ``mesh``'s ``sp_axis`` as a function of GLOBAL
    arrays: ``run(q, k, v, mask=None)`` takes q (B, Nq, H, D), k/v (B, Nk,
    H, D) and a {0,1} mask (B, Nk) (None: all valid), the same on every
    rank, and returns the global (B, Nq, H, D) context on every rank. The
    sp axis must divide Nq and Nk; with ``batch_axis`` the batch shards
    too (each dp group runs its own ring) and must divide by it. A shape
    that does not divide raises ``ValueError`` on every rank."""
    sp = mesh_axis(mesh, sp_axis)
    bx = mesh_axis(mesh, batch_axis) if batch_axis is not None else None

    def run(q, k, v, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = torch.ones(k.shape[:2], dtype=torch.int32,
                              device=k.device)
        bias = mask_to_bias(mask, dtype)  # (B, 1, 1, Nk)
        if bx is not None:
            q, k, v, bias = (_block(t, 0, bx) for t in (q, k, v, bias))
        out = ring_attention_shard(
            _block(q, 1, sp), _block(k, 1, sp), _block(v, 1, sp),
            _block(bias, 3, sp), axis=sp, dtype=dtype)
        out = comm.all_gather(out, sp, 1)
        return comm.all_gather(out, bx, 0) if bx is not None else out

    return run
