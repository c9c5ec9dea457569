"""The collectives the parallel layers call, over one mesh axis.

Each takes an :class:`..mesh.Axis` (its process group, its size, this
rank's index and the global ranks in axis order) and is the identity on
an axis of size 1, so a layer calls them unconditionally.

Where the tensors go is decided by the backend and the device, never by a
failure: NCCL takes CUDA tensors as they are; gloo's collectives and its
point-to-point ops take CPU tensors, so a CUDA tensor on a gloo group
(ranks that share one card) is copied to the host, exchanged there and
copied back. Every such copy is counted in :data:`STAGED`, which the chip
smoke prints with each run.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

# Tensors exchanged through host memory (a collective's or a send's own
# tensor), and their bytes.
STAGED = {"ops": 0, "bytes": 0}


def reset_staged() -> None:
    STAGED.update(ops=0, bytes=0)


def stages(axis, t: torch.Tensor) -> bool:
    """Whether ``t`` is exchanged through host memory on ``axis``: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def _to_wire(axis, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if stages(axis, t):
        STAGED["ops"] += 1
        STAGED["bytes"] += t.numel() * t.element_size()
        return t.cpu()
    return t


def all_reduce(t: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``t`` over the axis, written into ``t`` (returned)."""
    if axis.size == 1:
        return t
    wire = _to_wire(axis, t)
    dist.all_reduce(wire, group=axis.group)
    if wire is not t:
        t.copy_(wire)
    return t


def all_gather(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The axis' tensors concatenated along ``dim`` in axis order (a new
    tensor on t's device)."""
    if axis.size == 1:
        return t
    wire = _to_wire(axis, t)
    parts = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(parts, wire, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, axis, src: int = 0) -> torch.Tensor:
    """``t`` of the axis' rank ``src`` (an index on the axis) written into
    every rank's ``t`` (returned)."""
    if axis.size == 1:
        return t
    wire = _to_wire(axis, t)
    dist.broadcast(wire, src=axis.ranks[src], group=axis.group)
    if wire is not t:
        t.copy_(wire)
    return t


def shift(tensors: Sequence[torch.Tensor], axis, step: int = 1
          ) -> List[torch.Tensor]:
    """Each tensor sent ``step`` places along the axis' ring: rank i sends
    to ``i + step`` and receives from ``i - step`` (one
    ``batch_isend_irecv`` for all of them). Returns the received
    tensors, on the senders' device."""
    if axis.size == 1:
        return list(tensors)
    nxt = axis.ranks[(axis.index + step) % axis.size]
    prv = axis.ranks[(axis.index - step) % axis.size]
    ops, got = [], []
    for t in tensors:
        wire = _to_wire(axis, t)
        recv = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, nxt, axis.group))
        ops.append(dist.P2POp(dist.irecv, recv, prv, axis.group))
        got.append(recv)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(got, tensors)]
