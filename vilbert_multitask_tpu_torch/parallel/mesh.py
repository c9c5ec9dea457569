"""The process mesh.

Counterpart of ``vilbert_multitask_tpu/parallel/mesh.py``. The JAX package
lays a ``jax.sharding.Mesh`` over its devices; here every mesh position is
a rank (one process, one device), and :func:`build_mesh` returns a
``torch.distributed.device_mesh.DeviceMesh`` of shape ``(dp, tp)``, or
``(dp, tp, sp)`` when ``sp > 1``, over the world's ranks in order (sp
innermost, then tp).

The mesh is built over process groups of the port's own, each created with
the world's explicit timeout (``DeviceMesh.from_group``), so the mesh owns
one set of communicators. The layers do not reach into the ``DeviceMesh``:
:func:`axis` gives, for this rank, one :class:`Axis` per mesh axis (its
process group, its size, this rank's index on it and the global ranks of
the group in axis order). ``axis(None, name)`` and the axes a mesh lacks
have size 1, on which every collective is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vilbert_multitask_tpu_torch.config import MeshConfig
from vilbert_multitask_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it."""

    name: str
    size: int
    index: int  # this rank's position on the axis
    group: Optional[object]  # the ProcessGroup of the ranks on this axis
    ranks: Tuple[int, ...]  # their global ranks, in axis order


def mesh_shape(cfg: Optional[MeshConfig], world_size: int
               ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The mesh's shape and axis names for ``world_size`` ranks.

    ``dp == -1`` means "all remaining ranks after tp (and sp)", so one
    launch works at any world size. The errors are the JAX package's."""
    cfg = cfg or MeshConfig()
    tp = max(1, cfg.tp)
    sp = max(1, cfg.sp)
    model = tp * sp
    if cfg.dp > 0:
        dp = cfg.dp
    else:
        if world_size % model:
            raise ValueError(
                f"{world_size} devices not divisible by tp*sp={model}")
        dp = world_size // model
    if dp * model > world_size:
        raise ValueError(
            f"mesh {dp}x{tp}x{sp} needs {dp * model} devices, "
            f"have {world_size}")
    if dp * model < world_size:
        raise ValueError(
            f"mesh {dp}x{tp}x{sp} covers {dp * model} of {world_size} ranks: "
            f"every rank holds one mesh position")
    if sp > 1:
        return (dp, tp, sp), (*cfg.axis_names, "sp")
    return (dp, tp), tuple(cfg.axis_names)


def parse_mesh(text: str) -> MeshConfig:
    """``"dp,tp[,sp]"`` (the ``--mesh`` flag of the server and the
    trainer) as a ``MeshConfig``."""
    sizes = [int(x) for x in text.split(",")]
    if not 2 <= len(sizes) <= 3:
        raise ValueError(f"--mesh takes dp,tp[,sp], got {text!r}")
    return MeshConfig(dp=sizes[0], tp=sizes[1],
                      sp=sizes[2] if len(sizes) == 3 else 1)


def build_mesh(cfg: Optional[MeshConfig] = None,
               world_size: Optional[int] = None):
    """The ``DeviceMesh`` of ``cfg`` over the world (``world_size``, when
    given, must be the world's), over one process group per axis slice
    with the world's timeout. Every rank of the world calls it, in the same
    order as its other group creations."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs a process world: call "
                           "parallel.initialize() first (the launcher, "
                           "parallel/launch.py, sets its variables)")
    world = dist.get_world_size()
    if world_size is not None and world_size != world:
        raise ValueError(f"world_size={world_size} but the process world "
                         f"has {world} ranks")
    shape, names = mesh_shape(cfg, world)
    layout = torch.arange(world).reshape(shape)
    me = dist.get_rank()
    groups = []
    for dim in range(len(shape)):
        # Every slice along ``dim`` is one group; every rank creates every
        # group (new_group is collective over the world), keeps its own.
        slices = layout.movedim(dim, -1).reshape(-1, shape[dim]).tolist()
        for ranks in slices:
            group = dist.new_group(ranks, timeout=distributed.timeout())
            if me in ranks:
                groups.append(group)
    return DeviceMesh.from_group(groups, distributed.device().type, layout,
                                 mesh_dim_names=names)


def axis(mesh, name: str) -> Axis:
    """This rank's :class:`Axis` named ``name`` of ``mesh`` (size 1 when
    ``mesh`` is None or has no such axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return Axis(name, 1, 0, None, (distributed.rank(),))
    dim = mesh.mesh_dim_names.index(name)
    coord = mesh.get_coordinate()
    others = tuple(c for d, c in enumerate(coord) if d != dim)
    ranks = tuple(mesh.mesh.movedim(dim, -1)[others].tolist())
    return Axis(name, len(ranks), coord[dim], mesh.get_group(name), ranks)


def world_axis(mesh) -> Axis:
    """Every rank of ``mesh`` as one axis (the default group): what the
    engine's rank 0 broadcasts its dispatches over."""
    if mesh is None or not dist.is_initialized():
        return Axis("world", 1, 0, None, (0,))
    world = dist.get_world_size()
    return Axis("world", world, dist.get_rank(), dist.group.WORLD,
                tuple(range(world)))


def idle_axis(mesh) -> Axis:
    """Every rank of ``mesh`` as one axis over a host (gloo) group whose
    timeout is ``distributed.IDLE_TIMEOUT_S``: what a mesh engine's other
    ranks wait on for rank 0's next dispatch header, for as long as the
    server stays idle. Every rank of the world calls it (it creates a
    group over the world)."""
    world = world_axis(mesh)
    if world.size == 1:
        return world
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=distributed.IDLE_TIMEOUT_S))
    return dataclasses.replace(world, name="idle", group=group)


def local_mesh_info(mesh) -> dict:
    """Small debug/observability summary (the JAX package's keys)."""
    names: Sequence[str] = mesh.mesh_dim_names
    shape = {n: int(s) for n, s in zip(names, mesh.mesh.shape)}
    dev = distributed.device()
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {
        "axis_names": list(names),
        "shape": shape,
        "n_devices": int(mesh.mesh.numel()),
        "device_kinds": [kind],
    }
