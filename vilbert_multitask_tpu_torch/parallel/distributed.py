"""Joining the process world, and the runtime summary.

Counterpart of ``vilbert_multitask_tpu/parallel/distributed.py``. JAX runs
one controller over every device and XLA inserts the collectives; PyTorch
runs one process per device (a rank) and the collectives are written out
(parallel/comm.py, parallel/tp.py, parallel/ring.py). So where the JAX
package joins one runtime per host, each rank here joins one
``torch.distributed`` world:

- :func:`initialize` takes the rendezvous from its arguments or from the
  launcher's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``: parallel/launch.py and ``torchrun`` set them)
  and returns ``False`` when there is none, a single process, as the JAX
  function returns ``False`` without a coordinator;
- the backend is named by the caller: ``"nccl"`` by default on the card,
  ``"gloo"`` on the CPU. It is never chosen because another one failed.
  NCCL takes one card per rank; ranks that share a card run ``"gloo"``,
  whose collectives on CUDA tensors the port stages through host memory
  (parallel/comm.py);
- every process group gets an explicit timeout (``timeout_s``), so a rank
  that died makes its peers fail instead of hang; the one group a served
  mesh idles on, waiting for the next request, gets ``IDLE_TIMEOUT_S``;
- on ``cuda`` a rank binds ``cuda:LOCAL_RANK % device_count``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# Seconds a collective may wait for its peers before it fails.
DEFAULT_TIMEOUT_S = 300.0

# Seconds a mesh engine's other ranks wait for rank 0's next dispatch
# (parallel/mesh.py:idle_axis): an idle server is not a dead peer. A rank
# that dies closes its sockets, which fails the wait at once, and the
# launcher then ends every rank.
IDLE_TIMEOUT_S = 365 * 24 * 3600.0

_STATE: dict = {"device": None, "timeout_s": DEFAULT_TIMEOUT_S}


def default_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def timeout() -> datetime.timedelta:
    """The timeout every process group of this process is given."""
    return datetime.timedelta(seconds=_STATE["timeout_s"])


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(backend: Optional[str] = None, *,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join (or skip) the process world.

    ``init_method`` (``tcp://host:port`` or ``file://path``),
    ``world_size`` and ``rank`` fall back to ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; ``local_rank`` to
    ``LOCAL_RANK``, then to ``rank``. Returns ``True`` when the process
    joined a world (of any size, one included), ``False`` when no
    rendezvous is configured. ``backend`` defaults to the one the
    launcher was given (``VMT_DIST_BACKEND``, parallel/launch.py), then
    to :func:`default_backend` of ``device``. On ``cuda`` the rank binds
    ``cuda:local_rank % device_count`` first."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not addr or not port:
            return False
        init_method = f"tcp://{addr}:{port}"
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        raise ValueError("joining a process world needs world_size and rank "
                         "alongside the rendezvous (or WORLD_SIZE / RANK)")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    _STATE.update(device=dev, timeout_s=float(timeout_s))
    backend = (backend or os.environ.get("VMT_DIST_BACKEND")
               or default_backend(dev))
    dist.init_process_group(backend,
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout())
    return True


def device() -> torch.device:
    """The device this rank computes on (the CPU outside a world)."""
    return _STATE["device"] or torch.device("cpu")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, timeout_s=DEFAULT_TIMEOUT_S)


def runtime_info() -> dict:
    """Process/device topology summary (for /healthz and logs): the JAX
    package's keys, with one device per rank."""
    dev = device()
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_device_count": (torch.cuda.device_count()
                               if dev.type == "cuda" else 1),
        "global_device_count": world_size(),
        "backend": dev.type,
        "dist_backend": (dist.get_backend() if dist.is_initialized()
                         else None),
    }
