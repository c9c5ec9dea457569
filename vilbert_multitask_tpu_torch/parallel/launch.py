"""Start the ranks of a process world on this host.

    python -m vilbert_multitask_tpu_torch.parallel.launch --nproc N \\
        --backend gloo|nccl -- <module> [module args...]

runs ``python -m <module> ...`` N times with the rendezvous variables a
rank's ``parallel.initialize()`` reads (``MASTER_ADDR=127.0.0.1``, a free
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) and
``VMT_DIST_BACKEND`` (the backend the caller named). If one rank fails
(exits non-zero), the others are terminated (SIGTERM, then SIGKILL after
``--grace`` seconds) and the launcher exits with that rank's code;
SIGTERM to the launcher is passed on to every rank. Nothing is left
running and nothing hangs.

NCCL takes one card per rank (``cuda:LOCAL_RANK % device_count``; two
ranks on one card fail NCCL's duplicate-GPU check). Ranks that share a
card run gloo, whose exchanges of CUDA tensors parallel/comm.py stages
through host memory.

:func:`spawn_ranks` is the in-Python form: it runs a picklable function
on N spawned ranks (a fresh ``file://`` rendezvous each time) and returns
each rank's result, with the same teardown.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

BACKEND_ENV = "VMT_DIST_BACKEND"


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, nproc: int, port: int, backend: str) -> dict:
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(nproc), "RANK": str(rank),
            "LOCAL_RANK": str(rank), BACKEND_ENV: backend}


def _terminate(procs, grace_s: float) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(nproc: int, backend: str, command: Sequence[str], *,
           grace_s: float = 10.0, timeout_s: Optional[float] = None) -> int:
    """Run ``command`` (argv) as ``nproc`` ranks; returns the exit code:
    0 when every rank exited 0, else the first failing rank's code (124 on
    ``timeout_s``), after tearing the rest down."""
    port = free_port()
    procs: List[subprocess.Popen] = []
    for rank in range(nproc):
        env = {**os.environ, **rank_env(rank, nproc, port, backend)}
        procs.append(subprocess.Popen(list(command), env=env))
    stopping = {"signal": None}

    def on_term(signum, frame):
        stopping["signal"] = signum

    old = signal.signal(signal.SIGTERM, on_term)
    start = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                _terminate(procs, grace_s)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if stopping["signal"] is not None:
                _terminate(procs, grace_s)
                return 128 + stopping["signal"]
            if timeout_s is not None and time.monotonic() - start > timeout_s:
                _terminate(procs, grace_s)
                return 124
            time.sleep(0.05)
    finally:
        signal.signal(signal.SIGTERM, old)
        _terminate(procs, grace_s)


def _rank_main(fn, rank: int, nproc: int, init_method: str, backend: str,
               device: str, timeout_s: float, args_path: str,
               results) -> None:
    from vilbert_multitask_tpu_torch.parallel import distributed

    try:
        import torch

        torch.set_num_threads(1)
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        distributed.initialize(backend, init_method=init_method,
                               world_size=nproc, rank=rank, local_rank=rank,
                               device=device, timeout_s=timeout_s)
        # Pickled here, in-band: a tensor put on the queue as it is would
        # travel as a file descriptor the parent may open after this rank
        # has exited.
        out = pickle.dumps(fn(rank, *args))
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)
    finally:
        distributed.shutdown()


def spawn_ranks(fn: Callable[..., Any], nproc: int, *, backend: str = "gloo",
                device: str = "cpu", args: tuple = (),
                timeout_s: float = 120.0,
                group_timeout_s: Optional[float] = None) -> List[Any]:
    """``fn(rank, *args)`` on ``nproc`` spawned ranks of one world
    (``backend`` on ``device``); returns the results in rank order. The
    world's process groups time out after ``group_timeout_s`` (default
    ``timeout_s``).

    Raises ``RuntimeError`` with the failing rank's traceback when a rank
    raises or dies, and ``TimeoutError`` past ``timeout_s``; either way
    every rank is terminated first."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="vmt-rdzv-") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        # The arguments go through a file: a large pickle written into each
        # rank's start-up pipe would make every start wait for the last.
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, nproc, init_method, backend, device,
            timeout_s if group_timeout_s is None else group_timeout_s,
            args_path, results)) for r in range(nproc)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < nproc:
                try:
                    rank, status, value = results.get(timeout=0.2)
                except queue_mod.Empty:
                    dead = [p for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"rank {procs.index(dead[0])} died with exit "
                            f"code {dead[0].exitcode}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{nproc} ranks did not finish in {timeout_s} s "
                            f"(done: {sorted(got)})")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = pickle.loads(value)
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [got[r] for r in range(nproc)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="start N ranks of a process world on this host")
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    p.add_argument("--grace", type=float, default=10.0,
                   help="seconds between SIGTERM and SIGKILL at teardown")
    p.add_argument("--timeout", type=float, default=None,
                   help="terminate every rank after this many seconds")
    p.add_argument("module", help="the module each rank runs (python -m)")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    args = a.args[1:] if a.args[:1] == ["--"] else a.args
    sys.exit(launch(a.nproc, a.backend,
                    [sys.executable, "-m", a.module, *args],
                    grace_s=a.grace, timeout_s=a.timeout))


if __name__ == "__main__":
    main()
