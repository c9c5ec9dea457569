"""Process identity: the one name a process answers to fleet-wide.

The reference deployment is multi-process (web tier + queue-fed worker),
but a (host, pid) pair is not a stable identity — pids recycle, and a
worker that crash-loops five times in a minute is five *different*
processes that all look alike in the queue's ``claimed_by`` column. A
:class:`WorkerIdentity` therefore adds a boot nonce minted once per
process: ``host:pid:nonce`` distinguishes incarnations, so a claim row
stamped by a dead incarnation can never be mistaken for the live one.

Minted lazily on first use (:func:`process_identity`) and cached for the
process lifetime; ``role`` is fixed by whichever subsystem mints first
(the ServeApp boot path passes its own). Everything downstream — default
instrument labels, span attributes, queue claim rows, heartbeat rows in
the fleet spine, ``/healthz`` payloads, flight-recorder bundles — reads
the same object, so one process presents one identity everywhere.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class WorkerIdentity:
    """Stable per-process identity, minted once at boot."""

    host: str
    pid: int
    boot_nonce: str  # 8 hex chars, fresh per process incarnation
    role: str  # "serve", "worker", "bench", ... — coarse process kind
    started_unix: float = field(default_factory=time.time)

    @property
    def ident(self) -> str:
        """The canonical fleet-wide key: ``host:pid:nonce``."""
        return f"{self.host}:{self.pid}:{self.boot_nonce}"

    def as_dict(self) -> Dict[str, object]:
        return {"ident": self.ident, "host": self.host, "pid": self.pid,
                "boot_nonce": self.boot_nonce, "role": self.role,
                "started_unix": self.started_unix}

    def labels(self) -> Dict[str, str]:
        """The label pairs stamped onto instruments/spans (small on
        purpose: ``instance`` is the join key, ``role`` the human one)."""
        return {"instance": self.ident, "role": self.role}


def mint_identity(role: str = "worker") -> WorkerIdentity:
    """A fresh identity (new nonce). Tests mint freely; processes should
    go through :func:`process_identity` so there is exactly one."""
    return WorkerIdentity(host=socket.gethostname(), pid=os.getpid(),
                          boot_nonce=uuid.uuid4().hex[:8], role=role)


_LOCK = threading.Lock()
_IDENTITY: Optional[WorkerIdentity] = None


def process_identity(role: Optional[str] = None) -> WorkerIdentity:
    """THE process identity — minted on first call, cached forever.

    The first caller's ``role`` wins (later calls may pass None or the
    same role; a *different* role is ignored rather than re-minting —
    identity must never change mid-process).
    """
    global _IDENTITY
    with _LOCK:
        if _IDENTITY is None:
            _IDENTITY = mint_identity(role or "worker")
        return _IDENTITY


def reset_process_identity() -> None:
    """Forget the cached identity (tests only — a real process keeps one
    identity for life)."""
    global _IDENTITY
    with _LOCK:
        _IDENTITY = None
