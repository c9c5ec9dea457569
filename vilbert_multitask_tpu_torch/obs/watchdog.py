"""Thread-liveness watchdog: the runtime twin of the static exc tier.

``analysis/exc.py`` proves which exception classes can escape each
thread entry point; this module is the fix its scan demands — a shared
crash guard every project-spawned loop runs under, plus a process-wide
registry health checks and tests can interrogate:

* :func:`crash_guard` — a context manager wrapped around a thread's
  loop body.  On entry it registers the thread (``vmt_thread_alive
  {name}`` = 1); on clean exit it retires it; on an escaping
  ``Exception`` it records a ``thread_died`` flight-recorder event
  (which trips the recorder's bundle capture), drops the gauge, files
  the death in the registry, and *swallows* the exception — the thread
  still dies, but loudly.  ``SystemExit``/``KeyboardInterrupt`` pass
  through: a shutdown is not a death.
* :class:`ThreadWatchdog` — the process-global registry behind the
  guard.  ``/healthz`` turns unready while :meth:`dead_threads` is
  non-empty; the sampler's probe publishes the alive gauges each tick
  and reconciles silent deaths (a thread that stopped scheduling
  without ever raising).

Process-global on purpose: the soak's chaos worker runs in its own
ServeWorker but its intake threads' deaths must be visible in the
app's ``/healthz`` — one registry per process, keyed by thread name,
with re-registration self-healing (a restarted loop under the same
name clears the prior death).

Stdlib-only except for sibling obs modules.
"""

from __future__ import annotations

import contextlib
import threading
import traceback
from typing import Dict, Iterator, List, Optional

from vilbert_multitask_tpu_torch.obs.instruments import REGISTRY
from vilbert_multitask_tpu_torch.obs.recorder import record_event

THREAD_ALIVE_GAUGE = REGISTRY.gauge(
    "vmt_thread_alive",
    "1 while a registered project thread is running its guarded loop, "
    "0 once it exited (cleanly or by dying).",
    labelnames=("name",),
)


class ThreadWatchdog:
    """Process-wide registry of guarded threads and their deaths."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> the thread object currently running under the guard.
        self._alive: Dict[str, threading.Thread] = {}
        # name -> short reason string for threads that died by exception.
        self._died: Dict[str, str] = {}
        # Every name ever guarded in this process — the conftest guard
        # checks spawned daemon threads against this inventory.
        self._known: set = set()

    # ------------------------------------------------------------ guard API
    def adopt(self, name: str, thread: threading.Thread) -> None:
        with self._lock:
            self._alive[name] = thread
            self._known.add(name)
            # Re-registration self-heals: a restarted loop under the
            # same name supersedes the prior death record.
            self._died.pop(name, None)
        THREAD_ALIVE_GAUGE.set(1, name=name)

    def retire(self, name: str) -> None:
        with self._lock:
            self._alive.pop(name, None)
        THREAD_ALIVE_GAUGE.set(0, name=name)

    def record_death(self, name: str, error: BaseException) -> None:
        reason = f"{type(error).__name__}: {error}"
        with self._lock:
            self._alive.pop(name, None)
            self._died[name] = reason
        THREAD_ALIVE_GAUGE.set(0, name=name)

    # ----------------------------------------------------------- inspection
    def dead_threads(self) -> Dict[str, str]:
        """name -> reason for every guarded thread that died (by
        exception, or silently — reconciled via ``is_alive``)."""
        with self._lock:
            out = dict(self._died)
            for name, thread in list(self._alive.items()):
                if not thread.is_alive():
                    out.setdefault(name, "thread no longer alive")
        return out

    def alive_threads(self) -> List[str]:
        with self._lock:
            return sorted(n for n, t in self._alive.items()
                          if t.is_alive())

    def is_known_thread(self, name: str) -> bool:
        with self._lock:
            return name in self._known

    def probe(self) -> Dict[str, float]:
        """Sampler-tick reconciliation: re-publish the alive gauge for
        every registered thread (catching silent deaths) and return
        ``thread_alive_<name>`` series for the timeseries store."""
        out: Dict[str, float] = {}
        with self._lock:
            alive = dict(self._alive)
            died = set(self._died)
        for name, thread in alive.items():
            up = 1.0 if thread.is_alive() else 0.0
            THREAD_ALIVE_GAUGE.set(up, name=name)
            out[f"thread_alive_{name}"] = up
        for name in died:
            THREAD_ALIVE_GAUGE.set(0, name=name)
            out[f"thread_alive_{name}"] = 0.0
        return out

    def reset(self) -> None:
        """Forget everything — test isolation only."""
        with self._lock:
            self._alive.clear()
            self._died.clear()
            self._known.clear()


_WATCHDOG = ThreadWatchdog()


def watchdog() -> ThreadWatchdog:
    return _WATCHDOG


@contextlib.contextmanager
def crash_guard(name: Optional[str] = None) -> Iterator[None]:
    """Run a thread's loop body loudly: an escaping ``Exception``
    records a ``thread_died`` event (flight-recorder bundle), drops
    ``vmt_thread_alive{name}``, and files the death so ``/healthz``
    turns unready — then swallows, because the thread is dying either
    way and a second traceback to stderr helps no one.  Exit exceptions
    (``SystemExit``, ``KeyboardInterrupt``) propagate."""
    thread = threading.current_thread()
    label = name or thread.name
    _WATCHDOG.adopt(label, thread)
    try:
        yield
    except Exception as e:  # noqa: BLE001 — the guard IS the handler
        _WATCHDOG.record_death(label, e)
        record_event(
            "thread_died",
            thread=label,
            error=str(e),
            error_type=type(e).__name__,
            traceback=traceback.format_exc(limit=16),
        )
    else:
        _WATCHDOG.retire(label)
