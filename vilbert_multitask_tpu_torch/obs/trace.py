"""Span tracing: correlated, cross-thread request timelines.

One request in this framework crosses three threads (HTTP handler →
durable queue → worker) and four subsystems (serve, engine, decode, push);
the only prior visibility was aggregate latency percentiles. A
:class:`Tracer` records *spans* — named, monotonic-clocked intervals with
attributes — into a lock-protected ring buffer, with two correlation
mechanisms:

- **thread-local parenting**: nested ``with span("..."):`` blocks on one
  thread form a parent/child tree automatically;
- **trace resumption**: a ``trace_id`` minted at HTTP submit rides in the
  queue job body and is re-entered by the worker via
  ``with tracer.trace(trace_id):`` — every span either thread opens
  carries the same ``trace_id``, so one request's timeline reassembles
  across the queue boundary.

A tracer starts disabled: the serve tier's boot enables the default one
(``/metrics``' ``vmt_span_ms``, ``/debug/trace``, the trace store). While
a ``torch.profiler`` trace records, every tracer records all the same, on
every thread (torch's process-wide flag, not the per-thread C call), and
each span on a thread the profiler records also opens a
``record_function`` range of its own name, so the device trace names the
program's stages. The disabled
path is two attribute reads that return a shared no-op context manager,
so instrumentation stays on the hot paths permanently.

Timing is ``time.perf_counter`` throughout (monotonic — wall-clock
``time.time()`` in a duration is the VMT109 lint hazard). Each tracer
reads one anchor, ``perf_counter`` and ``time.time_ns()`` together, which
places span starts on Unix time, the clock the device trace is written in
(:func:`..obs.export.chrome_trace`). Span thread ids are the OS's
(``threading.get_native_id``), as the device trace's are.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

# The first range entered in a process imports a module after it has
# stamped its start (about a millisecond, read into that span's start):
# entered once here, where no profiler records it.
with _profiler.record_function("obs.trace"):
    pass


# The ids' own generator, seeded from the OS at import and again in a
# forked child: a ``random.seed(n)`` elsewhere in the process leaves it be,
# so processes seeded alike still mint distinct trace ids.
_IDS = random.Random()
os.register_at_fork(after_in_child=_IDS.seed)


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (the cross-thread correlation key):
    64 bits of the tracer's private generator. No system call: on a
    virtualised host one costs tens of µs, the price of a whole span."""
    return "%016x" % _IDS.getrandbits(64)


@dataclass
class Span:
    """One completed, immutable span (what the ring buffer holds)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float  # time.perf_counter() at entry (monotonic seconds)
    dur_s: float
    thread_id: int  # the OS's id (threading.get_native_id)
    thread_name: str
    attrs: Dict[str, Any] = field(default_factory=dict)


class _NoopSpan:
    """The disabled-mode singleton: enter/exit/set are all no-ops."""

    __slots__ = ()
    recording = False

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _TlsState:
    __slots__ = ("stack", "trace_id", "native_id")

    def __init__(self):
        self.stack: List["_ActiveSpan"] = []
        self.trace_id: Optional[str] = None
        # Read once a thread: get_native_id is a system call each time.
        self.native_id = threading.get_native_id()


class _ActiveSpan:
    """A span being measured; becomes a :class:`Span` on ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "trace_id", "span_id",
                 "parent_id", "_t0", "_range", "_recorded")
    recording = True

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._range = None
        self._recorded: Optional[Span] = None

    def set(self, **attrs) -> "_ActiveSpan":
        """Attach attributes discovered mid-span (job ids, bucket sizes),
        or after it (a device time read once the device is done): those
        join the recorded span, in a new dict, so a reader iterating the
        old one is safe."""
        rec = self._recorded
        if rec is None:
            self.attrs.update(attrs)
        else:
            rec.attrs = {**rec.attrs, **attrs}
        return self

    def __enter__(self) -> "_ActiveSpan":
        state = self._tracer._state()
        if state.stack:
            parent = state.stack[-1]
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            # Root span: adopt the thread's resumed trace id (set by
            # Tracer.trace) or mint a fresh one.
            self.trace_id = state.trace_id or new_trace_id()
            self.parent_id = None
        self.span_id = new_trace_id()
        state.stack.append(self)
        # A range only where the profiler records this thread's host
        # ranges (the threads it was started on): the per-thread C flag.
        # The span's start is read once the range is open: the first range
        # a thread opens in a profiler's session sets up that thread's
        # event queue before it stamps its start (0.1-3 ms, longer on a
        # loaded host), while what follows the stamp is short and the
        # same on every call (the import inside the first call ever is
        # paid below, at import).
        if (_profiler._is_profiler_enabled
                and torch._C._autograd._profiler_enabled()):
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        state = self._tracer._state()
        if state.stack and state.stack[-1] is self:
            state.stack.pop()
        else:  # mispaired exit (generator abandoned mid-span): unwind past it
            try:
                state.stack.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"[:200]
        self._recorded = Span(
            self.name, self.trace_id, self.span_id, self.parent_id,
            self._t0, dur, state.native_id,
            threading.current_thread().name, self.attrs)
        self._tracer._record(self._recorded)
        return False


class _TraceScope:
    """Context manager binding a resumed trace id to the current thread."""

    __slots__ = ("_tracer", "_trace_id", "_prev")

    def __init__(self, tracer: "Tracer", trace_id: Optional[str]):
        self._tracer = tracer
        self._trace_id = trace_id

    def __enter__(self) -> "_TraceScope":
        state = self._tracer._state()
        self._prev = state.trace_id
        state.trace_id = self._trace_id
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._state().trace_id = self._prev
        return False


class Tracer:
    """Process-wide span recorder: thread-local parenting, bounded ring.

    The ring holds ``max_spans`` (a traced benchmark window's spans fit);
    when it is full the oldest span goes, and ``evicted`` counts it and
    ``evicted_end_s`` keeps the latest end of any span evicted, so a
    reader of a window knows whether the ring still holds all of it."""

    def __init__(self, max_spans: int = 16384, enabled: bool = False):
        self._enabled = enabled
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max_spans)
        self._tls = threading.local()
        self._observer: Optional[Callable[[Span], None]] = None
        self._default_attrs: Dict[str, Any] = {}
        self.evicted = 0
        self.evicted_end_s = -float("inf")
        # The anchor: one perf_counter reading and the Unix time beside it.
        self.anchor_perf = time.perf_counter()
        self.anchor_unix_ns = time.time_ns()

    # ------------------------------------------------------------- tls state
    def _state(self) -> _TlsState:
        state = getattr(self._tls, "state", None)
        if state is None:
            state = self._tls.state = _TlsState()
        return state

    # --------------------------------------------------------------- control
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def set_observer(self, fn: Optional[Callable[[Span], None]]) -> None:
        """Called with every completed span (metrics bridging). One slot."""
        self._observer = fn

    def set_default_attrs(self, **attrs: Any) -> None:
        """Attributes merged into every recorded span (process identity —
        how a stitched fleet trace tells submitter spans from worker
        spans). Span-local attrs win on collision; no kwargs clears."""
        self._default_attrs = dict(attrs)

    def unix_ns(self, perf_s: float) -> int:
        """A ``perf_counter`` reading as Unix nanoseconds, by the anchor."""
        return self.anchor_unix_ns + round((perf_s - self.anchor_perf) * 1e9)

    # ------------------------------------------------------------- recording
    def span(self, name: str, **attrs):
        """``with tracer.span("engine.forward", bucket=8):`` — the API.
        Records while enabled or while a profiler records."""
        if self._enabled or _profiler._is_profiler_enabled:
            return _ActiveSpan(self, name, attrs)
        return _NOOP

    def trace(self, trace_id: Optional[str]) -> _TraceScope:
        """Adopt ``trace_id`` for root spans opened on this thread (the
        worker's side of cross-queue correlation). ``None`` means "mint
        fresh ids" — safe for jobs published by pre-tracing clients."""
        return _TraceScope(self, trace_id)

    def current_trace_id(self) -> Optional[str]:
        """The innermost active span's trace id (or the resumed one)."""
        state = self._state()
        if state.stack:
            return state.stack[-1].trace_id
        return state.trace_id

    def record_span(self, name: str, start_s: float, dur_s: float, *,
                    trace_id: Optional[str] = None, **attrs) -> None:
        """Record an already-measured interval (for spans whose identity is
        only known after the fact — e.g. a queue claim joins the claimed
        job's trace)."""
        if not (self._enabled or _profiler._is_profiler_enabled):
            return
        self._record(Span(name, trace_id or new_trace_id(), new_trace_id(),
                          None, start_s, dur_s, self._state().native_id,
                          threading.current_thread().name, dict(attrs)))

    def _record(self, span: Span) -> None:
        if self._default_attrs:
            span.attrs = {**self._default_attrs, **span.attrs}
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                old = self._ring[0]
                self.evicted += 1
                self.evicted_end_s = max(self.evicted_end_s,
                                         old.start_s + old.dur_s)
            self._ring.append(span)
        observer = self._observer
        if observer is not None:
            try:
                observer(span)
            except Exception:  # noqa: BLE001 — telemetry must not raise
                logging.getLogger(__name__).exception(
                    "span observer failed for %s", span.name)

    # ------------------------------------------------------------ inspection
    def spans(self, limit: Optional[int] = None) -> List[Span]:
        """Snapshot of the newest ``limit`` completed spans (all if None)."""
        with self._lock:
            out = list(self._ring)
        return out[-limit:] if limit else out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer every instrumented subsystem records into."""
    return _DEFAULT


def span(name: str, **attrs):
    """Module-level shorthand for ``default_tracer().span(...)``, inlined:
    one call less on the disabled path."""
    if _DEFAULT._enabled or _profiler._is_profiler_enabled:
        return _ActiveSpan(_DEFAULT, name, attrs)
    return _NOOP


def trace_scope(trace_id: Optional[str]) -> _TraceScope:
    """Module-level shorthand for ``default_tracer().trace(...)``."""
    return _DEFAULT.trace(trace_id)


def current_trace_id() -> Optional[str]:
    return _DEFAULT.current_trace_id()
