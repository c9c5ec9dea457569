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

Timing is ``time.perf_counter`` throughout (monotonic — wall-clock
``time.time()`` in a duration is the VMT109 lint hazard). The disabled
fast path returns a shared no-op context manager after a single attribute
check, so instrumentation can stay on hot serving paths permanently
(tier-1 guards < 5 µs per disabled call).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (the cross-thread correlation key)."""
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One completed, immutable span (what the ring buffer holds)."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float  # time.perf_counter() at entry (monotonic seconds)
    dur_s: float
    thread_id: int
    thread_name: str
    attrs: Dict[str, Any] = field(default_factory=dict)


class _NoopSpan:
    """The disabled-mode singleton: enter/exit/set are all no-ops."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _TlsState:
    __slots__ = ("stack", "trace_id")

    def __init__(self):
        self.stack: List["_ActiveSpan"] = []
        self.trace_id: Optional[str] = None


class _ActiveSpan:
    """A span being measured; becomes a :class:`Span` on ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "trace_id", "span_id",
                 "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_ActiveSpan":
        """Attach attributes discovered mid-span (job ids, bucket sizes)."""
        self.attrs.update(attrs)
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
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
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
        th = threading.current_thread()
        self._tracer._record(Span(
            self.name, self.trace_id, self.span_id, self.parent_id,
            self._t0, dur, th.ident or 0, th.name, self.attrs))
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
    """Process-wide span recorder: thread-local parenting, bounded ring."""

    def __init__(self, max_spans: int = 4096, enabled: bool = True):
        self._enabled = enabled
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max_spans)
        self._tls = threading.local()
        self._observer: Optional[Callable[[Span], None]] = None
        self._default_attrs: Dict[str, Any] = {}
        # Monotonic epoch: exporters place span starts relative to this
        # (Chrome-trace ts must be small positive µs, not raw perf_counter).
        self.epoch_perf = time.perf_counter()

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

    # ------------------------------------------------------------- recording
    def span(self, name: str, **attrs):
        """``with tracer.span("engine.forward", bucket=8):`` — the API."""
        if not self._enabled:
            return _NOOP
        return _ActiveSpan(self, name, attrs)

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
        if not self._enabled:
            return
        th = threading.current_thread()
        self._record(Span(name, trace_id or new_trace_id(), new_trace_id(),
                          None, start_s, dur_s, th.ident or 0, th.name,
                          dict(attrs)))

    def _record(self, span: Span) -> None:
        if self._default_attrs:
            span.attrs = {**self._default_attrs, **span.attrs}
        with self._lock:
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
    """Module-level shorthand for ``default_tracer().span(...)``."""
    return _DEFAULT.span(name, **attrs)


def trace_scope(trace_id: Optional[str]) -> _TraceScope:
    """Module-level shorthand for ``default_tracer().trace(...)``."""
    return _DEFAULT.trace(trace_id)


def current_trace_id() -> Optional[str]:
    return _DEFAULT.current_trace_id()
