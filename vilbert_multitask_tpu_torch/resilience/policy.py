"""Resilience policy plane: deadlines, retries, breakers, admission.

The north star is heavy multi-user traffic, and the failure behavior that
keeps tail latency bounded under partial failure is policy, not luck. This
module is the one home for those policies so the serving tiers share a
single vocabulary instead of hand-rolling loops per call site:

- :class:`Deadline` — a time budget minted at ``POST /`` that rides the
  DurableQueue job body next to ``trace_id``; the worker and engine check
  remaining budget and terminate expired jobs with a terminal push instead
  of burning a device forward on a client that stopped waiting.
- :class:`RetryPolicy` — bounded attempts, exponential backoff with FULL
  jitter (the un-jittered variant retries a worker fleet in lockstep — the
  thundering herd VMT114 lints for), plus a per-process
  :class:`RetryBudget` so a dead dependency can't turn every caller into a
  retry storm.
- :class:`CircuitBreaker` — closed/open/half-open over a sliding failure
  window; open calls fail fast (no connect timeout burned per call) and
  half-open probes detect recovery.
- :class:`AdmissionController` — shed-before-enqueue at the HTTP layer:
  once queue depth or age says the backlog can't be served within a useful
  latency, a fast ``429 Retry-After`` beats a slow success.

Everything here is host-side stdlib + obs instruments — importable without
torch or jax.
Telemetry rides the shared registry: ``vmt_retries_total{site}``,
``vmt_shed_total{reason}``, ``vmt_breaker_state{breaker}``.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Type

from vilbert_multitask_tpu_torch import obs

log = logging.getLogger(__name__)


class DeadlineExceeded(Exception):
    """A job's time budget ran out before (or while) serving it."""


class CircuitOpenError(ConnectionError):
    """Raised instead of attempting a call while a breaker is open.

    Subclasses :class:`ConnectionError` on purpose: every transport-error
    handler in the serving tiers (remote shims, worker failure isolation)
    already treats connection failures correctly, and a fast-failed call
    IS a connection failure from the caller's point of view — just one
    that cost microseconds instead of a connect timeout.
    """


class ReplicaKilled(ConnectionError):
    """An engine replica died (or was chaos-killed) with work in hand.

    Subclasses :class:`ConnectionError` for the same reason as
    :class:`CircuitOpenError`: to its callers a dead replica IS a lost
    connection. The replica pool turns this into failover — in-flight
    members go back to the queue via ``release()`` (no attempt charged;
    infra death is not the job's fault) and redeliver to a live replica,
    with ``queue_max_deliveries`` bounding how many replicas one poison
    job may take down before it dead-letters.
    """


# --------------------------------------------------------------- deadlines
class Deadline:
    """A monotonic time budget with a wall-clock wire form.

    In-process, expiry is tracked against ``time.perf_counter`` (the
    repo's duration clock — VMT109). Across processes (HTTP submit on the
    web host, claim on a remote worker) monotonic clocks don't compare, so
    the wire form carries ``(budget_s, issued_unix)`` and the receiving
    process re-anchors the remaining budget to its own monotonic clock
    once at parse time.
    """

    __slots__ = ("budget_s", "issued_unix", "_expires_perf")

    def __init__(self, budget_s: float, *,
                 issued_unix: Optional[float] = None):
        now_wall = time.time()
        self.budget_s = float(budget_s)
        self.issued_unix = (float(issued_unix) if issued_unix is not None
                            else now_wall)
        # Elapsed-so-far against a persisted cross-process wall stamp: a
        # monotonic clock cannot be compared with another process's epoch.
        elapsed = max(0.0, now_wall - self.issued_unix)  # vmtlint: disable=VMT109
        self._expires_perf = time.perf_counter() + self.budget_s - elapsed

    def remaining_s(self) -> float:
        """Budget left (negative once expired) — monotonic from here on."""
        return self._expires_perf - time.perf_counter()

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def expires_at(self) -> float:
        """Absolute expiry on this process's ``perf_counter`` timeline —
        the EDF sort key (comparable across Deadlines in one process,
        meaningless across processes)."""
        return self._expires_perf

    def to_wire(self) -> Dict[str, float]:
        """The job-body form (rides next to ``trace_id``)."""
        return {"budget_s": self.budget_s, "issued_unix": self.issued_unix}

    @classmethod
    def from_wire(cls, wire: Any) -> Optional["Deadline"]:
        """Parse a job body's ``deadline`` value; None on absent/garbage
        (jobs published by pre-deadline clients must keep serving)."""
        if not isinstance(wire, dict):
            return None
        try:
            return cls(float(wire["budget_s"]),
                       issued_unix=float(wire["issued_unix"]))
        except (KeyError, TypeError, ValueError):
            return None


# ----------------------------------------------------------------- retries
class RetryBudget:
    """Per-process token bucket bounding TOTAL retry volume.

    Backoff shapes one caller's retries; the budget bounds the sum over
    all of them — when a dependency dies, N threads each "politely"
    retrying is still an N-fold storm at the moment it recovers. Once the
    bucket is empty, callers fail with their last error instead of
    sleeping for another attempt.
    """

    def __init__(self, rate_per_s: float = 2.0, capacity: float = 20.0):
        self.rate_per_s = float(rate_per_s)
        self.capacity = float(capacity)
        self._lock = threading.Lock()
        self._tokens = self.capacity
        self._last = time.perf_counter()

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.perf_counter()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._last)
                               * self.rate_per_s)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


#: The default per-process budget every RetryPolicy without its own shares.
PROCESS_RETRY_BUDGET = RetryBudget()


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + full jitter + bounded attempts.

    Full jitter (``uniform(0, min(cap, base * 2**attempt))``) is the
    AWS-architecture-blog shape: the un-jittered ladder synchronizes every
    client that observed the same failure into retry waves. ``call`` is
    the one retry loop the serving tiers use (serve/remote.py's hand-rolled
    copy folded into it).
    """

    max_attempts: int = 5
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    budget: Optional[RetryBudget] = None  # None → PROCESS_RETRY_BUDGET

    def backoff_s(self, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
        """Full-jitter delay for ``attempt`` (0-based)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        return (rng or random).uniform(0.0, cap)

    def call(self, fn: Callable[[], Any], *, site: str,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             no_retry: Tuple[Type[BaseException], ...] = (),
             breaker: Optional["CircuitBreaker"] = None,
             sleep: Callable[[float], None] = time.sleep,
             rng: Optional[random.Random] = None) -> Any:
        """Run ``fn`` with retries; ``site`` labels ``vmt_retries_total``.

        ``no_retry`` wins over ``retry_on`` (deterministic failures like an
        HTTP 4xx must surface immediately even when they subclass a
        transport error). A ``breaker`` is consulted before every attempt
        (open → :class:`CircuitOpenError`, no attempt made) and fed the
        outcome of each one.
        """
        budget = self.budget if self.budget is not None \
            else PROCESS_RETRY_BUDGET
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            if breaker is not None:
                breaker.preflight()
            try:
                result = fn()
            except no_retry:
                raise
            except retry_on as e:
                last = e
                if breaker is not None:
                    breaker.record_failure()
                if attempt >= self.max_attempts - 1:
                    break
                if not budget.try_spend():
                    log.warning("%s: retry budget exhausted after %s (%d "
                                "attempts); failing fast", site, e,
                                attempt + 1)
                    break
                obs.RETRY_COUNTER.inc(site=site)
                delay = self.backoff_s(attempt, rng=rng)
                log.warning("%s failed (%s); retry %d/%d in %.2fs",
                            site, e, attempt + 1, self.max_attempts - 1,
                            delay)
                sleep(delay)
                continue
            if breaker is not None:
                breaker.record_success()
            return result
        assert last is not None
        raise last


# ---------------------------------------------------------------- breakers
_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """Closed / open / half-open over a sliding failure window.

    Closed: calls flow; failures are stamped into a window and the breaker
    opens once ``failure_threshold`` land within ``window_s``. Open: every
    ``preflight`` fails fast with :class:`CircuitOpenError` until
    ``reset_timeout_s`` has passed. Half-open: up to ``half_open_probes``
    calls are let through — a success closes the breaker (window cleared),
    a failure re-opens it and restarts the timer.

    Thread-safe (the worker thread, parallel warmup threads, and HTTP
    handler threads all share breakers); every mutable field is written
    under ``_lock``. State transitions publish to the
    ``vmt_breaker_state{breaker}`` gauge.
    """

    def __init__(self, name: str = "default", *,
                 failure_threshold: int = 5, window_s: float = 30.0,
                 reset_timeout_s: float = 10.0, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.window_s = float(window_s)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures: deque = deque()
        self._state = "closed"
        self._opened_at = 0.0
        self._probes = 0
        obs.BREAKER_GAUGE.set(0, breaker=self.name)

    def _set_state_locked(self, state: str) -> None:
        self._state = state
        obs.BREAKER_GAUGE.set(_STATE_CODES[state], breaker=self.name)

    def _tick_locked(self) -> None:
        """open → half_open once the reset timeout elapses."""
        if (self._state == "open"
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._set_state_locked("half_open")
            self._probes = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._tick_locked()
            return self._state

    def preflight(self) -> None:
        """Gate one call: returns to proceed, raises CircuitOpenError to
        shed. Half-open admits only the probe quota."""
        with self._lock:
            self._tick_locked()
            if self._state == "closed":
                return
            if (self._state == "half_open"
                    and self._probes < self.half_open_probes):
                self._probes += 1
                return
            raise CircuitOpenError(
                f"circuit '{self.name}' is {self._state}; call shed "
                f"(retry after {self.reset_timeout_s:.1f}s)")

    def record_success(self) -> None:
        with self._lock:
            if self._state != "closed":
                self._failures.clear()
                self._set_state_locked("closed")

    def record_failure(self) -> None:
        opened = ""
        with self._lock:
            now = self._clock()
            if self._state == "half_open":
                # The probe failed: the dependency is still down.
                self._set_state_locked("open")
                self._opened_at = now
                opened = "half_open_probe_failed"
            else:
                self._failures.append(now)
                while (self._failures
                       and now - self._failures[0] > self.window_s):
                    self._failures.popleft()
                if (self._state == "closed"
                        and len(self._failures) >= self.failure_threshold):
                    log.warning("circuit '%s' opened: %d failures in %.1fs",
                                self.name, len(self._failures),
                                self.window_s)
                    self._set_state_locked("open")
                    self._opened_at = now
                    opened = "failure_threshold"
        if opened:
            # Flight-recorder trigger OUTSIDE the lock: the enqueue is
            # cheap, but preflight() on other threads must never wait on
            # it.
            obs.record_event("breaker_open", breaker=self.name,
                             cause=opened)


class BreakerBoard:
    """A family of same-shaped :class:`CircuitBreaker` instances, one per
    member of a replica set.

    The replica pool needs N independent breakers — one replica's dispatch
    failures must trip ONLY that replica out of the rotation — but they
    should share thresholds and publish under one gauge family
    (``vmt_breaker_state{breaker="<prefix>.<member>"}``). ``get()`` is
    idempotent per member name; iteration yields ``(member, breaker)``.
    """

    def __init__(self, prefix: str, *, failure_threshold: int = 3,
                 window_s: float = 30.0, reset_timeout_s: float = 5.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        self.prefix = prefix
        self._kwargs = dict(failure_threshold=failure_threshold,
                            window_s=window_s,
                            reset_timeout_s=reset_timeout_s,
                            half_open_probes=half_open_probes, clock=clock)
        self._lock = threading.Lock()
        self._members: Dict[str, CircuitBreaker] = {}

    def get(self, member: str) -> CircuitBreaker:
        with self._lock:
            breaker = self._members.get(member)
            if breaker is None:
                breaker = CircuitBreaker(
                    name=f"{self.prefix}.{member}", **self._kwargs)
                self._members[member] = breaker
            return breaker

    def states(self) -> Dict[str, str]:
        with self._lock:
            members = list(self._members.items())
        return {name: b.state for name, b in members}

    def __iter__(self):
        with self._lock:
            return iter(list(self._members.items()))


# --------------------------------------------------------------- admission
@dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str = ""          # "queue_depth" | "queue_age" when shed
    retry_after_s: float = 0.0


class AdmissionController:
    """Shed-before-enqueue: overload is answered at the HTTP door.

    Two signals, both read from the durable queue at submit time: *depth*
    (pending + inflight — how much work is ahead of this request) and
    *age* (how long the oldest pending job has waited — depth can look
    fine while a stalled worker starves the line). Either crossing its
    threshold sheds the request with a ``429`` + ``Retry-After`` instead
    of enqueueing work the client will have abandoned by completion time.
    A threshold of 0/None disables that signal.
    """

    def __init__(self, *, max_queue_depth: int = 512,
                 max_queue_age_s: float = 120.0,
                 retry_after_s: float = 2.0):
        self.max_queue_depth = int(max_queue_depth or 0)
        self.max_queue_age_s = float(max_queue_age_s or 0.0)
        self.retry_after_s = float(retry_after_s)

    def admit(self, *, depth: int,
              oldest_age_s: Optional[float] = None) -> AdmissionDecision:
        if self.max_queue_depth and depth >= self.max_queue_depth:
            obs.SHED_COUNTER.inc(reason="queue_depth")
            return AdmissionDecision(False, "queue_depth",
                                     self.retry_after_s)
        if (self.max_queue_age_s and oldest_age_s is not None
                and oldest_age_s >= self.max_queue_age_s):
            obs.SHED_COUNTER.inc(reason="queue_age")
            return AdmissionDecision(False, "queue_age", self.retry_after_s)
        return AdmissionDecision(True)
