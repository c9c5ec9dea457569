"""Bounded in-process time-series: the "last 60 seconds" the registry
cannot answer.

Counters and lifetime reservoirs say what happened since boot; a soak or
an incident needs *trajectories* — queue depth over the last minute,
sheds/sec around a breaker trip. :class:`TimeSeriesStore` keeps a bounded
ring of ``(unix_ts, value)`` points per named series, and
:class:`Sampler` is the background thread that feeds it from a single
probe callable at a configurable cadence. Keys ending ``_total`` are
counters: the sampler additionally derives a ``*_per_s`` rate series from
consecutive samples (monotonic-clock deltas), which is how sheds/sec and
windowed qps fall out of plain counter probes.

Everything here is bounded by construction (``points`` per ring) — the
store is resident in a serving process for days and snapshotted wholesale
into flight-recorder bundles.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from vilbert_multitask_tpu_torch.obs.instruments import REGISTRY

SAMPLER_THREAD_NAME = "obs-sampler"

_SAMPLER_ERRORS = REGISTRY.counter(
    "vmt_sampler_errors_total",
    "Probe failures swallowed by the background sampler")


class TimeSeriesStore:
    """Name-keyed bounded rings of ``(unix_ts, value)`` points.

    Unix stamps (not perf_counter) so a dumped window reads as real
    times in a postmortem; no duration math is ever done on them here —
    rates use the sampler's monotonic deltas.
    """

    def __init__(self, points: int = 512):
        self._lock = threading.Lock()
        self._points = max(2, int(points))
        self._series: Dict[str, deque] = {}

    def record(self, name: str, value: float,
               ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                ring = self._series[name] = deque(maxlen=self._points)
            ring.append((ts, float(value)))

    def record_many(self, values: Dict[str, float],
                    ts: Optional[float] = None) -> None:
        """One timestamp, one lock hold, many series — a sampler tick."""
        ts = time.time() if ts is None else ts
        with self._lock:
            for name, value in values.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(maxlen=self._points)
                ring.append((ts, float(value)))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, name: str,
               window_s: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        # Window filtering compares stored wall stamps against now; wall
        # time is the point (postmortem-readable axes), and a clock step
        # only widens/narrows the view, never corrupts a measurement.
        cutoff = (time.time() - window_s  # vmtlint: disable=VMT109
                  if window_s is not None else None)
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                return []
            if cutoff is None:
                return list(ring)
            return [(t, v) for t, v in ring if t >= cutoff]

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1][1] if ring else None

    def snapshot(self, window_s: Optional[float] = None
                 ) -> Dict[str, List[Tuple[float, float]]]:
        """Every series' recent points — the flight-recorder payload."""
        return {name: self.points(name, window_s) for name in self.names()}


class Sampler:
    """Daemon thread snapshotting one probe callable into a store.

    ``sample_fn() -> Dict[str, float]`` is built by the serving layer
    (it knows the queue/worker/engine wiring); the sampler owns only the
    cadence, the rate derivation for ``*_total`` keys, and the thread
    lifecycle. ``tick()`` is public so tests and the soak can sample
    synchronously without a thread.
    """

    def __init__(self, store: TimeSeriesStore,
                 sample_fn: Callable[[], Dict[str, float]],
                 cadence_s: float = 1.0):
        self.store = store
        self._sample_fn = sample_fn
        self.cadence_s = max(0.01, float(cadence_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Previous (perf_counter, value) per counter key, for rates.
        self._prev: Dict[str, Tuple[float, float]] = {}

    def tick(self) -> Dict[str, float]:
        """One sample pass: probe, derive rates, record. Returns what was
        recorded (probe keys + derived ``*_per_s`` keys)."""
        now_mono = time.perf_counter()
        values = dict(self._sample_fn())
        out = dict(values)
        for key, value in values.items():
            if not key.endswith("_total"):
                continue
            prev = self._prev.get(key)
            self._prev[key] = (now_mono, value)
            if prev is None:
                continue
            dt = now_mono - prev[0]
            if dt <= 0:
                continue
            out[key[:-len("_total")] + "_per_s"] = max(
                0.0, (value - prev[1]) / dt)
        self.store.record_many(out)
        return out

    def _run(self) -> None:
        while not self._stop.wait(self.cadence_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a flaky probe must not
                # kill the sampler thread mid-soak; the failure is counted
                # where /metrics can see it.
                _SAMPLER_ERRORS.inc()

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=SAMPLER_THREAD_NAME, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None
