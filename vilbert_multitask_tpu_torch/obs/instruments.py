"""Counters, gauges, and log-bucket histograms — one implementation.

Before this package, percentile math lived in three places with three
semantics: ``serve/metrics.py`` (upward-biased nearest-rank — p50 of two
samples returned the max), ``bench.py`` (``statistics.median`` + manual
ceil nearest-rank p95), and ``scripts/serve_soak.py`` (a third variant).
:func:`percentile` below is now the only one; ``Metrics``, the bench, and
the soak all route through it (linear interpolation — exact median, no
off-by-one bias).

The :class:`Histogram` keeps fixed log-spaced buckets (Prometheus
exposition needs cumulative bucket counts) *and* a bounded reservoir of
raw samples (exact percentiles for JSON snapshots and bench artifacts) —
"replacing/augmenting the reservoir" per the round-6 telemetry design.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """Linear-interpolated percentile of raw samples, ``p`` in [0, 1].

    THE shared implementation: index space is ``p * (n - 1)`` (not the
    upward-biased ``p * n``), interpolating between the two neighboring
    order statistics. ``percentile(xs, 0.5)`` equals ``statistics.median``.
    Returns None on an empty sample set.
    """
    if not values:
        return None
    xs = sorted(float(v) for v in values)
    if len(xs) == 1:
        return xs[0]
    k = min(max(p, 0.0), 1.0) * (len(xs) - 1)
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def log_buckets(lo: float = 0.1, hi: float = 60_000.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds (defaults: 0.1 ms … 60 s in
    quarter-decade steps — latency-shaped). Deterministic, so every
    histogram in the process exposes comparable buckets."""
    out: List[float] = []
    k = math.ceil(round(math.log10(lo) * per_decade, 9))
    while True:
        bound = round(10 ** (k / per_decade), 6)
        out.append(bound)
        if bound >= hi:
            break
        k += 1
    return tuple(out)


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Instrument):
    """Monotonically increasing value per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def collect(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


class Gauge(_Instrument):
    """Point-in-time value per label set (queue depth, cache entries)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(self._key(labels))

    def remove(self, **labels) -> bool:
        """Withdraw one label set's series entirely.

        A gauge is point-in-time state, not history: when the thing it
        describes stops existing (a retired replica), its series must
        leave exposition too, or fleet views show ghosts at the last
        value forever. Returns True when a series was actually dropped.
        """
        with self._lock:
            return self._values.pop(self._key(labels), None) is not None

    def collect(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


class _HistSeries:
    """One label set's state: bucket counts + count/sum + raw reservoir +
    a timestamped window ring for sliding-window aggregation."""

    __slots__ = ("counts", "count", "sum", "reservoir", "window",
                 "exemplars")

    def __init__(self, n_buckets: int, reservoir: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the implicit +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.reservoir: deque = deque(maxlen=reservoir)
        # (t, value) pairs, same bound as the reservoir: the window is a
        # VIEW of recent samples, never an unbounded log.
        self.window: deque = deque(maxlen=reservoir)
        # bucket index -> (value, trace_id, unix_ts): the newest exemplar
        # per bucket — bounded by the bucket count, the OpenMetrics shape.
        self.exemplars: Dict[int, Tuple[float, str, float]] = {}


class Histogram(_Instrument):
    """Fixed log-bucket histogram with an exact-percentile reservoir.

    ``le`` semantics match Prometheus: a sample lands in the first bucket
    whose upper bound is >= the value; exposition cumulates the counts.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None,
                 reservoir: int = 2048):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets)) if buckets else log_buckets()
        self._reservoir = reservoir
        self._series: Dict[Tuple[str, ...], _HistSeries] = {}
        # Monotonic by default; injectable so tests can age samples out of
        # the sliding window without sleeping through it.
        self.clock = time.perf_counter

    def _get_series(self, key: Tuple[str, ...]) -> _HistSeries:
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = _HistSeries(
                len(self.buckets), self._reservoir)
        return series

    def observe(self, value: float, *,
                exemplar_trace_id: Optional[str] = None, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        now = self.clock()
        with self._lock:
            series = self._get_series(key)
            series.counts[i] += 1
            series.count += 1
            series.sum += value
            series.reservoir.append(value)
            series.window.append((now, value))
            if exemplar_trace_id:
                # Newest-wins per bucket: an exemplar is a SAMPLE linking
                # the bucket to one concrete trace, not a log. The stamp
                # is wall-clock because OpenMetrics exemplar timestamps
                # are unix epoch (a stamp, not a duration).
                series.exemplars[i] = (
                    value, str(exemplar_trace_id), time.time())

    # ----------------------------------------------------------- inspection
    def samples(self, **labels) -> List[float]:
        """Raw reservoir for one label set (newest ``reservoir`` samples)."""
        with self._lock:
            series = self._series.get(self._key(labels))
            return list(series.reservoir) if series else []

    def all_samples(self) -> List[float]:
        """Reservoirs merged across every label set."""
        with self._lock:
            return [v for s in self._series.values() for v in s.reservoir]

    def percentile(self, p: float, **labels) -> Optional[float]:
        """Exact percentile over the reservoir via the one shared
        implementation (merged across label sets when none are given on a
        labeled histogram)."""
        if not labels and self.labelnames:
            return percentile(self.all_samples(), p)
        return percentile(self.samples(**labels), p)

    def count(self, **labels) -> int:
        with self._lock:
            series = self._series.get(self._key(labels))
            return series.count if series else 0

    # ------------------------------------------------------ sliding window
    def _window_values(self, window_s: float,
                       labels: Dict[str, object]) -> List[float]:
        """Samples observed in the last ``window_s`` seconds. Merged
        across label sets when none are given on a labeled histogram
        (matching :meth:`percentile`). Filtering, never pruning: the same
        ring answers queries for DIFFERENT windows (the burn-rate fast and
        slow panes), so a short-window read must not evict samples a
        longer window still needs — the deque's maxlen is the only
        eviction."""
        cutoff = self.clock() - window_s
        with self._lock:
            if not labels and self.labelnames:
                rings = list(self._series.values())
            else:
                series = self._series.get(self._key(labels))
                rings = [series] if series else []
            return [v for s in rings for t, v in s.window if t >= cutoff]

    def window_samples(self, window_s: float, **labels) -> List[float]:
        """Raw samples inside the sliding window (bounded by the
        reservoir size — a window longer than the ring retains covers at
        most the newest ``reservoir`` samples)."""
        return self._window_values(window_s, labels)

    def window_count(self, window_s: float, **labels) -> int:
        return len(self._window_values(window_s, labels))

    def window_sum(self, window_s: float, **labels) -> float:
        return sum(self._window_values(window_s, labels))

    def window_percentile(self, p: float, window_s: float,
                          **labels) -> Optional[float]:
        """Exact percentile over the sliding window only — the live-p95
        answer the lifetime-cumulative reservoir cannot give."""
        return percentile(self._window_values(window_s, labels), p)

    def series_counts(self) -> Dict[Tuple[str, ...], int]:
        """Observation count per label set (per-task request counts)."""
        with self._lock:
            return {k: s.count for k, s in self._series.items()}

    def collect(self) -> Dict[Tuple[str, ...], dict]:
        """Per-label-set {"buckets": [(le, cumulative)...], "count", "sum"}
        — cumulativity is applied here, the one place exposition reads."""
        out: Dict[Tuple[str, ...], dict] = {}
        with self._lock:
            for key, series in self._series.items():
                cumulative, acc = [], 0
                for bound, n in zip(self.buckets, series.counts):
                    acc += n
                    cumulative.append((bound, acc))
                cumulative.append((math.inf, series.count))
                out[key] = {"buckets": cumulative, "count": series.count,
                            "sum": series.sum}
        return out

    def collect_exemplars(self) -> Dict[Tuple[str, ...],
                                        Dict[int, Tuple[float, str, float]]]:
        """Per-label-set {bucket index: (value, trace_id, unix_ts)} — the
        OpenMetrics renderer attaches these to the matching bucket lines."""
        with self._lock:
            return {key: dict(series.exemplars)
                    for key, series in self._series.items()
                    if series.exemplars}

    def slowest_exemplars(self, n: int = 3) -> List[Tuple[float, str]]:
        """The ``n`` largest exemplar-bearing observations across every
        label set, ``(value, trace_id)`` descending — the SLO page's
        "top offending traces" link to stored autopsies."""
        with self._lock:
            pairs = [(v, tid) for s in self._series.values()
                     for v, tid, _ts in s.exemplars.values()]
        return sorted(pairs, key=lambda p: p[0], reverse=True)[:max(n, 0)]


class Registry:
    """Name-keyed get-or-create instrument store (one per process is the
    normal mode — :data:`REGISTRY`); re-registration with a different
    type or label set is a programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._default_labels: Dict[str, str] = {}

    # -------------------------------------------------------- default labels
    def set_default_labels(self, **labels: str) -> None:
        """Label pairs stamped onto EVERY sample at exposition time
        (process identity: ``instance``, ``role``). Applied by the
        renderer, not at observe time — instruments keep their declared
        label sets, so ``_key`` validation and cross-process merge code
        see unchanged schemas. Call with no kwargs to clear."""
        with self._lock:
            self._default_labels = {k: str(v) for k, v in labels.items()}

    def default_labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._default_labels)

    def _get(self, cls, name: str, help: str,
             labelnames: Sequence[str], **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(
                    name, help, labelnames, **kwargs)
            elif type(inst) is not cls or inst.labelnames != tuple(labelnames):
                raise ValueError(
                    f"instrument {name!r} already registered as "
                    f"{inst.kind} with labels {inst.labelnames}")
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())


REGISTRY = Registry()
