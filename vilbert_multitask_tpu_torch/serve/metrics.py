"""Serving telemetry: latency histogram + counters + profiler hooks.

Reference capability (SURVEY.md §5): observability in the reference is a
wall-clock ``print`` per job (reference worker.py:544,657-658) and stdout
breadcrumbs. Here a process-wide, thread-safe metrics object records
per-request latency and per-task counters, exposed via ``GET /metrics``
(serve/http_api.py), plus thin ``torch.profiler`` trace toggles for
on-demand device traces (the counterpart of the JAX package's
``jax.profiler`` toggles).

Latency storage and percentile math live in ``obs.instruments`` — the one
shared :class:`~vilbert_multitask_tpu_torch.obs.instruments.Histogram` /
:func:`~vilbert_multitask_tpu_torch.obs.instruments.percentile` implementation
(linear interpolation; the old nearest-rank ``int(p * len(lat))`` here was
upward-biased — p50 of two samples returned the max).
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Dict, Optional

from vilbert_multitask_tpu_torch.obs.instruments import Histogram, percentile


class Metrics:
    def __init__(self, reservoir: int = 2048):
        self._lock = threading.Lock()
        # Standalone histogram (not in obs.REGISTRY): each Metrics instance
        # owns its samples, so tests composing several stacks don't share.
        self._lat = Histogram("request_latency_ms",
                              "End-to-end request latency (ms).",
                              labelnames=("task",), reservoir=reservoir)
        self._failures: Counter = Counter()
        # Failures as a (standalone) histogram too: the availability SLO
        # needs failures COUNTED OVER A SLIDING WINDOW, which the lifetime
        # Counter above cannot answer. Values are the task id; only
        # window_count matters.
        self._fail_hist = Histogram("request_failures",
                                    "Terminal request failures.",
                                    reservoir=reservoir)
        # Uptime is wall-clock by definition (reported across restarts,
        # compared against deploy timestamps) — not a duration measurement.
        self._started = time.time()

    def record(self, task_id: int, latency_ms: float, *,
               exemplar_trace_id: Optional[str] = None) -> None:
        # The exemplar links this sample's histogram bucket to its stored
        # trace (OpenMetrics exposition + SLO page payloads follow it).
        self._lat.observe(latency_ms, exemplar_trace_id=exemplar_trace_id,
                          task=str(task_id))

    def record_failure(self, task_id: Optional[int] = None) -> None:
        with self._lock:
            self._failures[task_id if task_id is not None else -1] += 1
        self._fail_hist.observe(float(task_id if task_id is not None else -1))

    @property
    def latency(self) -> Histogram:
        """The underlying histogram (Prometheus exposition reads buckets)."""
        return self._lat

    @property
    def failure_events(self) -> Histogram:
        """Windowed failure events (availability-SLO bad counter)."""
        return self._fail_hist

    def uptime_s(self) -> float:
        return time.time() - self._started  # vmtlint: disable=VMT109 — uptime is wall-clock, not a latency

    def snapshot(self) -> Dict[str, Any]:
        lat = sorted(self._lat.all_samples())
        by_task = {task: n for (task,), n in sorted(
            self._lat.series_counts().items(),
            key=lambda kv: int(kv[0][0]))}
        with self._lock:
            failures = dict(self._failures)

        def pct(p: float) -> Optional[float]:
            v = percentile(lat, p)
            return round(v, 3) if v is not None else None

        return {
            "uptime_s": round(self.uptime_s(), 1),
            "requests": sum(by_task.values()),
            "by_task": by_task,
            "failures": {str(k): v for k, v in sorted(failures.items())},
            "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                           "p99": pct(0.99), "n": len(lat)},
        }


_TRACE_LOCK = threading.Lock()
_TRACE: Optional[Dict[str, Any]] = None


def start_device_trace(log_dir: str) -> None:
    """Begin a ``torch.profiler`` trace of host and device activity; the
    matching :func:`stop_device_trace` writes it into ``log_dir`` as a
    Chrome trace (``chrome://tracing``, Perfetto). One trace at a time."""
    global _TRACE
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _TRACE_LOCK:
        if _TRACE is not None:
            raise RuntimeError("a device trace is already running")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        _TRACE = {"prof": prof, "log_dir": log_dir}


def stop_device_trace() -> None:
    """Stop the running trace and write ``<log_dir>/trace-<unix ms>.json``."""
    global _TRACE
    import os

    with _TRACE_LOCK:
        if _TRACE is None:
            raise RuntimeError("no device trace is running")
        trace, _TRACE = _TRACE, None
    prof = trace["prof"]
    prof.__exit__(None, None, None)
    os.makedirs(trace["log_dir"], exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace["log_dir"], f"trace-{int(time.time() * 1e3)}.json"))
