"""Flight recorder: black-box postmortem capture for the serving plane.

When something trips — a breaker opens, an SLO pages, a fault fires, a
deadline spike, a drain, an unhandled worker exception — the in-process
evidence (recent spans, the time-series window, instrument values) is
exactly what a postmortem needs and exactly what is gone by the time a
human attaches. The recorder freezes it: trigger sites enqueue a cheap
event; a background writer thread assembles a bundle (last-N spans, the
time-series window, a full instrument snapshot, config fingerprint,
recent trace/job ids) and atomically dumps it to a rotated, size-bounded
directory of ``pm_<unix_ms>_<event>.json`` files.

Disabled-mode discipline matches ``resilience/faults.py``: the module
plane is one global read — ``record_event``/``record_spike`` with no
recorder installed cost a ``None`` compare (<5 µs tier-1 guard), so
trigger sites stay unconditional in production code.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from vilbert_multitask_tpu_torch.obs import trace as _trace
from vilbert_multitask_tpu_torch.obs.instruments import (
    Counter, Gauge, Histogram, REGISTRY, percentile)

RECORDER_THREAD_NAME = "flight-recorder"
_EVENT_SAFE = re.compile(r"[^a-z0-9_-]+")

_DROPPED = REGISTRY.counter(
    "vmt_recorder_dropped_total",
    "Flight-recorder triggers dropped (queue full or rate-limited)",
    labelnames=("reason",))
_BUNDLES = REGISTRY.counter(
    "vmt_recorder_bundles_total", "Flight-recorder bundles written",
    labelnames=("event",))


def _instrument_snapshot() -> List[dict]:
    """Every registered instrument's current values, JSON-shaped."""
    out: List[dict] = []
    for inst in REGISTRY.instruments():
        row: dict = {"name": inst.name, "kind": inst.kind}
        if isinstance(inst, (Counter, Gauge)):
            row["values"] = {"|".join(k) or "_": v
                             for k, v in inst.collect().items()}
        elif isinstance(inst, Histogram):
            series = {}
            for key, info in inst.collect().items():
                xs = inst.samples(**dict(zip(inst.labelnames, key)))
                series["|".join(key) or "_"] = {
                    "count": info["count"],
                    "sum": round(info["sum"], 3),
                    "p50": percentile(xs, 0.5),
                    "p95": percentile(xs, 0.95),
                    "p99": percentile(xs, 0.99),
                }
            row["series"] = series
        out.append(row)
    return out


class FlightRecorder:
    """Rotated, size-bounded postmortem bundles on trigger events.

    Trigger sites call :meth:`trigger` (enqueue only — never I/O); the
    single writer thread does the snapshotting and the disk work, so a
    breaker opening under load costs the hot path one queue put.
    ``sources`` maps extra section names to zero-arg callables evaluated
    at dump time (the serve layer wires ``timeseries`` and config here).
    """

    def __init__(self, dir: str, max_bundles: int = 16,
                 max_bytes: int = 1_000_000, spans: int = 256,
                 min_interval_s: float = 30.0,
                 sources: Optional[Dict[str, Callable[[], object]]] = None):
        self.dir = dir
        self.max_bundles = max(1, int(max_bundles))
        self.max_bytes = max(4096, int(max_bytes))
        self.spans_limit = max(0, int(spans))
        self.min_interval_s = float(min_interval_s)
        self.sources = dict(sources or {})
        self._q: "queue.Queue" = queue.Queue(maxsize=64)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._last_fire: Dict[str, float] = {}
        self._spikes: Dict[str, deque] = {}

    # ------------------------------------------------------------ triggers
    def trigger(self, event: str, **detail) -> bool:
        """Enqueue a postmortem dump; returns False when rate-limited or
        the writer is saturated (both counted, never raised)."""
        now = time.perf_counter()
        with self._lock:
            last = self._last_fire.get(event)
            if last is not None and now - last < self.min_interval_s:
                _DROPPED.inc(reason="rate_limited")
                return False
            self._last_fire[event] = now
            self._ensure_thread_locked()
        try:
            self._q.put_nowait((event, detail, time.time()))
        except queue.Full:
            _DROPPED.inc(reason="queue_full")
            return False
        return True

    def spike(self, event: str, threshold: int = 5,
              window_s: float = 10.0, **detail) -> bool:
        """Count occurrences in a sliding window; trigger once the window
        holds ``threshold`` of them (deadline-exceeded spikes: one expiry
        is traffic, a burst is an incident)."""
        now = time.perf_counter()
        with self._lock:
            ring = self._spikes.get(event)
            if ring is None:
                ring = self._spikes[event] = deque(
                    maxlen=max(int(threshold), 64))
            while ring and now - ring[0] > window_s:
                ring.popleft()
            ring.append(now)
            n = len(ring)
            if n < threshold:
                return False
            ring.clear()
        return self.trigger(event, spike_count=n, spike_window_s=window_s,
                            **detail)

    # ----------------------------------------------------------- lifecycle
    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name=RECORDER_THREAD_NAME, daemon=True)
            self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        """Drain pending triggers, write them, join the writer."""
        with self._lock:
            t = self._thread
            self._thread = None
        if t is None or not t.is_alive():
            return
        self._q.put(None)  # FIFO sentinel: everything queued before it
        t.join(timeout)    # still gets written

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write_bundle(*item)
            except Exception:  # noqa: BLE001 — a disk error must not kill
                # the writer loop; the failed dump is counted, the next
                # trigger still gets its bundle.
                _DROPPED.inc(reason="write_error")

    # ---------------------------------------------------------- bundle I/O
    def _bundle(self, event: str, detail: dict, ts: float) -> dict:
        spans = [dataclasses.asdict(s)
                 for s in _trace.default_tracer().spans(self.spans_limit)]
        trace_ids, job_ids = [], []
        for s in spans:
            tid = s.get("trace_id")
            if tid and tid not in trace_ids:
                trace_ids.append(tid)
            jid = (s.get("attrs") or {}).get("job_id")
            if jid and jid not in job_ids:
                job_ids.append(jid)
        bundle = {
            "event": event,
            "detail": detail,
            "time_unix": round(ts, 3),
            "trace_ids": trace_ids[-64:],
            "job_ids": job_ids[-64:],
            "instruments": _instrument_snapshot(),
            "spans": spans,
        }
        for name, fn in self.sources.items():
            try:
                bundle[name] = fn()
            except Exception as e:  # noqa: BLE001 — a broken source loses
                # its own section only, never the bundle.
                bundle[name] = {"error": repr(e)}
        return bundle

    def _write_bundle(self, event: str, detail: dict, ts: float) -> None:
        bundle = self._bundle(event, detail, ts)
        payload = json.dumps(bundle, default=repr)
        # Size-bound by shedding the bulkiest sections, spans first.
        while len(payload) > self.max_bytes and bundle["spans"]:
            bundle["spans"] = bundle["spans"][len(bundle["spans"]) // 2:]
            bundle["spans_truncated"] = True
            payload = json.dumps(bundle, default=repr)
        if len(payload) > self.max_bytes and "timeseries" in bundle:
            bundle["timeseries"] = {"truncated": True}
            payload = json.dumps(bundle, default=repr)
        safe = _EVENT_SAFE.sub("_", event.lower()) or "event"
        name = f"pm_{int(ts * 1000)}_{safe}.json"
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)  # readers never see a half-written bundle
        _BUNDLES.inc(event=event)
        self._rotate()

    def _rotate(self) -> None:
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("pm_") and n.endswith(".json"))
        except OSError:
            return
        for stale in names[:-self.max_bundles]:
            try:
                os.remove(os.path.join(self.dir, stale))
            except OSError:
                continue  # racing rotation from a previous process is fine

    def bundles(self) -> List[str]:
        """Paths of current bundles, oldest first."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("pm_") and n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names]


# ----------------------------------------------------------- module plane
# Same shape as faults._PLAN: one global, trigger sites pay a read + a
# None compare when no recorder is installed.
_RECORDER: Optional[FlightRecorder] = None


def install_recorder(rec: FlightRecorder) -> FlightRecorder:
    global _RECORDER
    _RECORDER = rec
    return rec


def clear_recorder() -> None:
    global _RECORDER
    rec = _RECORDER
    _RECORDER = None
    if rec is not None:
        rec.close()


def active_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def record_event(event: str, **detail) -> bool:
    """Unconditional trigger site. No recorder installed: a None check."""
    rec = _RECORDER
    if rec is None:
        return False
    return rec.trigger(event, **detail)


def record_spike(event: str, threshold: int = 5, window_s: float = 10.0,
                 **detail) -> bool:
    """Unconditional spike-counting trigger site (see
    :meth:`FlightRecorder.spike`)."""
    rec = _RECORDER
    if rec is None:
        return False
    return rec.spike(event, threshold=threshold, window_s=window_s, **detail)
