"""Fleet metrics spine: one sqlite file where every process reports.

The observability plane built so far (registry, timeseries, tracer,
recorder) is strictly per-process, but the deployment it models is not —
a web tier and queue-fed workers run as separate OS processes sharing
only the durable queue. The spine extends that sharing to telemetry: a
WAL-mode sqlite db (by convention ``fleet.sqlite3`` next to the queue db)
into which each process's sampler tick flushes

- a **heartbeat** row (identity + health payload, staleness-evicted),
- **instrument snapshots** (full ``collect()`` payloads per instrument),
- **timeseries deltas** (only points newer than the last flush), and
- recent **spans** keyed by ``trace_id`` (bounded per process,
  rate-limited per flush).

Any process holding a :class:`FleetSpine` on the same path can then
answer fleet-scoped queries: ``render_prometheus()`` merges live peers
(counters summed, gauges per-identity via an ``instance`` label,
histograms bucket-merged), ``health()`` lists peers with staleness
verdicts, and ``chrome_trace(trace_id)`` stitches ONE timeline from
spans recorded in different processes.

Clock alignment: spans are recorded with per-process ``perf_counter``
stamps, meaningless across processes. At export each span start is
anchored to the wall clock (``time.time() - (perf_now - start_s)``), so
stitched timelines share the unix epoch; the residual skew is NTP-level,
far below the queue latencies being visualized.
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from vilbert_multitask_tpu_torch.obs.export import (
    _escape_help,
    _fmt,
    _labels,
    _metric_name,
)
from vilbert_multitask_tpu_torch.obs.identity import WorkerIdentity
from vilbert_multitask_tpu_torch.obs.instruments import Registry, REGISTRY
from vilbert_multitask_tpu_torch.obs.timeseries import TimeSeriesStore
from vilbert_multitask_tpu_torch.obs.trace import Tracer, default_tracer

_SCHEMA = """
CREATE TABLE IF NOT EXISTS fleet_heartbeats (
    ident TEXT PRIMARY KEY,
    host TEXT NOT NULL,
    pid INTEGER NOT NULL,
    role TEXT NOT NULL,
    boot_nonce TEXT NOT NULL,
    started_unix REAL NOT NULL,
    updated_unix REAL NOT NULL,
    payload TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS fleet_instruments (
    ident TEXT NOT NULL,
    name TEXT NOT NULL,
    kind TEXT NOT NULL,
    help TEXT NOT NULL DEFAULT '',
    labelnames TEXT NOT NULL DEFAULT '[]',
    payload TEXT NOT NULL,
    updated_unix REAL NOT NULL,
    PRIMARY KEY (ident, name)
);
CREATE TABLE IF NOT EXISTS fleet_timeseries (
    ident TEXT NOT NULL,
    name TEXT NOT NULL,
    ts REAL NOT NULL,
    value REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS fleet_ts_lookup
    ON fleet_timeseries (ident, name, ts);
CREATE TABLE IF NOT EXISTS fleet_spans (
    ident TEXT NOT NULL,
    span_id TEXT NOT NULL,
    trace_id TEXT NOT NULL,
    parent_id TEXT,
    name TEXT NOT NULL,
    start_unix REAL NOT NULL,
    dur_s REAL NOT NULL,
    thread_id INTEGER NOT NULL,
    thread_name TEXT NOT NULL,
    attrs TEXT NOT NULL DEFAULT '{}',
    PRIMARY KEY (ident, span_id)
);
CREATE INDEX IF NOT EXISTS fleet_spans_trace ON fleet_spans (trace_id);
"""


def default_spine_path(queue_db_path: str) -> str:
    """The convention: the spine lives next to the queue db — the queue
    is already the one file every process in the fleet can reach."""
    d = os.path.dirname(queue_db_path) or "."
    return os.path.join(d, "fleet.sqlite3")


class FleetSpine:
    """One process's handle on the shared fleet telemetry db.

    Writer side (``flush``/``retire``) publishes this process; reader
    side (``render_prometheus``/``health``/``timeseries``/
    ``chrome_trace``) merges every live peer. All sqlite access opens a
    short-lived connection per call (the DurableQueue idiom — WAL mode
    makes cross-process readers and the single writer coexist).
    """

    def __init__(self, path: str, identity: WorkerIdentity, *,
                 heartbeat_stale_s: float = 15.0,
                 max_spans_per_ident: int = 2048,
                 spans_per_flush: int = 256,
                 timeseries_window_s: float = 600.0,
                 registry: Optional[Registry] = None,
                 tracer: Optional[Tracer] = None,
                 timeseries: Optional[TimeSeriesStore] = None):
        self.path = path
        self.identity = identity
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        self.max_spans_per_ident = int(max_spans_per_ident)
        self.spans_per_flush = int(spans_per_flush)
        self.timeseries_window_s = float(timeseries_window_s)
        self._registry = registry if registry is not None else REGISTRY
        self._tracer = tracer if tracer is not None else default_tracer()
        self._timeseries = timeseries
        self._lock = threading.Lock()
        # Flush bookkeeping: newest timeseries stamp already written per
        # series, and span ids already exported (bounded — the dedup set
        # only needs to cover what the tracer ring can still hold).
        self._ts_high_water: Dict[str, float] = {}
        self._exported_ids: deque = deque(maxlen=2 * max_spans_per_ident)
        self._exported_set: set = set()
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._conn() as c:
            c.executescript(_SCHEMA)

    def _conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    # ------------------------------------------------------------ writer side
    def flush(self, health_payload: Optional[Dict[str, Any]] = None) -> None:
        """Publish this process's current telemetry (one sampler tick)."""
        with self._lock:
            now = time.time()
            ident = self.identity
            inst_rows = []
            for inst in self._registry.instruments():
                payload = [[list(k), v] for k, v in
                           sorted(inst.collect().items())]
                # json.dumps writes histogram +Inf bounds as the (python-
                # parseable) Infinity literal; json.loads restores them.
                inst_rows.append((
                    ident.ident, inst.name, inst.kind, inst.help,
                    json.dumps(list(inst.labelnames)),
                    json.dumps(payload), now))
            ts_rows = self._timeseries_deltas()
            span_rows = self._span_rows()
            with self._conn() as c:
                c.execute(
                    "INSERT INTO fleet_heartbeats (ident, host, pid, role, "
                    "boot_nonce, started_unix, updated_unix, payload) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(ident) DO UPDATE SET "
                    "updated_unix=excluded.updated_unix, "
                    "payload=excluded.payload",
                    (ident.ident, ident.host, ident.pid, ident.role,
                     ident.boot_nonce, ident.started_unix, now,
                     json.dumps(health_payload or {})))
                c.executemany(
                    "INSERT INTO fleet_instruments (ident, name, kind, help, "
                    "labelnames, payload, updated_unix) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(ident, name) DO UPDATE SET "
                    "payload=excluded.payload, "
                    "updated_unix=excluded.updated_unix", inst_rows)
                if ts_rows:
                    c.executemany(
                        "INSERT INTO fleet_timeseries (ident, name, ts, value)"
                        " VALUES (?, ?, ?, ?)", ts_rows)
                    c.execute(
                        "DELETE FROM fleet_timeseries WHERE ident=? AND ts<?",
                        # Wall-clock retention cutoff in a SHARED db: rows
                        # carry time.time() stamps so peers can compare them.
                        (ident.ident,
                         now - self.timeseries_window_s))  # vmtlint: disable=VMT109
                if span_rows:
                    c.executemany(
                        "INSERT OR IGNORE INTO fleet_spans (ident, span_id, "
                        "trace_id, parent_id, name, start_unix, dur_s, "
                        "thread_id, thread_name, attrs) "
                        "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)", span_rows)
                    # Per-ident bound: keep only the newest rows.
                    c.execute(
                        "DELETE FROM fleet_spans WHERE ident=? AND span_id "
                        "NOT IN (SELECT span_id FROM fleet_spans WHERE "
                        "ident=? ORDER BY start_unix DESC LIMIT ?)",
                        (ident.ident, ident.ident, self.max_spans_per_ident))

    def _timeseries_deltas(self) -> List[Tuple[str, str, float, float]]:
        if self._timeseries is None:
            return []
        rows = []
        for name, points in self._timeseries.snapshot().items():
            high = self._ts_high_water.get(name, -math.inf)
            fresh = [(t, v) for t, v in points if t > high]
            if fresh:
                self._ts_high_water[name] = fresh[-1][0]
                rows.extend((self.identity.ident, name, t, v)
                            for t, v in fresh)
        return rows

    def _span_rows(self) -> List[Tuple]:
        rows = []
        # Wall-anchor per-process monotonic span stamps so timelines from
        # different processes share an epoch. This is an epoch conversion,
        # not duration math: dur_s stays pure perf_counter.
        offset = time.time() - time.perf_counter()  # vmtlint: disable=VMT109
        for s in self._tracer.spans():
            if s.span_id in self._exported_set:
                continue
            rows.append((self.identity.ident, s.span_id, s.trace_id,
                         s.parent_id, s.name, offset + s.start_s, s.dur_s,
                         s.thread_id, s.thread_name,
                         json.dumps(s.attrs, default=str)))
            if len(self._exported_ids) == self._exported_ids.maxlen:
                self._exported_set.discard(self._exported_ids[0])
            self._exported_ids.append(s.span_id)
            self._exported_set.add(s.span_id)
            if len(rows) >= self.spans_per_flush:
                break
        return rows

    def retire(self) -> None:
        """Graceful shutdown: withdraw this process's live presence (its
        heartbeat/instruments/timeseries). Spans stay — a finished
        submitter's half of a trace must remain stitchable."""
        with self._lock, self._conn() as c:
            c.execute("DELETE FROM fleet_heartbeats WHERE ident=?",
                      (self.identity.ident,))
            c.execute("DELETE FROM fleet_instruments WHERE ident=?",
                      (self.identity.ident,))
            c.execute("DELETE FROM fleet_timeseries WHERE ident=?",
                      (self.identity.ident,))

    # ------------------------------------------------------------ reader side
    def peers(self, include_stale: bool = False) -> List[Dict[str, Any]]:
        """Heartbeat rows, newest first, with ``alive`` staleness verdicts.
        Stale peers (SIGKILL'd, hung) are excluded unless asked for."""
        now = time.time()
        with self._conn() as c:
            rows = c.execute(
                "SELECT ident, host, pid, role, boot_nonce, started_unix, "
                "updated_unix, payload FROM fleet_heartbeats "
                "ORDER BY updated_unix DESC").fetchall()
        out = []
        for (ident, host, pid, role, nonce, started, updated, payload) in rows:
            # Staleness compares persisted wall stamps from OTHER processes;
            # monotonic clocks do not cross process boundaries.
            age = now - updated  # vmtlint: disable=VMT109
            alive = age <= self.heartbeat_stale_s
            if not alive and not include_stale:
                continue
            out.append({"ident": ident, "host": host, "pid": pid,
                        "role": role, "boot_nonce": nonce,
                        "started_unix": started, "updated_unix": updated,
                        "age_s": round(age, 3), "alive": alive,
                        "payload": json.loads(payload)})
        return out

    def live_idents(self) -> List[str]:
        return [p["ident"] for p in self.peers()]

    def health(self) -> Dict[str, Any]:
        """The ``/healthz?scope=fleet`` payload: every live peer's own
        health block plus the fleet-level verdict (every peer ready)."""
        peers = self.peers(include_stale=True)
        live = [p for p in peers if p["alive"]]
        ready = bool(live) and all(
            p["payload"].get("phase", "ready") == "ready" for p in live)
        return {"scope": "fleet", "fleet_ready": ready,
                "processes": peers, "alive": len(live),
                "stale": len(peers) - len(live),
                "heartbeat_stale_s": self.heartbeat_stale_s}

    def _live_instruments(self) -> Dict[str, Dict[str, Any]]:
        """name -> merged descriptor {kind, help, labelnames,
        series: {ident: payload}} across live peers only."""
        live = set(self.live_idents())
        with self._conn() as c:
            rows = c.execute(
                "SELECT ident, name, kind, help, labelnames, payload "
                "FROM fleet_instruments").fetchall()
        merged: Dict[str, Dict[str, Any]] = {}
        for ident, name, kind, help_, labelnames, payload in rows:
            if ident not in live:
                continue
            entry = merged.setdefault(name, {
                "kind": kind, "help": help_,
                "labelnames": tuple(json.loads(labelnames)), "series": {}})
            entry["series"][ident] = [
                (tuple(k), v) for k, v in json.loads(payload)]
        return merged

    def render_prometheus(self) -> str:
        """Fleet-scoped exposition: counters summed across live peers,
        gauges emitted per peer (``instance`` label), histograms
        bucket-merged. One scrape, whole fleet."""
        lines: List[str] = []
        merged = self._live_instruments()
        for name in sorted(merged):
            entry = merged[name]
            mname = _metric_name(name)
            labelnames = entry["labelnames"]
            if entry["help"]:
                lines.append(f"# HELP {mname} {_escape_help(entry['help'])}")
            lines.append(f"# TYPE {mname} {entry['kind']}")
            if entry["kind"] == "counter":
                totals: Dict[Tuple[str, ...], float] = {}
                for series in entry["series"].values():
                    for key, value in series:
                        totals[key] = totals.get(key, 0.0) + value
                for key in sorted(totals):
                    lines.append(f"{mname}{_labels(labelnames, key)} "
                                 f"{_fmt(totals[key])}")
            elif entry["kind"] == "gauge":
                for ident in sorted(entry["series"]):
                    for key, value in sorted(entry["series"][ident]):
                        lines.append(
                            f"{mname}"
                            f"{_labels(labelnames, key, [('instance', ident)])}"
                            f" {_fmt(value)}")
            else:  # histogram: merge cumulative buckets by bound
                agg: Dict[Tuple[str, ...], Dict[str, Any]] = {}
                for series in entry["series"].values():
                    for key, h in series:
                        slot = agg.setdefault(
                            key, {"buckets": {}, "count": 0, "sum": 0.0})
                        for bound, cum in h["buckets"]:
                            b = math.inf if bound is None else float(bound)
                            slot["buckets"][b] = slot["buckets"].get(b, 0) + cum
                        slot["count"] += h["count"]
                        slot["sum"] += h["sum"]
                for key in sorted(agg):
                    slot = agg[key]
                    for bound in sorted(slot["buckets"]):
                        lines.append(
                            f"{mname}_bucket"
                            f"{_labels(labelnames, key, [('le', _fmt(bound))])}"
                            f" {slot['buckets'][bound]}")
                    lines.append(f"{mname}_sum{_labels(labelnames, key)} "
                                 f"{_fmt(slot['sum'])}")
                    lines.append(f"{mname}_count{_labels(labelnames, key)} "
                                 f"{slot['count']}")
        return "\n".join(lines) + "\n"

    def timeseries(self, window_s: Optional[float] = None
                   ) -> Dict[str, Any]:
        """Fleet-scoped ``/debug/timeseries`` payload: every live peer's
        series, keyed ``ident:name`` so per-process trajectories stay
        distinguishable on one chart."""
        live = set(self.live_idents())
        cutoff = (time.time() - window_s  # vmtlint: disable=VMT109
                  if window_s is not None else None)
        with self._conn() as c:
            if cutoff is None:
                rows = c.execute(
                    "SELECT ident, name, ts, value FROM fleet_timeseries "
                    "ORDER BY ts").fetchall()
            else:
                rows = c.execute(
                    "SELECT ident, name, ts, value FROM fleet_timeseries "
                    "WHERE ts >= ? ORDER BY ts", (cutoff,)).fetchall()
        series: Dict[str, List[Tuple[float, float]]] = {}
        for ident, name, ts, value in rows:
            if ident not in live:
                continue
            series.setdefault(f"{ident}:{name}", []).append((ts, value))
        return {"scope": "fleet", "window_s": window_s,
                "processes": sorted(live), "series": series}

    def chrome_trace(self, trace_id: Optional[str] = None,
                     limit: Optional[int] = None) -> Dict[str, Any]:
        """ONE Chrome-trace timeline stitched across processes.

        Each contributing process becomes a Chrome-trace ``pid`` row
        (named ``role ident``); timestamps are µs relative to the
        earliest span so the submitter's ``http.submit`` and the
        worker's ``worker.job`` line up on one axis.

        Deliberately liveness-blind, unlike the metrics/health merges:
        staleness eviction (and ``retire()``) withdraws a peer's
        *presence*, never its spans — a SIGKILL'd worker's half of a
        trace is exactly the autopsy this view exists for, so span
        reads include every ident still on disk. The trace store
        (obs/tracestore.py) reads under the same contract.
        """
        with self._conn() as c:
            if trace_id:
                rows = c.execute(
                    "SELECT ident, span_id, trace_id, parent_id, name, "
                    "start_unix, dur_s, thread_id, thread_name, attrs "
                    "FROM fleet_spans WHERE trace_id=? ORDER BY start_unix",
                    (trace_id,)).fetchall()
            else:
                rows = c.execute(
                    "SELECT ident, span_id, trace_id, parent_id, name, "
                    "start_unix, dur_s, thread_id, thread_name, attrs "
                    "FROM fleet_spans ORDER BY start_unix DESC LIMIT ?",
                    (int(limit or 1000),)).fetchall()
                rows.reverse()
        if not rows:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "scope": "fleet", "trace_id": trace_id}
        epoch = min(r[5] for r in rows)
        roles = {p["ident"]: p["role"]
                 for p in self.peers(include_stale=True)}
        pids: Dict[str, int] = {}
        thread_names: Dict[Tuple[int, int], str] = {}
        events: List[Dict[str, Any]] = []
        for (ident, span_id, tid_, parent_id, name, start_unix, dur_s,
             thread_id, thread_name, attrs) in rows:
            pid = pids.setdefault(ident, len(pids) + 1)
            thread_names.setdefault((pid, thread_id), thread_name)
            events.append({
                "name": name, "ph": "X", "cat": "obs",
                "ts": round((start_unix - epoch) * 1e6, 3),
                "dur": round(dur_s * 1e6, 3),
                "pid": pid, "tid": thread_id,
                "args": {"trace_id": tid_, "span_id": span_id,
                         "parent_id": parent_id, "ident": ident,
                         **json.loads(attrs)},
            })
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": f"{roles.get(ident, 'proc')} {ident}"}}
                for ident, pid in sorted(pids.items(), key=lambda kv: kv[1])]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "args": {"name": tname}}
                 for (pid, tid), tname in sorted(thread_names.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "scope": "fleet", "trace_id": trace_id,
                "processes": {ident: pid for ident, pid in pids.items()}}

    def snapshot(self) -> Dict[str, Any]:
        """Compact fleet view for flight-recorder bundles: who is alive,
        how stale, and how much telemetry each peer has spined."""
        with self._conn() as c:
            span_counts = dict(c.execute(
                "SELECT ident, COUNT(*) FROM fleet_spans "
                "GROUP BY ident").fetchall())
        return {"path": self.path, "self": self.identity.as_dict(),
                "peers": self.peers(include_stale=True),
                "span_rows": span_counts}
