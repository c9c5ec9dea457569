"""Durable tail-sampled trace persistence on the fleet-spine sqlite.

The tracer ring (obs/trace.py) holds the last ~4096 spans in memory —
by the time an operator chases a paging SLO burn, the offending trace
has usually been evicted. This store keeps the tail *durably*: a new
``traces`` table in the shared fleet db (WAL, retention-trimmed), one
row per kept trace carrying its spans and the :class:`JobCost` record,
flushed by the existing sampler tick.

Keep policy (verdict-based, the Dapper tail-sampling shape):

=========== =========================================================
verdict     every non-``ok`` terminal — dead_letter, deadline, error,
            requeued, failover (breaker-touched) — kept 100%
slow        completion-time top-K slowest ``ok`` jobs per task
pinned      SLO page offenders force-kept by trace id
sampled     p-sampled ``ok`` normals (``tracestore_sample_rate``)
=========== =========================================================

Reads NEVER filter by peer liveness: a SIGKILL'd worker's heartbeat
goes stale and its metrics leave the fleet merges, but its stored
traces — like its ``fleet_spans`` rows — are exactly the autopsies the
store exists for, so ``list()``/``get()`` see every ident on disk.
"""

from __future__ import annotations

import json
import os
import random
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from vilbert_multitask_tpu_torch.obs.attrib import JobCost

_SCHEMA = """
CREATE TABLE IF NOT EXISTS traces (
    trace_id TEXT PRIMARY KEY,
    ident TEXT NOT NULL,
    task TEXT NOT NULL DEFAULT '',
    tenant TEXT NOT NULL DEFAULT 'anon',
    verdict TEXT NOT NULL DEFAULT '',
    keep_reason TEXT NOT NULL DEFAULT '',
    dur_ms REAL NOT NULL DEFAULT 0,
    stored_unix REAL NOT NULL,
    spans TEXT NOT NULL DEFAULT '[]',
    cost TEXT NOT NULL DEFAULT '{}'
);
CREATE INDEX IF NOT EXISTS traces_verdict ON traces (verdict, task);
CREATE INDEX IF NOT EXISTS traces_stored ON traces (stored_unix);
"""


def _span_dict(span) -> Dict[str, Any]:
    return {"name": span.name, "trace_id": span.trace_id,
            "span_id": span.span_id, "parent_id": span.parent_id,
            "start_s": span.start_s, "dur_s": span.dur_s,
            "thread_name": span.thread_name, "attrs": dict(span.attrs)}


class TraceStore:
    """One process's handle on the shared ``traces`` table.

    Writer side buffers kept traces in memory (``offer``/``pin``) and
    persists them on ``flush()`` — the sampler-tick ride-along, same
    failure domain as the fleet spine flush. Reader side serves
    ``/debug/traces`` lists and the ``/debug/trace``/``/debug/autopsy``
    store fallback, across every ident on disk (stale peers included —
    see the module docstring).
    """

    def __init__(self, path: str, ident: str, *, keep_top_k: int = 8,
                 sample_rate: float = 0.05, retention_s: float = 3600.0,
                 rng: Optional[random.Random] = None):
        self.path = path
        self.ident = ident
        self.keep_top_k = int(keep_top_k)
        self.sample_rate = float(sample_rate)
        self.retention_s = float(retention_s)
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._pending: List[tuple] = []
        # Completion-time top-K tracking: per task, the K fastest of the
        # kept-slow set — a new completion slower than the slot floor
        # displaces it (in keep verdicts only; stored rows stay until
        # retention trims them).
        self._slow: Dict[str, List[float]] = {}
        self._pinned: set = set()
        self.offered = 0
        self.kept = 0
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._conn() as c:
            c.executescript(_SCHEMA)

    def _conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    # ------------------------------------------------------------- keep side
    def _keep_reason(self, cost: JobCost) -> Optional[str]:
        if cost.verdict and cost.verdict != "ok":
            return "verdict"
        if cost.trace_id in self._pinned:
            self._pinned.discard(cost.trace_id)
            return "pinned"
        dur = cost.total_ms()
        task = cost.task or "unknown"
        heap = self._slow.setdefault(task, [])
        if len(heap) < self.keep_top_k:
            heap.append(dur)
            heap.sort()
            return "slow"
        if dur > heap[0]:
            heap[0] = dur
            heap.sort()
            return "slow"
        if self._rng.random() < self.sample_rate:
            return "sampled"
        return None

    def offer(self, cost: JobCost,
              spans: Sequence[Any] = ()) -> Optional[str]:
        """Tail-sampling decision for one completed job. Returns the
        keep reason, or None when the trace is dropped."""
        with self._lock:
            self.offered += 1
            reason = self._keep_reason(cost)
            if reason is None:
                return None
            self.kept += 1
            self._pending.append((
                cost.trace_id, self.ident, cost.task or "unknown",
                cost.tenant or "anon", cost.verdict or "ok", reason,
                cost.total_ms(),
                cost.finished_unix or time.time(),
                json.dumps([_span_dict(s) for s in spans
                            if s.trace_id == cost.trace_id],
                           default=str),
                json.dumps(cost.as_dict(), default=str)))
        return reason

    def pin(self, trace_ids: Sequence[str]) -> None:
        """Force-keep upcoming offers for these trace ids (the SLO page
        path: an offender identified from exemplars must persist even
        if the sampler would have dropped it)."""
        with self._lock:
            self._pinned.update(t for t in trace_ids if t)

    def flush(self) -> int:
        """Persist buffered keeps and trim expired rows. Sampler-tick
        ride-along; returns the number of rows written."""
        with self._lock:
            rows = list(self._pending)
            self._pending.clear()
        # Retention compares stored wall stamps across processes; the
        # monotonic clock does not cross the db boundary.
        cutoff = time.time() - self.retention_s  # vmtlint: disable=VMT109
        with self._conn() as c:
            if rows:
                c.executemany(
                    "INSERT OR REPLACE INTO traces (trace_id, ident, task, "
                    "tenant, verdict, keep_reason, dur_ms, stored_unix, "
                    "spans, cost) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                    rows)
            c.execute("DELETE FROM traces WHERE stored_unix < ?", (cutoff,))
        return len(rows)

    # ------------------------------------------------------------- read side
    _COLS = ("trace_id", "ident", "task", "tenant", "verdict",
             "keep_reason", "dur_ms", "stored_unix")

    def list(self, *, verdict: Optional[str] = None,
             task: Optional[str] = None, tenant: Optional[str] = None,
             scope: str = "fleet", limit: int = 50) -> List[Dict[str, Any]]:
        """Row summaries, newest first. ``verdict`` matches the terminal
        verdict, or — for ``slow``/``sampled``/``pinned`` — the keep
        reason. ``scope="local"`` restricts to this process's ident;
        the default reads every ident on disk, stale peers included."""
        clauses, params = [], []
        if verdict in ("slow", "sampled", "pinned"):
            clauses.append("keep_reason = ?")
            params.append(verdict)
        elif verdict:
            clauses.append("verdict = ?")
            params.append(verdict)
        if task:
            clauses.append("task = ?")
            params.append(task)
        if tenant:
            clauses.append("tenant = ?")
            params.append(tenant)
        if scope == "local":
            clauses.append("ident = ?")
            params.append(self.ident)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        params.append(max(int(limit), 1))
        with self._conn() as c:
            rows = c.execute(
                f"SELECT {', '.join(self._COLS)} FROM traces{where} "
                f"ORDER BY stored_unix DESC LIMIT ?", params).fetchall()
        return [dict(zip(self._COLS, r)) for r in rows]

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Full stored record — spans and cost parsed — regardless of
        which (possibly dead) peer stored it."""
        with self._conn() as c:
            row = c.execute(
                f"SELECT {', '.join(self._COLS)}, spans, cost FROM traces "
                f"WHERE trace_id = ?", (trace_id,)).fetchone()
        if row is None:
            return None
        out = dict(zip(self._COLS, row[:-2]))
        out["spans"] = json.loads(row[-2])
        out["cost"] = json.loads(row[-1])
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            offered, kept = self.offered, self.kept
            pending = len(self._pending)
        return {"offered": offered, "kept": kept, "pending": pending,
                "tail_kept_frac": round(kept / offered, 4)
                if offered else None}
