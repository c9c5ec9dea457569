"""Durable job queue (sqlite-backed), wire-compatible with the reference.

Reference capability: the RabbitMQ layer — producer ``vilbert_task``
(reference demo/sender.py:10-35: durable queue ``vilbert_multitask_queue``,
persistent JSON messages ``{image_path, question, socket_id, task_id}``) and
the worker's blocking consume + ack (worker.py:661-673,650).

Redesign, not translation: a broker daemon is replaced by an embedded
WAL-mode sqlite file, which keeps the reference's durability guarantees
(jobs survive process death; unacked jobs are redelivered) while fixing the
poison-message loop the reference has (worker.py:650-655 — a job that always
throws is redelivered forever): delivery attempts are counted and jobs move
to a dead-letter state after ``max_delivery_attempts``.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.resilience.faults import fault_point


@dataclass
class Job:
    id: int
    body: Dict[str, Any]
    attempts: int
    deliveries: int = 0


class DurableQueue:
    """Embedded durable queue with at-least-once delivery + dead-lettering.

    Two independent poison bounds govern redelivery:

    - ``max_delivery_attempts`` counts *charged* attempts (claims minus
      releases) — the classic nack-toward-dead-letter path;
    - ``max_deliveries`` counts TOTAL claims, release or not. It exists
      because ``release()`` un-charges the attempt (graceful drain and
      replica failover are not the job's fault), which would otherwise
      reopen the reference's redeliver-forever loop for a job that crashes
      every replica it lands on: such jobs release, redeliver, and crash
      the next replica. After ``max_deliveries`` claims the job is
      quarantined as dead regardless of its attempt balance.
    """

    def __init__(self, path: str, *, queue_name: str = "vilbert_multitask_queue",
                 max_delivery_attempts: int = 3,
                 max_deliveries: int = 3,
                 visibility_timeout_s: float = 300.0):
        self.path = path
        self.queue_name = queue_name
        self.max_delivery_attempts = max_delivery_attempts
        self.max_deliveries = max_deliveries
        self.visibility_timeout_s = visibility_timeout_s
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._conn() as c:
            # One write transaction for create + index + migrations: DDL
            # autocommits per-statement under the implicit mode, so two
            # processes booting at once would race the PRAGMA-guarded
            # ALTERs below (the loser dies on "duplicate column").
            c.execute("BEGIN IMMEDIATE")
            c.execute(
                """CREATE TABLE IF NOT EXISTS jobs (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    queue TEXT NOT NULL,
                    body TEXT NOT NULL,
                    status TEXT NOT NULL DEFAULT 'pending',
                    attempts INTEGER NOT NULL DEFAULT 0,
                    claimed_at REAL,
                    created_at REAL NOT NULL
                )"""
            )
            c.execute("CREATE INDEX IF NOT EXISTS jobs_ready "
                      "ON jobs (queue, status, id)")
            # Schema migration for pre-existing queue files: CREATE TABLE IF
            # NOT EXISTS never adds columns, and serving state survives
            # restarts by design.
            cols = {r[1] for r in c.execute("PRAGMA table_info(jobs)")}
            if "delivery_count" not in cols:
                c.execute("ALTER TABLE jobs ADD COLUMN "
                          "delivery_count INTEGER NOT NULL DEFAULT 0")
            if "dead_notified" not in cols:
                # 0 until some consumer has pushed the terminal dead_letter
                # frame for this row; pop_dead_letters() flips it atomically
                # so exactly one consumer notifies the client.
                c.execute("ALTER TABLE jobs ADD COLUMN "
                          "dead_notified INTEGER NOT NULL DEFAULT 0")
            if "claimed_by" not in cols:
                # Which process incarnation (WorkerIdentity.ident,
                # host:pid:nonce) holds the in-flight claim — the queue-side
                # half of fleet observability: a stuck job names its holder.
                c.execute("ALTER TABLE jobs ADD COLUMN claimed_by TEXT")

    def _conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    # ---------------------------------------------------------------- producer
    def publish(self, body: Dict[str, Any]) -> int:
        """Persist one job (the reference's delivery_mode=2, sender.py:30-31)."""
        body = fault_point("queue.publish", body)
        with self._conn() as c:
            cur = c.execute(
                "INSERT INTO jobs (queue, body, created_at) VALUES (?, ?, ?)",
                (self.queue_name, json.dumps(body), time.time()),
            )
            return int(cur.lastrowid)

    # ---------------------------------------------------------------- consumer
    def claim(self, exclude: Sequence[int] = (),
              claimed_by: Optional[str] = None) -> Optional[Job]:
        """Atomically claim the oldest deliverable job (None if drained).

        ``exclude`` skips specific job ids for this call — the batch worker
        uses it so a failing job doesn't block or spin while its batchmates
        drain. ``claimed_by`` stamps the claimer's process identity on the
        row so introspection can name the holder of every in-flight job.

        Also sweeps expired in-flight claims back to pending — the embedded
        equivalent of a broker's visibility timeout, covering worker crashes
        between claim and ack (reference relies on connection-drop redelivery,
        worker.py:653-655).
        """
        fault_point("queue.claim")
        now = time.time()
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            c.execute(
                "UPDATE jobs SET status='pending', claimed_at=NULL, "
                "claimed_by=NULL "
                "WHERE queue=? AND status='inflight' AND claimed_at < ?",
                # Deadline math on persisted wall-clock stamps: claimed_at is
                # written by (possibly) another process, so a monotonic clock
                # cannot be compared against it.
                (self.queue_name, now - self.visibility_timeout_s),  # vmtlint: disable=VMT109
            )
            # Jobs that crash the whole worker never reach nack(); without
            # this, a timed-out claim would redeliver them forever.
            c.execute(
                "UPDATE jobs SET status='dead', claimed_at=NULL "
                "WHERE queue=? AND status='pending' AND attempts >= ?",
                (self.queue_name, self.max_delivery_attempts),
            )
            # Poison quarantine on TOTAL deliveries: release() un-charges
            # the attempt, so a job that kills every replica it lands on
            # (failover → release → redeliver) never trips the attempts
            # bound above. delivery_count only ever increments.
            poisoned = c.execute(
                "UPDATE jobs SET status='dead', claimed_at=NULL "
                "WHERE queue=? AND status='pending' AND delivery_count >= ?",
                (self.queue_name, self.max_deliveries),
            ).rowcount
            exclude = list(exclude)
            not_in = (
                f" AND id NOT IN ({','.join('?' * len(exclude))})"
                if exclude else ""
            )
            row = c.execute(
                "SELECT id, body, attempts, delivery_count FROM jobs "
                f"WHERE queue=? AND status='pending'{not_in} "
                "ORDER BY id LIMIT 1",
                (self.queue_name, *exclude),
            ).fetchone()
            if row is None:
                if poisoned:
                    obs.POISON_COUNTER.inc(poisoned)
                return None
            job_id, body, attempts, deliveries = row
            c.execute(
                "UPDATE jobs SET status='inflight', attempts=attempts+1, "
                "delivery_count=delivery_count+1, claimed_at=?, "
                "claimed_by=? WHERE id=?",
                (now, claimed_by, job_id),
            )
        if poisoned:
            obs.POISON_COUNTER.inc(poisoned)
        return Job(id=job_id, body=json.loads(body), attempts=attempts + 1,
                   deliveries=deliveries + 1)

    def ack(self, job_id: int) -> None:
        """Success: remove the job (reference basic_ack, worker.py:650)."""
        with self._conn() as c:
            c.execute("DELETE FROM jobs WHERE id=?", (job_id,))

    def nack(self, job_id: int) -> str:
        """Failure: requeue, or dead-letter once attempts are exhausted.

        Returns the resulting status ('pending' or 'dead').
        """
        with self._conn() as c:
            # Take the write lock before reading `attempts`: under the
            # deferred default the SELECT is lock-free, so a concurrent
            # process could claim-and-charge this job between our read and
            # the dependent status write (lost update / SQLITE_BUSY
            # upgrade). Same discipline as claim()/pop_dead_letters().
            c.execute("BEGIN IMMEDIATE")
            row = c.execute(
                "SELECT attempts FROM jobs WHERE id=?", (job_id,)
            ).fetchone()
            if row is None:
                return "gone"
            status = ("dead" if row[0] >= self.max_delivery_attempts
                      else "pending")
            # An explicit nack's caller pushes the terminal frame itself
            # (worker._fail_job) — mark notified so pop_dead_letters()
            # never double-pushes for this row.
            c.execute(
                "UPDATE jobs SET status=?, claimed_at=NULL, claimed_by=NULL, "
                "dead_notified=? WHERE id=?",
                (status, 1 if status == "dead" else 0, job_id),
            )
        if status == "dead":
            # A poison job is poison however it dead-letters: the explicit
            # nack path must feed vmt_poison_jobs_total the same as the
            # claim-side sweep — the autoscaler's storm gate reads the
            # counter's windowed rate and must see BOTH paths.
            obs.POISON_COUNTER.inc()
        return status

    def release(self, job_id: int) -> None:
        """Un-claim without charging a delivery attempt, for consumers that
        claim a job and then decline to process it (load shedding, graceful
        shutdown with claims in hand). The batch worker's failure path uses
        ``claim(exclude=...)`` instead — release is for *unprocessed* jobs."""
        with self._conn() as c:
            c.execute(
                "UPDATE jobs SET status='pending', claimed_at=NULL, "
                "claimed_by=NULL, attempts=MAX(attempts-1, 0) "
                "WHERE id=? AND status='inflight'",
                (job_id,),
            )

    # ------------------------------------------------------------------ introspection
    def counts(self) -> Dict[str, int]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT status, COUNT(*) FROM jobs WHERE queue=? "
                "GROUP BY status",
                (self.queue_name,),
            ).fetchall()
        return {status: n for status, n in rows}

    def inflight_claims(self) -> list[Dict[str, Any]]:
        """Who holds what: each in-flight job's id, holder identity, and
        claim age — the fleet-health answer to "is this job stuck, and on
        which process"."""
        with self._conn() as c:
            rows = c.execute(
                "SELECT id, claimed_by, claimed_at FROM jobs "
                "WHERE queue=? AND status='inflight' ORDER BY id",
                (self.queue_name,),
            ).fetchall()
        # Persisted wall stamps, possibly from another process (same
        # rationale as oldest_pending_age_s).
        now = time.time()
        return [{"id": i, "claimed_by": by,
                 "age_s": (round(max(0.0, now - at), 3)  # vmtlint: disable=VMT109
                           if at is not None else None)}
                for i, by, at in rows]

    def oldest_pending_age_s(self) -> Optional[float]:
        """Age of the oldest pending job (None when the queue is empty) —
        the admission controller's queue-age overload signal."""
        with self._conn() as c:
            row = c.execute(
                "SELECT MIN(created_at) FROM jobs "
                "WHERE queue=? AND status='pending'",
                (self.queue_name,),
            ).fetchone()
        if row is None or row[0] is None:
            return None
        # Age of a persisted wall-clock stamp (possibly written by another
        # process) — monotonic clocks cannot be compared cross-process.
        return max(0.0, time.time() - row[0])  # vmtlint: disable=VMT109

    def dead_jobs(self) -> list[Job]:
        with self._conn() as c:
            rows = c.execute(
                "SELECT id, body, attempts, delivery_count FROM jobs "
                "WHERE queue=? AND status='dead' ORDER BY id",
                (self.queue_name,),
            ).fetchall()
        return [Job(i, json.loads(b), a, d) for i, b, a, d in rows]

    def pop_dead_letters(self) -> list[Job]:
        """Atomically take the dead jobs nobody has told the client about.

        Claim-sweep dead-letters (worker crashed mid-job, or poison
        quarantine after ``max_deliveries``) happen inside ``claim()``
        where no caller holds the job body — so the terminal
        ``dead_letter`` push can't be sent at the kill site. Consumers
        call this after each claim; the notified flag flips inside one
        BEGIN IMMEDIATE transaction so exactly one consumer pushes each
        job's terminal frame (exactly-one-terminal survives multi-worker
        and multi-replica claim races).
        """
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            rows = c.execute(
                "SELECT id, body, attempts, delivery_count FROM jobs "
                "WHERE queue=? AND status='dead' AND dead_notified=0 "
                "ORDER BY id",
                (self.queue_name,),
            ).fetchall()
            if rows:
                c.executemany(
                    "UPDATE jobs SET dead_notified=1 WHERE id=?",
                    [(r[0],) for r in rows],
                )
        return [Job(i, json.loads(b), a, d) for i, b, a, d in rows]


def make_job_message(image_paths, question: str, task_id: int,
                     socket_id: str, *,
                     collect_attention: "bool | str" = False,
                     trace_id: "str | None" = None,
                     deadline: "Dict[str, float] | None" = None,
                     published_unix: "float | None" = None,
                     tenant: "str | None" = None,
                     cache_key: "str | None" = None
                     ) -> Dict[str, Any]:
    """The reference wire schema (demo/sender.py:26-31): ``image_path`` is a
    list of absolute paths, ``question`` the (pre-lowercased) query.

    ``collect_attention`` extends the schema: the reference requests
    per-layer attention maps on every forward (worker.py:288,
    ``output_all_attention_masks=True``) but never surfaces them; here the
    maps are opt-in per job — truthy returns the [CLS]→regions summary in
    the result payload; the string ``"full"`` additionally persists every
    per-bridge per-head map, retrievable via ``/attention/<qa_id>`` and as
    a downloadable ``.npz``.
    """
    msg = {
        "image_path": list(image_paths),
        "question": question,
        "task_id": str(task_id),  # reference sends str; worker eval()s it
        "socket_id": socket_id,
    }
    if collect_attention:
        msg["collect_attention"] = collect_attention
    if trace_id:
        # Cross-thread span correlation: the worker re-enters this trace
        # (obs.trace_scope) so submit → claim → infer → push share one id.
        msg["trace_id"] = trace_id
    if deadline:
        # Deadline.to_wire(): the worker re-anchors the remaining budget to
        # its own monotonic clock and sheds expired jobs before dispatch.
        msg["deadline"] = deadline
    if published_unix is not None:
        # Wall-clock submit stamp (cross-process, so epoch not monotonic —
        # same rationale as Deadline.issued_unix): the worker's claim path
        # turns it into vmt_queue_wait_ms, the publish→claim delay that
        # intake-anchored e2e latency cannot see.
        msg["published_unix"] = published_unix
    if tenant:
        # Cost-attribution billing dimension (obs/attrib.py): who to
        # charge this job's device-seconds to. Absent means "anon" —
        # the attributor defaults it, so old producers stay valid.
        msg["tenant"] = tenant
    if cache_key:
        # Result-cache/singleflight key (serve/resultcache.py): this job
        # is the leader for the key — the worker writes the result
        # through at completion and fans every terminal frame out to the
        # key's coalesced followers. Absent means uncacheable (e.g.
        # attention-collecting submits) — terminals stay point-to-point.
        msg["cache_key"] = cache_key
    return msg
