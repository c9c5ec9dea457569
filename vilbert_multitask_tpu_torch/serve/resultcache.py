"""Durable result cache + in-flight coalescing (singleflight) registry.

At millions-of-users scale the 12-in-1 traffic is heavily duplicated —
the same viral image with the same question — yet every submit used to
pay a full device forward. This module makes duplicates ~free behind one
cache key (:func:`cache_key`): task id, content-stable image identities
(path + mtime_ns + size, the feature store's identity idiom), the
whitespace-canonicalized question text, and the serving config
fingerprint / model generation (so a rolling swap invalidates, never
serves stale).

Two tables live in the SAME WAL-sqlite file as the durable queue
(``serve/queue.py``), under the queue's ``BEGIN IMMEDIATE`` discipline,
so the txn tier declares them in ``TXN_SURFACE.json`` with their own
recovered state machine:

- ``result_cache`` — one row per key, ``state`` walking
  ``'leading' -> 'done'``. A ``'leading'`` row is the singleflight
  admit: exactly one submit per key wins leadership (publishes the one
  real job); concurrent identical submits attach as followers. A
  ``'done'`` row carries the written-through payload; hits skip the
  queue and the device entirely.
- ``cache_followers`` — the keyed follower registry. Terminal frames
  fan out to every follower via the push hub;
  :meth:`ResultCache.pop_followers` is a destructive pop inside one
  write transaction so each follower is fanned exactly once
  (exactly-one-terminal per *submit*, not just per job).

Crash story: a leader that dies without reaching any worker terminal
leaves its ``'leading'`` row behind. The row carries ``created_at``; a
later identical submit past ``lease_s`` takes the lease over (same
``state='leading'`` write, recovered as the self-transition) and
republishes, inheriting the stranded followers — so no follower waits
on a corpse forever.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _image_identity(path: str) -> str:
    """Content-stable identity (features.store.file_identity idiom),
    best-effort: a path that cannot be stat'd (remote URI, dryrun
    placeholder) keys on the raw string — still correct, just blind to
    file replacement."""
    try:
        st = os.stat(path)
        return f"{path}:{st.st_mtime_ns}:{st.st_size}"
    except OSError:
        return path


def canonical_question(question: str) -> str:
    """Whitespace-canonical text: strip + collapse runs. Lowercasing is
    an upstream serving policy (ServingConfig.lowercase_questions) and
    happens before the key is derived, so both spellings of the policy
    cache consistently."""
    return " ".join(question.split())


def cache_key(task_id: "int | str", image_paths: Sequence[str],
              question: str, fingerprint: str) -> str:
    """The one cache key: (task, feature-content hash, canonicalized
    text, config_fingerprint/model_gen) — deterministic sha256 over the
    canonical JSON encoding."""
    canon = {
        "task": str(task_id),
        "images": [_image_identity(p) for p in image_paths],
        "question": canonical_question(question),
        "fingerprint": fingerprint,
    }
    raw = json.dumps(canon, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(raw.encode("utf-8")).hexdigest()


@dataclass
class Follower:
    """One coalesced submit waiting on the leader's terminal frame."""
    socket_id: str
    trace_id: Optional[str]
    tenant: Optional[str]
    attached_at: float


class ResultCache:
    """Durable result cache + singleflight follower registry.

    Lives next to the jobs table (same sqlite path as
    :class:`~vilbert_multitask_tpu_torch.serve.queue.DurableQueue`) so cache
    state shares the queue's durability and its one-writer-at-a-time
    ``BEGIN IMMEDIATE`` discipline: every read-modify-write below takes
    the write lock before reading, which is what makes the
    exactly-one-leader claim and the exactly-once follower pop hold
    across worker threads and processes.
    """

    def __init__(self, path: str, *, fingerprint: str,
                 max_rows: int = 4096, ttl_s: float = 3600.0,
                 lease_s: float = 120.0):
        self.path = path
        self.fingerprint = fingerprint
        self.max_rows = max_rows
        self.ttl_s = ttl_s
        self.lease_s = lease_s
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._conn() as c:
            # One write transaction for the DDL, same rationale as the
            # queue's boot: two processes booting at once must not race
            # the CREATEs.
            c.execute("BEGIN IMMEDIATE")
            c.execute(
                """CREATE TABLE IF NOT EXISTS result_cache (
                    cache_key TEXT PRIMARY KEY,
                    state TEXT NOT NULL DEFAULT 'leading',
                    payload TEXT,
                    fingerprint TEXT NOT NULL,
                    leader_job_id INTEGER,
                    created_at REAL NOT NULL,
                    completed_at REAL,
                    hits INTEGER NOT NULL DEFAULT 0
                )"""
            )
            c.execute(
                """CREATE TABLE IF NOT EXISTS cache_followers (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    cache_key TEXT NOT NULL,
                    socket_id TEXT NOT NULL,
                    trace_id TEXT,
                    tenant TEXT,
                    attached_at REAL NOT NULL
                )"""
            )
            c.execute("CREATE INDEX IF NOT EXISTS cache_followers_key "
                      "ON cache_followers (cache_key, id)")

    def _conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    # ------------------------------------------------------------- submit path
    def admit(self, key: str, *, socket_id: str,
              trace_id: Optional[str] = None,
              tenant: Optional[str] = None,
              coalesce: bool = True) -> Tuple[str, Any]:
        """Resolve one submit against the cache, atomically.

        Returns one of:

        - ``("hit", payload)`` — a live ``'done'`` row; the caller
          pushes the cached result and never touches the queue;
        - ``("attach", leader_job_id)`` — an in-flight ``'leading'``
          row; this submit was registered as a follower and the caller
          must NOT publish (the leader's terminal fans out to it);
        - ``("lead", None)`` — this submit won the singleflight claim
          (fresh key, expired TTL, stale fingerprint, or lease takeover
          from a dead leader) and must publish the one real job, then
          :meth:`set_leader`.

        ``coalesce=False`` (ServingConfig.coalesce_enabled off) turns
        the attach branch into a plain lead: the duplicate publishes its
        own job, the shared ``'done'`` write-through stays last-wins.

        The whole decision is one ``BEGIN IMMEDIATE`` transaction: two
        identical concurrent submits serialize on the write lock, so
        exactly one leads and the other attaches.
        """
        now = time.time()
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            row = c.execute(
                "SELECT state, payload, fingerprint, leader_job_id, "
                "created_at, completed_at FROM result_cache "
                "WHERE cache_key=?",
                (key,),
            ).fetchone()
            if row is not None:
                state, payload, fprint, leader_id, created_at, done_at = row
                # Persisted wall stamps, possibly another process's
                # clock (same rationale as queue.claim's sweep).
                stale = (
                    fprint != self.fingerprint
                    or (state == "done" and done_at is not None
                        and now - done_at > self.ttl_s)  # vmtlint: disable=VMT109
                )
                if stale:
                    c.execute("DELETE FROM result_cache WHERE cache_key=?",
                              (key,))
                    row = None
                elif state == "done":
                    c.execute(
                        "UPDATE result_cache SET hits=hits+1 "
                        "WHERE cache_key=?",
                        (key,),
                    )
                    return "hit", json.loads(payload)
                elif now - created_at > self.lease_s:  # vmtlint: disable=VMT109
                    # Dead-leader takeover: re-arm the lease and lead
                    # again; stranded followers stay attached and ride
                    # the new leader's terminal fan-out.
                    c.execute(
                        "UPDATE result_cache SET state='leading', "
                        "leader_job_id=NULL, created_at=? "
                        "WHERE cache_key=? AND state='leading'",
                        (now, key),
                    )
                    return "lead", None
                elif not coalesce:
                    return "lead", None
                else:
                    c.execute(
                        "INSERT INTO cache_followers "
                        "(cache_key, socket_id, trace_id, tenant, "
                        "attached_at) VALUES (?, ?, ?, ?, ?)",
                        (key, socket_id, trace_id, tenant, now),
                    )
                    return "attach", leader_id
            if row is None:
                c.execute(
                    "INSERT INTO result_cache "
                    "(cache_key, state, fingerprint, created_at) "
                    "VALUES (?, 'leading', ?, ?)",
                    (key, self.fingerprint, now),
                )
            return "lead", None

    def set_leader(self, key: str, job_id: int) -> None:
        """Stamp the published job id on the leading row — introspection
        ("which job is this key waiting on") and the attach branch's
        returned leader id."""
        with self._conn() as c:
            c.execute(
                "UPDATE result_cache SET leader_job_id=? "
                "WHERE cache_key=? AND state='leading'",
                (job_id, key),
            )

    # ----------------------------------------------------------- worker side
    def complete(self, key: str, payload: Dict[str, Any]) -> None:
        """Write-through at job completion: ``'leading' -> 'done'``.

        Guarded on the current state so a row invalidated mid-flight
        (rolling swap) is NOT resurrected with a stale-generation
        payload — the UPDATE simply matches nothing.
        """
        now = time.time()
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            c.execute(
                "UPDATE result_cache SET state='done', payload=?, "
                "completed_at=? WHERE cache_key=? AND state='leading'",
                (json.dumps(payload), now, key),
            )
            # Capacity trim: evict oldest-completed rows beyond
            # max_rows, inside the same write transaction.
            c.execute(
                "DELETE FROM result_cache WHERE state='done' "
                "AND cache_key IN (SELECT cache_key FROM result_cache "
                "WHERE state='done' ORDER BY completed_at DESC "
                "LIMIT -1 OFFSET ?)",
                (self.max_rows,),
            )

    def abandon(self, key: str) -> None:
        """Leader reached a non-result terminal (dead-letter, deadline,
        drain without requeue): drop the singleflight claim so the next
        identical submit retries instead of attaching to a corpse."""
        with self._conn() as c:
            c.execute(
                "DELETE FROM result_cache "
                "WHERE cache_key=? AND state='leading'",
                (key,),
            )

    def pop_followers(self, key: str) -> List[Follower]:
        """Destructively take every follower for ``key`` — one write
        transaction, so with multiple workers racing a terminal each
        follower is returned to exactly one caller (the fan-out side of
        exactly-one-terminal per submit)."""
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            rows = c.execute(
                "SELECT socket_id, trace_id, tenant, attached_at "
                "FROM cache_followers WHERE cache_key=? ORDER BY id",
                (key,),
            ).fetchall()
            if rows:
                c.execute("DELETE FROM cache_followers WHERE cache_key=?",
                          (key,))
        return [Follower(s, t, ten, at) for s, t, ten, at in rows]

    def peek_followers(self, key: str) -> List[Follower]:
        """Non-destructive read, for NON-terminal frames (requeued /
        failover notices): followers stay attached and still get the
        eventual terminal."""
        with self._conn() as c:
            rows = c.execute(
                "SELECT socket_id, trace_id, tenant, attached_at "
                "FROM cache_followers WHERE cache_key=? ORDER BY id",
                (key,),
            ).fetchall()
        return [Follower(s, t, ten, at) for s, t, ten, at in rows]

    # ---------------------------------------------------------- invalidation
    def invalidate(self, new_fingerprint: str) -> int:
        """Rolling swap landed: adopt the new fingerprint/model_gen and
        drop every row keyed to any other generation. Followers of
        in-flight leaders stay attached — they submitted against the old
        generation and still get its result; the row's deletion just
        stops the stale payload from being *cached*."""
        with self._conn() as c:
            c.execute("BEGIN IMMEDIATE")
            dropped = c.execute(
                "DELETE FROM result_cache WHERE fingerprint != ?",
                (new_fingerprint,),
            ).rowcount
        self.fingerprint = new_fingerprint
        return int(dropped)

    # ---------------------------------------------------------- introspection
    def stats(self) -> Dict[str, float]:
        """Sampler-shaped flat floats (rides /metrics via app._sample)."""
        with self._conn() as c:
            done, hits = c.execute(
                "SELECT COUNT(*), COALESCE(SUM(hits), 0) "
                "FROM result_cache WHERE state='done'",
            ).fetchone()
            leading = c.execute(
                "SELECT COUNT(*) FROM result_cache WHERE state='leading'",
            ).fetchone()[0]
            followers = c.execute(
                "SELECT COUNT(*) FROM cache_followers",
            ).fetchone()[0]
        return {
            "cache_done_rows": float(done),
            "cache_leading_rows": float(leading),
            "cache_followers": float(followers),
            "cache_stored_hits": float(hits),
        }
