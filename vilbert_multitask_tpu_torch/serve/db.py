"""Result store: the ORM layer's capability on embedded sqlite.

Reference capability: the Django models (reference demo/models.py:4-46) on
PostgreSQL — ``Tasks`` (the task catalog the UI reads) and ``QuestionAnswer``
(the de-facto audit log: every job writes inputs at creation and answers on
completion, reference worker.py:548-552,579-645) — plus the admin's read path
(demo/admin.py:24-34). Credentials-in-repo (settings.py:85-94, SURVEY.md §2.4)
are gone: the store is a file next to the queue.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import Any, Dict, List, Optional

from vilbert_multitask_tpu_torch.config import TASK_REGISTRY


class ResultStore:
    def __init__(self, path: str):
        self.path = path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._conn() as c:
            # One write transaction for the whole boot migration: DDL
            # autocommits per-statement under the implicit mode, so a crash
            # or concurrent boot mid-loop would leave a half-migrated
            # schema (and race the ALTERs below).
            c.execute("BEGIN IMMEDIATE")
            c.execute(
                """CREATE TABLE IF NOT EXISTS tasks (
                    unique_id INTEGER PRIMARY KEY,
                    name TEXT NOT NULL,
                    placeholder TEXT,
                    description TEXT,
                    num_of_images INTEGER NOT NULL
                )"""
            )
            c.execute(
                """CREATE TABLE IF NOT EXISTS question_answers (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    task_id INTEGER NOT NULL,
                    input_text TEXT,
                    input_images TEXT,
                    answer_text TEXT,
                    answer_images TEXT,
                    socket_id TEXT,
                    queue_job_id INTEGER,
                    created_at REAL NOT NULL,
                    modified_at REAL NOT NULL
                )"""
            )
            c.execute(
                "CREATE UNIQUE INDEX IF NOT EXISTS qa_by_job ON "
                "question_answers (queue_job_id) WHERE queue_job_id IS NOT NULL"
            )
            # In-code migration (component row 14): the min/max image-count
            # columns drive the browser's task gating; ``edited`` marks rows
            # an admin changed by hand. Older stores get them added in place.
            for col, decl in (("num_of_images_min", "INTEGER"),
                              ("num_of_images_max", "INTEGER"),
                              ("edited", "INTEGER DEFAULT 0")):
                try:
                    c.execute(f"ALTER TABLE tasks ADD COLUMN {col} {decl}")
                except sqlite3.OperationalError as e:
                    # Only the idempotent-rerun case is expected; anything
                    # else (locked, corrupt, disk) must surface.
                    if "duplicate column" not in str(e).lower():
                        raise
            # Seed/refresh the task catalog from the typed registry (replaces
            # the reference's hand-entered admin rows, demo/models.py:4-20).
            # The registry is the source of truth on boot — EXCEPT for rows
            # an admin edited (reference parity: Django admin edits persist
            # across restarts, demo/admin.py:11-21).
            for spec in TASK_REGISTRY.values():
                c.execute(
                    "INSERT INTO tasks (unique_id, name, placeholder, "
                    "description, num_of_images, num_of_images_min, "
                    "num_of_images_max) VALUES (?, ?, ?, ?, ?, ?, ?) "
                    "ON CONFLICT(unique_id) DO UPDATE SET name=excluded.name, "
                    "placeholder=excluded.placeholder, "
                    "description=excluded.description, "
                    "num_of_images=excluded.num_of_images, "
                    "num_of_images_min=excluded.num_of_images_min, "
                    "num_of_images_max=excluded.num_of_images_max "
                    "WHERE COALESCE(tasks.edited, 0)=0",
                    (spec.task_id, spec.name, spec.placeholder,
                     spec.description, spec.max_images, spec.min_images,
                     spec.max_images),
                )

    def _conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        return conn

    # ------------------------------------------------------------------ tasks
    _TASK_COLS = ("unique_id", "name", "placeholder", "description",
                  "num_of_images", "num_of_images_min", "num_of_images_max")

    def get_task(self, task_id: int) -> Optional[Dict[str, Any]]:
        with self._conn() as c:
            row = c.execute(
                f"SELECT {', '.join(self._TASK_COLS)} FROM tasks "
                "WHERE unique_id=?",
                (task_id,),
            ).fetchone()
        return None if row is None else dict(zip(self._TASK_COLS, row))

    def list_tasks(self) -> List[Dict[str, Any]]:
        with self._conn() as c:
            rows = c.execute(
                f"SELECT {', '.join(self._TASK_COLS)} FROM tasks "
                "ORDER BY unique_id"
            ).fetchall()
        return [dict(zip(self._TASK_COLS, r)) for r in rows]

    # The admin's writable surface (reference demo/admin.py:11-21: Django
    # TaskAdmin exposes exactly the catalog fields for editing). unique_id
    # is the registry key and stays immutable.
    _TASK_EDITABLE = {"name", "placeholder", "description", "num_of_images",
                      "num_of_images_min", "num_of_images_max"}
    _TASK_INT_FIELDS = {"num_of_images", "num_of_images_min",
                        "num_of_images_max"}

    def update_task(self, task_id: int,
                    fields: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Admin edit of a catalog row; marks it ``edited`` so the boot-time
        registry reseed leaves it alone. Returns the updated row, or None if
        the task doesn't exist. Raises ValueError on unknown/ill-typed
        fields — admin typos should bounce, not half-apply."""
        unknown = set(fields) - self._TASK_EDITABLE
        if unknown or not fields:
            raise ValueError(
                f"editable fields are {sorted(self._TASK_EDITABLE)}; "
                f"got {sorted(fields) or 'nothing'}")
        clean: Dict[str, Any] = {}
        for k, v in fields.items():
            if k in self._TASK_INT_FIELDS:
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    raise ValueError(f"{k} must be a non-negative int")
            elif not isinstance(v, str):
                raise ValueError(f"{k} must be a string")
            clean[k] = v
        current = self.get_task(task_id)
        if current is None:
            return None
        # Cross-field sanity on the merged row: an inverted min/max range
        # would make the task unselectable in the browser's gating — and
        # edited=1 means the boot reseed would never repair it.
        merged = {**current, **clean}
        lo = merged.get("num_of_images_min")
        hi = merged.get("num_of_images_max")
        if lo is not None and hi is not None and lo > hi:
            raise ValueError(
                f"num_of_images_min ({lo}) > num_of_images_max ({hi})")
        with self._conn() as c:
            cur = c.execute(
                "UPDATE tasks SET "
                + ", ".join(f"{k}=?" for k in clean)
                + ", edited=1 WHERE unique_id=?",
                (*clean.values(), task_id),
            )
            if cur.rowcount == 0:
                return None
        return self.get_task(task_id)

    # --------------------------------------------------------------- QA rows
    def create_question(self, task_id: int, input_text: str,
                        input_images: List[str], socket_id: str,
                        queue_job_id: Optional[int] = None) -> int:
        """Job intake row (reference worker.py:548-552).

        When ``queue_job_id`` is given, redelivered attempts of the same
        queued job reuse the original row instead of inserting duplicates.
        """
        now = time.time()
        with self._conn() as c:
            # The dedup probe below is a read-modify-write: without the
            # write lock, two redeliveries of the same job could both miss
            # the probe and race the INSERT (one dies on the qa_by_job
            # unique index instead of reusing the row).
            c.execute("BEGIN IMMEDIATE")
            if queue_job_id is not None:
                row = c.execute(
                    "SELECT id FROM question_answers WHERE queue_job_id=?",
                    (queue_job_id,),
                ).fetchone()
                if row is not None:
                    return int(row[0])
            cur = c.execute(
                "INSERT INTO question_answers (task_id, input_text, "
                "input_images, socket_id, queue_job_id, created_at, "
                "modified_at) VALUES (?, ?, ?, ?, ?, ?, ?)",
                (task_id, input_text, json.dumps(list(input_images)),
                 socket_id, queue_job_id, now, now),
            )
            return int(cur.lastrowid)

    def save_answer(self, qa_id: int, answer: Dict[str, Any],
                    answer_images: Optional[List[str]] = None) -> None:
        """Completion update (reference worker.py:579,606,623,644)."""
        with self._conn() as c:
            c.execute(
                "UPDATE question_answers SET answer_text=?, answer_images=?, "
                "modified_at=? WHERE id=?",
                (json.dumps(answer), json.dumps(answer_images or []),
                 time.time(), qa_id),
            )

    _QA_COLS = ("id", "task_id", "input_text", "input_images", "answer_text",
                "answer_images", "socket_id", "created_at", "modified_at")

    @classmethod
    def _qa_row(cls, row) -> Dict[str, Any]:
        d = dict(zip(cls._QA_COLS, row))
        for k in ("input_images", "answer_text", "answer_images"):
            if d[k]:
                d[k] = json.loads(d[k])
        return d

    def get_question(self, qa_id: int) -> Optional[Dict[str, Any]]:
        with self._conn() as c:
            row = c.execute(
                f"SELECT {', '.join(self._QA_COLS)} FROM question_answers "
                "WHERE id=?",
                (qa_id,),
            ).fetchone()
        return None if row is None else self._qa_row(row)

    def update_question(self, qa_id: int,
                        fields: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Admin correction of an audit row (reference demo/admin.py:24-34:
        QuestionAnswer is registered in the Django admin, so its text fields
        are editable there). Only the human-readable text fields are open;
        images/socket/job linkage stay immutable. Returns the updated row
        (scrub socket_id at the API layer), None if the row doesn't exist."""
        editable = {"input_text", "answer_text"}
        unknown = set(fields) - editable
        if unknown or not fields:
            raise ValueError(
                f"editable fields are {sorted(editable)}; "
                f"got {sorted(fields) or 'nothing'}")
        sets, vals = [], []
        if "input_text" in fields:
            if not isinstance(fields["input_text"], str):
                raise ValueError("input_text must be a string")
            sets.append("input_text=?")
            vals.append(fields["input_text"])
        if "answer_text" in fields:
            # Stored as JSON, same as save_answer — accepts the same shapes
            # the decode families emit (dict/list/str).
            sets.append("answer_text=?")
            vals.append(json.dumps(fields["answer_text"]))
        with self._conn() as c:
            cur = c.execute(
                f"UPDATE question_answers SET {', '.join(sets)}, "
                "modified_at=? WHERE id=?",
                (*vals, time.time(), qa_id),
            )
            if cur.rowcount == 0:
                return None
        return self.get_question(qa_id)

    def recent(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Latest jobs, newest first (the admin list view's read,
        demo/admin.py:24-34)."""
        with self._conn() as c:
            rows = c.execute(
                f"SELECT {', '.join(self._QA_COLS)} FROM question_answers "
                "ORDER BY id DESC LIMIT ?",
                (limit,),
            ).fetchall()
        return [self._qa_row(r) for r in rows]
