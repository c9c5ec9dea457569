"""Per-request cost attribution: where each job's milliseconds went.

The aggregate histograms (``vmt_span_ms``, ``request_latency_ms``) answer
"how slow is the system"; this plane answers the question an autoscaler
or a tenant-fairness scheduler has to ask — *which task and which tenant
spent which stage's milliseconds and whose device-seconds* — per job,
assembled across the pipeline and rolled into billable totals.

One :class:`JobCost` record per claimed job, keyed by trace id. Stages
(all wall milliseconds):

========== ============================================================
queue_wait publish → claim (from the job body's ``published_unix``)
intake     claim → prepared request (tokenize + feature I/O)
ready_wait prepared → selected into a batch (scheduler EDF window)
pack       batch assembly up to the forward dispatch
forward    amortized device share: batch forward wall × member_rows /
           batch_rows, charged per member by the completion stage — the
           batch-fill inefficiency a per-request view otherwise hides
decode     result marshal + persist
push       terminal frame → socket hub
========== ============================================================

The forward share is double-entry bookkeeping: :meth:`charge_batch` adds
the full batch wall to an engine-busy ledger once per dispatch and the
per-member shares to the jobs, so ``sum(job.device_s) == busy_s`` exactly
when every member streams — the conservation invariant the soak gates at
10%. A member that dies mid-batch is simply never charged (its share
stays on the busy ledger as waste the amortization gauge shows).

Totals feed three instruments — ``vmt_device_seconds_total{task,tenant}``,
``vmt_cost_ms{stage,task}``, ``vmt_batch_amortization{bucket}`` — and a
bounded completed-ring serves ``GET /debug/costs?window_s=&by=`` windowed
aggregates.

Module plane: like the flight recorder, the process installs one
:class:`CostAttributor` (``set_attributor``) and the pipeline calls the
``job_*`` helpers, which are a single None-check when attribution is off
(<5 µs, the span/fault-point discipline).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from vilbert_multitask_tpu_torch.obs.instruments import REGISTRY

STAGES = ("queue_wait", "intake", "ready_wait", "pack", "forward",
          "decode", "push")

# Billable totals the autoscaler / tenant-QoS tiers consume. task+tenant
# and stage+task are bounded vocabularies (the task registry and the
# fixed stage table) — never raw request data.
DEVICE_SECONDS = REGISTRY.counter(
    "vmt_device_seconds_total",
    "Amortized device-forward seconds attributed per task and tenant.",
    labelnames=("task", "tenant"))
COST_MS = REGISTRY.histogram(
    "vmt_cost_ms",
    "Per-job stage cost (ms) observed at job completion.",
    labelnames=("stage", "task"))
BATCH_AMORTIZATION = REGISTRY.gauge(
    "vmt_batch_amortization",
    "Charged-row fraction of the last dispatched batch per row bucket "
    "(1.0 = every forward second billed to a streamed member).",
    labelnames=("bucket",))


@dataclasses.dataclass
class JobCost:
    """One job's attributed cost, assembled claim → terminal verdict."""

    trace_id: str
    job_id: Optional[int] = None
    task: str = ""
    tenant: str = "anon"
    replica: str = ""
    bucket: str = ""
    verdict: str = ""
    stages: Dict[str, float] = dataclasses.field(
        default_factory=dict)  # stage -> ms
    device_s: float = 0.0
    member_rows: int = 0
    batch_rows: int = 0
    started_unix: float = 0.0
    finished_unix: float = 0.0

    def total_ms(self) -> float:
        return sum(self.stages.values())

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["total_ms"] = round(self.total_ms(), 3)
        return d


class CostAttributor:
    """Assembles :class:`JobCost` records across pipeline threads.

    Open records live in a bounded dict keyed by trace id (claim begins
    one, the terminal verdict closes it); closed records move to a
    bounded ring the windowed aggregates read. ``on_finish`` is the
    trace-store hook — called outside the lock with the completed record.
    """

    def __init__(self, *, max_open: int = 4096, ring: int = 4096,
                 on_finish: Optional[Callable[[JobCost], None]] = None):
        self._lock = threading.Lock()
        self._open: Dict[str, JobCost] = {}
        self._open_order: deque = deque()
        self._max_open = int(max_open)
        self._done: deque = deque(maxlen=int(ring))
        # The ring's records by trace id: a batch may be charged after its
        # members' completion closed them (see charge_batch).
        self._closed: "OrderedDict[str, JobCost]" = OrderedDict()
        self.on_finish = on_finish
        self.busy_s = 0.0          # engine ledger: full batch walls, once
        self.attributed_s = 0.0    # job ledger: per-member shares
        self.finished = 0

    # ------------------------------------------------------------- writers
    def begin(self, trace_id: str, *, job_id: Optional[int] = None,
              task: str = "", tenant: str = "anon") -> None:
        if not trace_id:
            return
        with self._lock:
            cost = self._open.get(trace_id)
            if cost is None:
                if len(self._open) >= self._max_open and self._open_order:
                    self._open.pop(self._open_order.popleft(), None)
                cost = JobCost(trace_id=trace_id)
                # Wall stamp (cross-process correlation key, not a
                # duration) — durations all come in via charge().
                cost.started_unix = time.time()
                self._open[trace_id] = cost
                self._open_order.append(trace_id)
            cost.job_id = job_id if job_id is not None else cost.job_id
            cost.task = task or cost.task
            cost.tenant = tenant or cost.tenant

    def charge(self, trace_id: str, stage: str, dur_s: float) -> None:
        """Add ``dur_s`` of wall time to one stage of one job."""
        if not trace_id:
            return
        with self._lock:
            cost = self._open.get(trace_id)
            if cost is None:
                return
            cost.stages[stage] = cost.stages.get(stage, 0.0) \
                + max(dur_s, 0.0) * 1e3

    def charge_batch(self, batch_wall_s: float,
                     members: Sequence[Tuple[str, int]], *,
                     batch_rows: int, bucket: int = 0,
                     replica: str = "") -> None:
        """Amortize one dispatched batch's forward wall over its
        (streamed) members: share_i = wall × rows_i / batch_rows.

        ``members`` lists only the jobs that actually streamed a result —
        a mid-batch failure's members are never charged, so the busy
        ledger (credited the FULL wall exactly once here) shows the
        difference as unbilled waste.

        A streamed member's completion may close its record before the
        dispatcher gets here (the completion stage runs on its own
        thread); such a record is charged in the ring where it now lives,
        so the two ledgers agree whichever thread is first. (The JAX
        package charges open records only and loses those shares.)
        """
        batch_wall_s = max(batch_wall_s, 0.0)
        rows_total = max(int(batch_rows), 1)
        charged_rows = 0
        with self._lock:
            self.busy_s += batch_wall_s
            for trace_id, rows in members:
                rows = max(int(rows), 1)
                charged_rows += rows
                cost = (self._open.get(trace_id)
                        or self._closed.get(trace_id))
                if cost is None:
                    continue
                share = batch_wall_s * rows / rows_total
                cost.device_s += share
                cost.stages["forward"] = cost.stages.get("forward", 0.0) \
                    + share * 1e3
                cost.member_rows += rows
                cost.batch_rows = rows_total
                cost.bucket = str(bucket)
                cost.replica = replica or cost.replica
                self.attributed_s += share
                if cost.task:
                    DEVICE_SECONDS.inc(share, task=cost.task,
                                       tenant=cost.tenant)
        BATCH_AMORTIZATION.set(min(charged_rows / rows_total, 1.0),
                               bucket=str(bucket))

    def finish(self, trace_id: str, verdict: str) -> Optional[JobCost]:
        """Close a job's record with its terminal verdict; rolls the
        stage histograms and hands the record to ``on_finish``."""
        if not trace_id:
            return None
        with self._lock:
            cost = self._open.pop(trace_id, None)
            if cost is None:
                return None
            cost.verdict = verdict
            cost.finished_unix = time.time()  # wall stamp, not a duration
            self._done.append(cost)
            self._closed.pop(trace_id, None)
            self._closed[trace_id] = cost
            if len(self._closed) > self._done.maxlen:
                self._closed.popitem(last=False)
            self.finished += 1
        for stage, ms in cost.stages.items():
            COST_MS.observe(ms, stage=stage, task=cost.task or "unknown")
        hook = self.on_finish
        if hook is not None:
            try:
                hook(cost)
            except Exception:  # the store must never fail the pipeline
                pass
        return cost

    # ------------------------------------------------------------- readers
    def completed(self, since_unix: float = 0.0) -> List[JobCost]:
        with self._lock:
            return [c for c in self._done if c.finished_unix >= since_unix]

    def get(self, trace_id: str) -> Optional[JobCost]:
        with self._lock:
            c = self._open.get(trace_id)
            if c is not None:
                return c
            for c in reversed(self._done):
                if c.trace_id == trace_id:
                    return c
        return None

    def window(self, window_s: Optional[float] = None,
               by: str = "task") -> Dict[str, Any]:
        """The ``/debug/costs`` payload: per-``by`` (task|tenant) job
        counts, stage-ms totals, and device-seconds over the window."""
        key = "tenant" if by == "tenant" else "task"
        # Wall cutoff against finished_unix wall stamps (cross-restart
        # comparable, like the fleet heartbeat ages).
        cutoff = (time.time() - window_s  # vmtlint: disable=VMT109
                  if window_s else 0.0)
        groups: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            done = list(self._done)
        for cost in done:
            if cost.finished_unix < cutoff:
                continue
            g = groups.setdefault(getattr(cost, key) or "unknown", {
                "jobs": 0, "device_s": 0.0, "stage_ms": {},
                "verdicts": {}})
            g["jobs"] += 1
            g["device_s"] = round(g["device_s"] + cost.device_s, 6)
            g["verdicts"][cost.verdict] = \
                g["verdicts"].get(cost.verdict, 0) + 1
            for stage, ms in cost.stages.items():
                g["stage_ms"][stage] = round(
                    g["stage_ms"].get(stage, 0.0) + ms, 3)
        return {"by": key, "window_s": window_s, "groups": groups,
                "conservation": self.conservation()}

    def conservation(self) -> Dict[str, float]:
        """The double-entry verdict: attributed shares vs. the engine
        busy ledger. ratio == 1.0 when every batch member streamed."""
        with self._lock:
            busy, attr = self.busy_s, self.attributed_s
        return {"busy_s": round(busy, 6), "attributed_s": round(attr, 6),
                "ratio": round(attr / busy, 4) if busy > 0 else 1.0}


# ------------------------------------------------------- module-level plane
_ATTRIB: Optional[CostAttributor] = None


def set_attributor(attrib: Optional[CostAttributor]) -> None:
    global _ATTRIB
    _ATTRIB = attrib


def get_attributor() -> Optional[CostAttributor]:
    return _ATTRIB


def job_begin(trace_id: str, *, job_id: Optional[int] = None,
              task: str = "", tenant: str = "anon") -> None:
    a = _ATTRIB
    if a is None:
        return
    a.begin(trace_id, job_id=job_id, task=task, tenant=tenant)


def job_charge(trace_id: str, stage: str, dur_s: float) -> None:
    a = _ATTRIB
    if a is None:
        return
    a.charge(trace_id, stage, dur_s)


def job_batch(batch_wall_s: float, members: Sequence[Tuple[str, int]], *,
              batch_rows: int, bucket: int = 0, replica: str = "") -> None:
    a = _ATTRIB
    if a is None:
        return
    a.charge_batch(batch_wall_s, members, batch_rows=batch_rows,
                   bucket=bucket, replica=replica)


def job_finish(trace_id: str, verdict: str) -> None:
    a = _ATTRIB
    if a is None:
        return
    a.finish(trace_id, verdict)
