"""Continuous batching: the deadline-aware cross-request scheduler.

``step_batch`` (worker.py) drains the queue in lockstep — claim N, prep N,
forward once, persist N, repeat — so the device idles through every claim
and every SQLite write, and a job arriving one tick after a batch closed
waits a whole cycle. The soak showed the cost: 44 qps served against a
217-408 qps engine ceiling (ARCHITECTURE "Round-5 hardware findings").
This module replaces that loop with the Orca/vLLM-shaped pipelined data
plane the 12-in-1 shared trunk makes possible (any task mix packs into one
forward):

    intake pool (N threads)        scheduler (dispatch thread)   completion
    claim -> deadline check        adaptive window + EDF pack    _finish_job
    -> feature I/O + prep    ==>   -> chunk_plan -> run_many ==> persist+push
    feeds _ready               results stream out per member     ack

Three rules govern the dispatch stage:

- **window**: fire when a bucket fills, when the oldest ready job has
  lingered a full window, or when any member's deadline slack drops under
  ``sched_near_deadline_ms``. The window adapts AIMD-style — a full batch
  doubles it (backlog: linger to pack more), a partial batch halves it
  (idle: fire immediately) — between ``sched_window_min_s`` and
  ``sched_window_max_s``.
- **EDF**: members pack in earliest-deadline-first order (the
  ``resilience.Deadline`` riding every job body is the key); expired
  members shed pre-pack via the worker's normal expiry path, so a forward
  is never burned on a long-gone client.
- **exactly one terminal state**: every claimed job ends in exactly one of
  result / dead-letter / deadline push — results stream member-by-member
  into the completion queue as chunks drain (engine ``on_result``), and a
  mid-batch failure fails only the members that had NOT already streamed.

Lock discipline (vmtlint VMT116 ``blocking-call-under-scheduler-lock``):
``_cond`` guards only the ready list, the window, and the stat counters —
never device dispatch, SQLite I/O, or sleeps. Expiry pushes, intake I/O,
and ``run_many`` all happen outside it; the completion queue's blocking
``put`` is the one intentional backpressure point and sits outside too.
"""

from __future__ import annotations

import math
import queue as stdlib_queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.serve.pool import NoReadyReplica
from vilbert_multitask_tpu_torch.serve.push import log_to_terminal
from vilbert_multitask_tpu_torch.serve.queue import Job


class ReadyItem:
    """One claimed + prepped job parked in the ready-queue.

    ``solo`` marks attention-map requests: they need a per-request forward
    flag, so they skip shared intake here (``step_one`` runs the whole
    pipeline for them) and never pack into a shared chunk.

    ``tenant`` is the job body's billing dimension, reused as the QoS
    class the deficit tier budgets by; ``deferred`` flips when a fire
    passed this item over for tenant-budget reasons (not row pressure
    alone), so an expiry while deferred sheds as ``tenant_budget``
    instead of ``deadline``.
    """

    __slots__ = ("job", "qa_id", "prepared", "t0", "deadline", "enq_t",
                 "solo", "tenant", "deferred")

    def __init__(self, job: Job, qa_id, prepared, t0, deadline, enq_t,
                 solo: bool = False, tenant: str = "anon"):
        self.job = job
        self.qa_id = qa_id
        self.prepared = prepared
        self.t0 = t0
        self.deadline = deadline
        self.enq_t = enq_t
        self.solo = solo
        self.tenant = tenant
        self.deferred = False

    def rows(self) -> int:
        return self.prepared.n_images if self.prepared is not None else 1

    def expiry(self) -> float:
        """EDF sort key: absolute perf-counter expiry, +inf when the job
        carries no deadline (budgetless jobs pack last, never shed)."""
        return (self.deadline.expires_at() if self.deadline is not None
                else math.inf)


def fire_decision(now: float, *, rows: int, oldest_enq_t: float,
                  nearest_expiry: float, max_rows: int, window_s: float,
                  near_deadline_s: float) -> Tuple[bool, float]:
    """Pure window policy: should a non-empty ready set fire now?

    Returns ``(fire, wait_s)`` — when not firing, ``wait_s`` is how long
    the dispatcher may sleep before one of the fire conditions can first
    become true (new arrivals re-wake it earlier via the condvar).
    ``nearest_expiry`` is +inf when no member carries a deadline.
    """
    if rows >= max_rows:
        return True, 0.0  # a bucket is full — lingering buys nothing
    if nearest_expiry - now <= near_deadline_s:
        return True, 0.0  # EDF front would miss its deadline waiting
    window_wait = (oldest_enq_t + window_s) - now
    if window_wait <= 0.0:
        return True, 0.0  # oldest member waited out the whole window
    deadline_wait = nearest_expiry - now - near_deadline_s
    return False, max(min(window_wait, deadline_wait), 0.0)


def select_batch(ready: List[ReadyItem], now: float, max_rows: int, *,
                 deficits: "Optional[dict]" = None,
                 weights: "Optional[dict]" = None,
                 default_weight: float = 1.0
                 ) -> Tuple[List[ReadyItem], List[ReadyItem],
                            List[ReadyItem]]:
    """Pure packing: ``(batch, expired, rest)``.

    Members sort earliest-deadline-first; already-expired members are
    split out for shedding (the caller expires them OUTSIDE the scheduler
    lock — expiry pushes/acks block). Packing stops charging the row
    budget once ``max_rows`` is reached; later members stay ready, still
    in EDF order, for the next fire.

    With ``deficits`` (the caller's persistent tenant→credit map) a
    weighted-deficit tier sits ABOVE the deadline ordering: each fire
    grants every present tenant ``max_rows * w/Σw`` rows of credit
    (weights from ServingConfig.tenant_weights, ``default_weight`` for
    unlisted tenants), then repeatedly packs the EDF head of the
    highest-credit tenant, spending its credit per row. The tier is
    work-conserving — the device never idles for fairness; under
    contention a hot tenant's surplus items are the ones passed over
    (marked ``deferred``, shed as ``tenant_budget`` if they expire
    waiting). A tenant whose backlog fully drains in a fire resets to
    zero credit and leaves the map, bounding its cardinality to tenants
    with live backlog. ``deficits=None`` is the pure-EDF legacy path.
    """
    batch: List[ReadyItem] = []
    expired: List[ReadyItem] = []
    rest: List[ReadyItem] = []
    live: List[ReadyItem] = []
    for item in sorted(ready, key=ReadyItem.expiry):
        if item.deadline is not None and item.expiry() <= now:
            expired.append(item)
        else:
            live.append(item)
    if deficits is None:
        rows = 0
        for item in live:
            if rows < max_rows:
                batch.append(item)
                rows += item.rows()
            else:
                rest.append(item)
        return batch, expired, rest
    # --- tenant-weighted deficit tier (DRR) above EDF ---
    weights = weights or {}
    present: "dict[str, List[ReadyItem]]" = {}
    for item in live:
        present.setdefault(item.tenant, []).append(item)
    if present:
        total_w = sum(max(weights.get(t, default_weight), 1e-9)
                      for t in present)
        for t in present:
            share = max(weights.get(t, default_weight), 1e-9) / total_w
            # Credit carries over between fires (a starved tenant's
            # backlog catches up) but is capped so an idle-then-bursty
            # tenant cannot hoard the whole device.
            deficits[t] = min(deficits.get(t, 0.0) + max_rows * share,
                              2.0 * max_rows)
    rows = 0
    while rows < max_rows:
        cands = [t for t, items in present.items() if items]
        if not cands:
            break
        # Highest credit wins the slot; earliest deadline breaks ties.
        t = max(cands, key=lambda c: (deficits.get(c, 0.0),
                                      -present[c][0].expiry()))
        item = present[t].pop(0)
        batch.append(item)
        rows += item.rows()
        deficits[t] = deficits.get(t, 0.0) - item.rows()
    for t, items in list(present.items()):
        if items:
            for item in items:
                item.deferred = True
                rest.append(item)
        else:
            # Backlog fully served: classic DRR resets the credit, and
            # dropping the entry bounds the map to live-backlog tenants.
            deficits.pop(t, None)
    rest.sort(key=ReadyItem.expiry)
    return batch, expired, rest


def adapt_window(window_s: float, fill: float, *, lo: float, hi: float
                 ) -> float:
    """Pure AIMD window update: full batches stretch (backlog — linger to
    pack the next one fuller), partial batches shrink (idle — fire fast)."""
    if fill >= 1.0:
        return min(window_s * 2.0, hi)
    return max(window_s / 2.0, lo)


class ContinuousScheduler:
    """The three-stage data plane around one :class:`ServeWorker`.

    ``run()`` owns the dispatch loop in the calling thread (the serve
    worker thread), spawns ``sched_intake_threads`` intake threads and one
    completion thread, and tears all of them down on ``stop_event``:
    intake stops claiming first, in-hand ready jobs release back to
    pending (no attempt charged), the completion queue drains, and only
    then does run() return — the same graceful-drain contract
    ``step_batch`` honored.

    ``clock`` is injectable for window/EDF tests; spans keep their own
    ``time.perf_counter`` so traces stay real under a fake clock.
    """

    def __init__(self, worker, *, stop_event: Optional[threading.Event] = None,
                 poll_interval_s: float = 0.05, clock=time.perf_counter):
        self.worker = worker
        self.serving = worker.serving
        self.stop = stop_event if stop_event is not None else threading.Event()
        self.poll_interval_s = poll_interval_s
        self.clock = clock
        # _cond guards _ready, _window_s, and _stats — NOTHING blocking
        # runs under it (VMT116).
        self._cond = threading.Condition()
        self._ready: List[ReadyItem] = []
        self._window_s = self.serving.sched_window_min_s
        self._stats = {"batches": 0, "jobs": 0, "shed": 0, "released": 0,
                       "solo": 0}
        # Tenant-weighted fairness state (select_batch's deficit tier):
        # the persistent tenant→credit map, the configured weights, and
        # a per-tenant queue-wait EWMA for the sampler. All guarded by
        # _cond like the rest of the scheduler state.
        self._fairness = bool(
            getattr(self.serving, "tenant_fairness_enabled", False))
        self._weights = dict(
            getattr(self.serving, "tenant_weights", None) or {})
        self._default_weight = float(
            getattr(self.serving, "tenant_default_weight", 1.0))
        self._deficits: dict = {}
        self._tenant_wait_ms: dict = {}
        self._completions: stdlib_queue.Queue = stdlib_queue.Queue(
            maxsize=self.serving.sched_completion_depth)
        # Replica-pool mode: when the worker's engine is a ReplicaPool
        # (duck-typed on the checkout seam), batches PIN to one replica —
        # checkout here, dispatch on an executor thread (one in-flight
        # batch per replica slot), checkin in the dispatch task. The
        # dispatch loop keeps selecting the next batch while replicas
        # compute concurrently. Legacy single engines dispatch inline.
        self.pool = (worker.engine
                     if hasattr(worker.engine, "checkout") else None)
        self._executor: Optional[ThreadPoolExecutor] = None
        if self.pool is not None:
            slots = (len(self.pool.replicas)
                     * self.serving.pool_max_inflight_per_replica)
            self._executor = ThreadPoolExecutor(
                max_workers=max(1, slots),
                thread_name_prefix="sched-dispatch")

    # -------------------------------------------------------- intake stage
    def _intake_loop(self) -> None:
        """Claim continuously; prep on this thread; park ready items.

        Backpressure: while the ready set is at ``sched_ready_depth`` this
        thread idles instead of claiming — ready jobs stay 'inflight' in
        the durable queue, so they keep counting against the HTTP door's
        AdmissionController depth (pending + inflight); the knob bounds
        claim run-ahead, it does not bypass admission.

        Runs under :func:`obs.crash_guard`: the exc tier proved the
        claim at the top of this loop sits OUTSIDE the intake
        try/except, so an injected ``queue.claim`` fault (or any remote
        transport error) would kill the thread silently. The guard
        records a ``thread_died`` bundle and flips ``/healthz`` instead.
        """
        with obs.crash_guard(threading.current_thread().name):
            self._intake_pump()

    def _intake_pump(self) -> None:
        while not self.stop.is_set():
            with self._cond:
                backlog = len(self._ready)
            if backlog >= self.serving.sched_ready_depth:
                self.stop.wait(self.poll_interval_s)
                continue
            job = self.worker._claim()
            if job is None:
                self.stop.wait(self.poll_interval_s)
                continue
            if self.worker._check_deadline(job):
                continue  # expired on arrival: terminal push already sent
            enq_t = self.clock()
            deadline = self.worker._deadline_of(job)
            tenant = str(job.body.get("tenant") or "anon")
            if job.body.get("collect_attention"):
                # Per-request forward flag: step_one runs the whole
                # pipeline solo at dispatch, so no shared intake here.
                item = ReadyItem(job, None, None, None, deadline, enq_t,
                                 solo=True, tenant=tenant)
            else:
                try:
                    with obs.trace_scope(job.body.get("trace_id")), \
                            obs.span("worker.intake", job_id=job.id,
                                     task_id=job.body.get("task_id", "")):
                        qa_id, prepared, t0 = self.worker._intake(job)
                except Exception:
                    self.worker._fail_job(job)
                    continue
                item = ReadyItem(job, qa_id, prepared, t0, deadline, enq_t,
                                 tenant=tenant)
            with self._cond:
                self._ready.append(item)
                self._cond.notify()

    # ------------------------------------------------------ dispatch stage
    def _next_batch(self) -> Tuple[List[ReadyItem], List[ReadyItem]]:
        """Block until the window policy fires; returns (batch, expired).

        Both lists are selected under ``_cond`` but everything done WITH
        them (expiry pushes, device dispatch) happens after release.
        Returns two empty lists once ``stop`` is set.
        """
        max_rows = self.worker.engine.cfg.engine.max_batch_rows()
        with self._cond:
            while not self.stop.is_set():
                if not self._ready:
                    self._cond.wait(self.poll_interval_s)
                    continue
                now = self.clock()
                fire, wait_s = fire_decision(
                    now,
                    rows=sum(i.rows() for i in self._ready),
                    oldest_enq_t=min(i.enq_t for i in self._ready),
                    nearest_expiry=min(i.expiry() for i in self._ready),
                    max_rows=max_rows,
                    window_s=self._window_s,
                    near_deadline_s=self.serving.sched_near_deadline_ms / 1e3,
                )
                if not fire:
                    self._cond.wait(min(wait_s, self.poll_interval_s))
                    continue
                batch, expired, rest = select_batch(
                    self._ready, now, max_rows,
                    deficits=self._deficits if self._fairness else None,
                    weights=self._weights,
                    default_weight=self._default_weight)
                # Slice-assign keeps the one list object (and is the
                # truncation idiom VMT115 audits in this plane).
                self._ready[:] = rest
                if self._fairness:
                    # In-memory gauge set — non-blocking, fine under
                    # _cond (VMT116 audits blocking calls only).
                    for t, credit in self._deficits.items():
                        obs.TENANT_DEFICIT.set(credit, tenant=t)
                if batch:
                    fill = min(
                        sum(i.rows() for i in batch) / max_rows, 1.0)
                    self._window_s = adapt_window(
                        self._window_s, fill,
                        lo=self.serving.sched_window_min_s,
                        hi=self.serving.sched_window_max_s)
                return batch, expired
        return [], []

    def _checkout_for_dispatch(self):
        """Pool checkout that stays responsive to the drain signal: wait in
        poll-interval slices up to the configured checkout timeout."""
        deadline = self.clock() + self.serving.pool_checkout_timeout_s
        while not self.stop.is_set():
            remaining = deadline - self.clock()
            if remaining <= 0:
                break
            try:
                return self.pool.checkout(
                    timeout_s=min(self.poll_interval_s, remaining))
            except NoReadyReplica:
                continue
        raise NoReadyReplica("no ready replica before drain/timeout")

    def _dispatch(self, batch: List[ReadyItem]) -> None:
        """One fire: solos serve individually, the rest pack through
        ``run_many`` with results streaming to the completion stage.

        Pool mode pins the packed batch to ONE checked-out replica and
        runs it on the executor, so the dispatch loop can fire the next
        batch onto another replica while this one computes."""
        now = self.clock()
        for item in batch:
            obs.SCHED_WAIT.observe(max(now - item.enq_t, 0.0) * 1e3)
            obs.job_charge(item.job.body.get("trace_id", ""),
                           "ready_wait", max(now - item.enq_t, 0.0))
        with self._cond:
            # Per-tenant queue-wait EWMA for the sampler: the fairness
            # tier's observable effect is exactly this number staying
            # flat for light tenants while a hot tenant backlogs.
            for item in batch:
                wait_ms = max(now - item.enq_t, 0.0) * 1e3
                prev = self._tenant_wait_ms.get(item.tenant)
                self._tenant_wait_ms[item.tenant] = (
                    wait_ms if prev is None
                    else 0.8 * prev + 0.2 * wait_ms)
        packed = [i for i in batch if not i.solo]
        solos = [i for i in batch if i.solo]
        for item in solos:
            with self._cond:
                self._stats["solo"] += 1
                self._stats["jobs"] += 1
            self.worker.step_one(item.job)
        if not packed:
            return
        if self.pool is None:
            self._dispatch_packed(packed, None)
            return
        try:
            rep = self._checkout_for_dispatch()
        except NoReadyReplica:
            # Nothing can take the batch right now (swap-drain, breaker
            # storm, or shutdown): release every member for redelivery —
            # no attempt charged, and the delivery-count quarantine still
            # bounds jobs that land here forever.
            for item in packed:
                self.worker._failover_job(item.job, "none")
            return
        self._executor.submit(self._dispatch_packed, packed, rep)

    def _dispatch_packed(self, packed: List[ReadyItem], rep) -> None:
        """Forward one packed batch on one engine (a checked-out replica,
        or the worker's own engine in legacy mode) and stream results."""
        t_pack = time.perf_counter()
        engine = rep.engine if rep is not None else self.worker.engine
        reqs = [i.prepared for i in packed]
        plan = engine.chunk_plan([r.n_images for r in reqs])
        top_bucket = 0
        for idxs in plan:
            rows = sum(reqs[i].n_images for i in idxs)
            bucket = engine.cfg.engine.row_bucket_for(rows)
            top_bucket = max(top_bucket, bucket)
            obs.BATCH_FILL.observe(rows / bucket, bucket=str(bucket))
            obs.BATCHES_DISPATCHED.inc()
        with self._cond:
            self._stats["batches"] += len(plan)
            self._stats["jobs"] += len(packed)
        streamed = set()

        def _on_result(pos: int, result) -> None:
            streamed.add(pos)
            # Blocking put IS the completion backpressure: a stalled
            # persist/push stage eventually stalls dispatch instead of
            # piling unpersisted results without bound.
            self._completions.put((packed[pos], result))

        rep_name = rep.name if rep is not None else ""
        t_fwd = time.perf_counter()
        for item in packed:
            obs.job_charge(item.job.body.get("trace_id", ""), "pack",
                           t_fwd - t_pack)
        rows_total = sum(r.n_images for r in reqs)

        def _charge_forward(wall_s, members) -> None:
            # Amortized device share per member (attrib double-entry: the
            # FULL wall lands on the busy ledger, only listed members are
            # billed — a mid-batch failure's unstreamed rows show as waste).
            obs.job_batch(
                wall_s,
                [(i.job.body.get("trace_id", ""), i.prepared.n_images)
                 for i in members],
                batch_rows=rows_total, bucket=top_bucket, replica=rep_name)

        try:
            with obs.span("worker.batch_forward", n_jobs=len(packed),
                          job_ids=[i.job.id for i in packed],
                          replica=rep_name):
                engine.run_many(reqs, on_result=_on_result)
            # Attribute the shared forward window into each member's own
            # trace (same contract as step_batch) so per-request
            # waterfalls stay contiguous under batching.
            dur_fwd = time.perf_counter() - t_fwd
            for item in packed:
                obs.default_tracer().record_span(
                    "worker.infer", t_fwd, dur_fwd,
                    trace_id=item.job.body.get("trace_id"),
                    job_id=item.job.id, task_id=item.prepared.spec.task_id,
                    batched=True, n_jobs=len(packed))
            _charge_forward(dur_fwd, packed)
            if rep is not None:
                self.pool.checkin(
                    rep, ok=True,
                    elapsed_ms=(time.perf_counter() - t_fwd) * 1e3)
        except Exception as e:  # noqa: BLE001 — split below
            _charge_forward(time.perf_counter() - t_fwd,
                            [i for pos, i in enumerate(packed)
                             if pos in streamed])
            if rep is not None:
                self.pool.checkin(rep, ok=False, error=e)
                rep.failovers += 1
            # Exactly-one-terminal: members that already streamed get
            # their terminal state from the completion stage; only the
            # rest terminate here. With a pool the REPLICA is the suspect
            # (release + redeliver; delivery_count bounds poison jobs) —
            # legacy mode keeps the nack/dead-letter path.
            for pos, item in enumerate(packed):
                if pos not in streamed:
                    if rep is not None:
                        self.worker._failover_job(item.job, rep.name)
                    else:
                        self.worker._fail_job(item.job)

    # ---------------------------------------------------- completion stage
    def _completion_loop(self) -> None:
        """Persist + push off the dispatch thread, so the next batch's
        forward overlaps this batch's DB writes and websocket frames.

        Guarded like the intake loop: ``_fail_job`` in the except arm
        reaches the queue's nack (remote transport in split deploys), so
        even the recovery path can raise — the guard makes that death
        loud instead of stranding every future completion."""
        with obs.crash_guard(threading.current_thread().name):
            self._completion_pump()

    def _completion_pump(self) -> None:
        while True:
            msg = self._completions.get()
            if msg is None:
                return
            item, result = msg
            try:
                with obs.trace_scope(item.job.body.get("trace_id")):
                    self.worker._finish_job(item.job, item.qa_id,
                                            item.prepared, result, item.t0)
                self.worker.queue.ack(item.job.id)
                self.worker._untrack(item.job.id)
            except Exception:
                self.worker._fail_job(item.job)

    # -------------------------------------------------------------- driver
    def run(self) -> None:
        intakes = [
            threading.Thread(target=self._intake_loop,
                             name=f"sched-intake-{i}", daemon=True)
            for i in range(max(1, self.serving.sched_intake_threads))
        ]
        completion = threading.Thread(target=self._completion_loop,
                                      name="sched-completion", daemon=True)
        for t in intakes:
            t.start()
        completion.start()
        try:
            while not self.stop.is_set():
                batch, expired = self._next_batch()
                for item in expired:
                    with self._cond:
                        self._stats["shed"] += 1
                    # An expiry while tenant-budget-deferred is the
                    # fairness tier's shed, not plain overload — keep
                    # the classes separate in vmt_shed_total{reason}.
                    self.worker._expire_job(
                        item.job,
                        reason=("tenant_budget" if item.deferred
                                else "deadline"))
                if batch:
                    self._dispatch(batch)
        finally:
            self.stop.set()
            # Drain order matters: intake stops claiming first, THEN the
            # remaining ready jobs release (a racing intake thread could
            # otherwise re-park a job after its release), then the
            # completion queue finishes every already-forwarded result.
            for t in intakes:
                t.join()
            if self._executor is not None:
                # In-flight replica batches finish (their results are
                # already streaming into the completion queue) before the
                # sentinel below — a shutdown must never orphan a batch
                # between forward and persist.
                self._executor.shutdown(wait=True)
            with self._cond:
                leftovers = list(self._ready)
                self._ready.clear()
                self._stats["released"] += len(leftovers)
            abandoned_by = (getattr(self.worker.engine, "replica_id", None)
                            or "scheduler")
            for item in leftovers:
                self.worker.queue.release(item.job.id)
                obs.record_event("job_abandoned", job_id=item.job.id,
                                 trace_id=item.job.body.get("trace_id"),
                                 replica=abandoned_by)
                frame = {
                    "terminal": "Server draining; job requeued for the "
                                "next worker.",
                    "requeued": True,
                    "abandoned_by": abandoned_by,
                    "question": item.job.body.get("question", ""),
                }
                log_to_terminal(
                    self.worker.hub, item.job.body.get("socket_id", ""),
                    frame)
                # Requeue, not a terminal: coalesced followers stay
                # attached and hear the notice; the next worker's
                # terminal fan-out settles them.
                self.worker._fan_to_followers(item.job.body, [frame],
                                              final=False)
                self.worker._untrack(item.job.id)
            self._completions.put(None)
            completion.join()

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Scheduler state for the time-series sampler. ``*_total`` keys
        get ``_per_s`` rates derived by the sampler."""
        with self._cond:
            vals = {
                "sched_ready": float(len(self._ready)),
                "sched_window_ms": self._window_s * 1e3,
                "sched_batches_total": float(self._stats["batches"]),
                "sched_jobs_total": float(self._stats["jobs"]),
                "sched_solo_total": float(self._stats["solo"]),
                "sched_shed_total": float(self._stats["shed"]),
                "sched_released_total": float(self._stats["released"]),
                "sched_completion_backlog":
                    float(self._completions.qsize()),
            }
            # Per-tenant queue-wait (EWMA over dispatched items) and live
            # deficit credit — cardinality bounded by tenants actually
            # seen / holding backlog.
            for t, v in self._tenant_wait_ms.items():
                vals[f"sched_tenant_wait_ms.{t}"] = float(v)
            for t, v in self._deficits.items():
                vals[f"sched_tenant_deficit.{t}"] = float(v)
            return vals
