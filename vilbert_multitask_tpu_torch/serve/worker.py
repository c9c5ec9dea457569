"""The queue worker: claim → infer → persist → push → ack.

Reference capability: ``callback`` (reference worker.py:542-658) — the
per-message pipeline that creates the DB row, extracts features, runs the
model, marshals the per-task answer, saves, and streams progress/results to
the client's websocket group — with the §2.4 parity traps fixed:

- ack/nack is explicit and poison jobs dead-letter after N attempts
  (reference leaves them redelivering forever, worker.py:650-655);
- a failed DB insert aborts the job instead of being swallowed and crashing
  later (worker.py:548-555 vs 579);
- label maps and features are engine-cached, not re-read per request.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.config import ServingConfig, TASK_REGISTRY
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
from vilbert_multitask_tpu_torch.resilience import Deadline, DeadlineExceeded
from vilbert_multitask_tpu_torch.resilience.faults import fault_point
from vilbert_multitask_tpu_torch.serve.db import ResultStore
from vilbert_multitask_tpu_torch.serve.metrics import Metrics
from vilbert_multitask_tpu_torch.serve.pool import ReplicaFailover
from vilbert_multitask_tpu_torch.serve.push import PushHub, fan_out, log_to_terminal
from vilbert_multitask_tpu_torch.serve.queue import DurableQueue, Job
from vilbert_multitask_tpu_torch.serve.render import draw_grounding_boxes
from vilbert_multitask_tpu_torch.serve.resultcache import ResultCache


def _attention_summary(out) -> Dict[str, Any]:
    """Compact, JSON-safe view of the co-attention maps for one request.

    The reference computes per-layer maps on every forward
    (worker.py:288) but the demo never renders them; here the serving
    contract surfaces the useful slice — per-bridge, head-averaged [CLS]-row
    text→image attention over the regions (the grounding-relevant signal) —
    small enough to ride in the websocket result frame.
    """
    import numpy as np

    bridges = []
    for probs_t2v, _probs_v2t in out.attn_data_list:
        if probs_t2v is None:
            continue
        p = np.asarray(probs_t2v, np.float32)[0]  # (H, Nq, Nk), request row 0
        cls_over_regions = p.mean(axis=0)[0]  # head-avg, [CLS] query row
        bridges.append([round(float(x), 5) for x in cls_over_regions])
    return {"bridge_cls_to_regions": bridges,
            "n_bridges": len(bridges)}


def save_full_attention(out, qa_id: int, media_root: str) -> Dict[str, Any]:
    """Persist the COMPLETE per-bridge co-attention maps for one request.

    Both directions of every bridge, all heads, request row 0 —
    ``bridge{i}_t2v`` (H, Nt, Nv) and ``bridge{i}_v2t`` (H, Nv, Nt) — as a
    compressed ``.npz`` under ``media/attention/``. The reference's
    ``output_all_attention_masks=True`` contract (worker.py:288) made these
    maps exist on every forward and then dropped them; here a job opting in
    with ``collect_attention="full"`` gets the whole payload back through
    the API: the npz is downloadable at ``/media/attention/qa_<id>.npz`` and
    ``GET /attention/<qa_id>`` serves a JSON view for the browser.
    """
    import numpy as np

    arrays: Dict[str, Any] = {}
    for i, (probs_t2v, probs_v2t) in enumerate(out.attn_data_list):
        if probs_t2v is not None:
            arrays[f"bridge{i}_t2v"] = np.asarray(probs_t2v, np.float32)[0]
        if probs_v2t is not None:
            arrays[f"bridge{i}_v2t"] = np.asarray(probs_v2t, np.float32)[0]
    out_dir = os.path.join(media_root, "attention")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"qa_{qa_id}.npz")
    # Write-then-rename: a worker killed mid-write must never leave a
    # truncated npz at the final path (every later GET would 500). The tmp
    # name keeps the .npz suffix — np.savez appends one otherwise and the
    # rename source would not exist.
    tmp = os.path.join(out_dir, f".qa_{qa_id}.tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return {"qa_id": qa_id,
            "full_map_npz": f"/media/attention/qa_{qa_id}.npz",
            "full_map_url": f"/attention/{qa_id}"}


class ServeWorker:
    """Single-process inference worker (one engine, one queue consumer)."""

    def __init__(
        self,
        engine: InferenceEngine,
        queue: DurableQueue,
        store: ResultStore,
        hub: PushHub,
        serving: Optional[ServingConfig] = None,
        metrics: Optional[Metrics] = None,
        cache: Optional[ResultCache] = None,
    ):
        self.engine = engine
        self.queue = queue
        self.store = store
        self.hub = hub
        self.serving = serving or ServingConfig()
        self.metrics = metrics or Metrics()
        # Durable result cache + singleflight follower registry
        # (serve/resultcache.py). When a finished job carries a
        # ``cache_key``, its result is written through here and every
        # terminal frame fans out to the key's coalesced followers.
        self.cache = cache
        # Claimed-but-unfinished jobs, for graceful drain: stop() releases
        # these back to the queue (no attempt charged) and tells the client.
        self._inflight_lock = threading.Lock()
        self._inflight: Dict[int, Job] = {}
        # Set by run_forever when serving.sched_enabled — the continuous
        # batching data plane (serve/scheduler.py) this worker drains
        # through; None while running the legacy step_batch loop.
        self.scheduler = None

    # ------------------------------------------------------------- job cycle
    def _intake(self, job: Job):
        """Validate + prepare one job: returns (qa_id, prepared, t0).

        t0 is captured before feature I/O so solo and batched paths record
        the same latency definition in :class:`Metrics`.
        """
        fault_point("worker.intake")
        body = job.body
        t0 = time.perf_counter()
        task_id = int(body["task_id"])  # reference eval()s this str; we don't
        question = body.get("question", "")
        socket_id = body.get("socket_id", "")
        image_paths = body["image_path"]
        if isinstance(image_paths, str):
            image_paths = [image_paths]
        spec = TASK_REGISTRY[task_id]
        spec.validate_num_images(len(image_paths))
        log_to_terminal(self.hub, socket_id,
                        {"terminal": f"Running {spec.name} inference..."})
        # Audit row first (reference worker.py:548-552), keyed by the queue
        # job id so redelivered attempts reuse one row.
        qa_id = self.store.create_question(task_id, question, image_paths,
                                           socket_id, queue_job_id=job.id)
        # One store read yields regions + content-stable device-cache
        # identities (file + mtime + size, captured at read time): repeat
        # queries about unchanged images skip the feature upload; an
        # edited/replaced file is a cache miss.
        prepared = self.engine.prepare_from_store(task_id, question,
                                                  image_paths)
        obs.job_charge(body.get("trace_id", ""), "intake",
                       time.perf_counter() - t0)
        return qa_id, prepared, t0

    def process_job(self, job: Job) -> Dict[str, Any]:
        """One message end-to-end; raises on failure (caller nacks)."""
        # Re-enter the trace minted at HTTP submit (queue.make_job_message
        # carried the id across the thread boundary); jobs published by
        # pre-tracing clients get a fresh id (trace_scope(None)).
        with obs.trace_scope(job.body.get("trace_id")), \
                obs.span("worker.job", job_id=job.id,
                         task_id=job.body.get("task_id", "")):
            with obs.span("worker.intake"):
                qa_id, prepared, t0 = self._intake(job)
            # collect_attention: falsy → none; truthy → summary in the result
            # frame; the string "full" additionally persists every per-bridge
            # per-head map (save_full_attention).
            collect = job.body.get("collect_attention", False)
            with obs.span("worker.infer",
                          task_id=job.body.get("task_id", "")):
                out, result = self.engine.run(
                    prepared, collect_attention=bool(collect),
                    deadline=self._deadline_of(job))
            attention = None
            if collect:
                attention = _attention_summary(out)
                if collect == "full":
                    attention.update(save_full_attention(
                        out, qa_id, self.serving.media_root))
            return self._finish_job(job, qa_id, prepared, result, t0,
                                    attention=attention)

    def _claim(self, exclude=()) -> Optional[Job]:
        """Claim with telemetry: the claim interval only becomes a span if a
        job came back (idle polls must not churn the span ring), and it
        joins the claimed job's trace after the fact (record_span)."""
        t0 = time.perf_counter()
        self._notify_dead_letters()
        ident = obs.process_identity().ident
        job = self.queue.claim(exclude=exclude, claimed_by=ident)
        if job is not None:
            obs.default_tracer().record_span(
                "worker.claim", t0, time.perf_counter() - t0,
                trace_id=job.body.get("trace_id"), job_id=job.id,
                attempts=job.attempts, claimed_by=ident)
            # Cost attribution opens at claim: every stage charge between
            # here and the terminal verdict lands on this record.
            trace_id = job.body.get("trace_id", "")
            obs.job_begin(trace_id, job_id=job.id,
                          task=str(job.body.get("task_id", "")),
                          tenant=str(job.body.get("tenant") or "anon"))
            published = job.body.get("published_unix")
            if published is not None:
                # Publish→claim latency. Wall-clock delta against the
                # submitter's epoch stamp — cross-process, so monotonic
                # clocks cannot be compared (same rationale as
                # Deadline.issued_unix); clamped because unsynced clocks
                # can run the difference slightly negative.
                wait_s = time.time() - float(published)  # vmtlint: disable=VMT109
                obs.QUEUE_WAIT.observe(
                    max(wait_s, 0.0) * 1e3,
                    task=str(job.body.get("task_id", "")),
                    tenant=str(job.body.get("tenant") or "anon"))
                obs.job_charge(trace_id, "queue_wait", max(wait_s, 0.0))
            with self._inflight_lock:
                self._inflight[job.id] = job
        return job

    def _notify_dead_letters(self) -> None:
        """Push terminal frames for jobs the queue quarantined as poison.

        The deliveries sweep inside ``claim()`` dead-letters jobs that
        exceeded ``queue_max_deliveries`` without any worker holding them —
        nobody is positioned to tell the client.  ``pop_dead_letters()``
        hands each such job to exactly one caller (the ``dead_notified``
        column makes the pop idempotent), so the frame is pushed once no
        matter how many workers poll."""
        pop = getattr(self.queue, "pop_dead_letters", None)
        if pop is None:
            return
        for job in pop():
            obs.record_event("poison_quarantined", job_id=job.id,
                             trace_id=job.body.get("trace_id"),
                             task_id=job.body.get("task_id", ""),
                             deliveries=job.deliveries)
            # Close any cost record a dead prior holder left open, so the
            # quarantine verdict (not an eviction) is what the store keeps.
            obs.job_finish(job.body.get("trace_id", ""), "dead_letter")
            frame = {
                "terminal": "Job quarantined: it was delivered "
                            f"{job.deliveries} times without completing "
                            "and will not be retried.",
                "error": "poison job dead-lettered after "
                         f"{job.deliveries} deliveries",
                "dead_letter": True,
                "process": obs.process_identity().ident,
                "question": job.body.get("question", ""),
            }
            log_to_terminal(self.hub, job.body.get("socket_id", ""), frame)
            # Quarantine is a terminal: followers coalesced onto this
            # job must hear it too, and the singleflight claim drops so
            # a retry submit republishes instead of attaching.
            self._fan_to_followers(job.body, [frame],
                                   verdict="dead_letter", drop_claim=True)

    def _failover_job(self, job: Job, replica: str) -> str:
        """Move a job off a failed replica: release (no attempt charged),
        stamp the culprit replica in the requeued frame, and count it.

        release(), not nack(): the REPLICA failed, not the job — at-least-
        once redelivery reruns it on a healthy replica.  A job that kills
        every replica it lands on is bounded by the queue's
        ``delivery_count`` quarantine (release never decrements it)."""
        obs.FAILOVER_COUNTER.inc(replica=replica)
        obs.default_tracer().record_span(
            "worker.failover", time.perf_counter(), 0.0,
            trace_id=job.body.get("trace_id"), job_id=job.id,
            replica=replica)
        self.queue.release(job.id)
        self._untrack(job.id)
        obs.job_finish(job.body.get("trace_id", ""), "failover")
        frame = {
            "terminal": f"Replica {replica} failed mid-inference; job "
                        "requeued on a healthy replica.",
            "requeued": True,
            "replica": replica,
            "process": obs.process_identity().ident,
            "question": job.body.get("question", ""),
        }
        log_to_terminal(self.hub, job.body.get("socket_id", ""), frame)
        # Not a terminal: the job reruns on a healthy replica, so
        # followers stay attached (peek) and just hear the requeue.
        self._fan_to_followers(job.body, [frame], final=False)
        return "requeued"

    # --------------------------------------------------- coalesced fan-out
    def _fan_to_followers(self, body: Dict[str, Any],
                          frames: List[Dict[str, Any]], *,
                          verdict: Optional[str] = None,
                          final: bool = True,
                          drop_claim: bool = False) -> None:
        """Fan the leader's frames out to every coalesced follower.

        ``final=True`` destructively pops the follower registry inside
        one write transaction, so each follower receives its terminal
        frames exactly once — exactly-one-terminal per *submit*, not
        just per job, no matter how many workers race the leader's
        terminal. ``final=False`` peeks (requeued/failover notices):
        followers stay attached for the eventual terminal.
        ``drop_claim`` additionally abandons the singleflight claim so
        the next identical submit retries instead of attaching to a key
        whose leader already failed. ``verdict`` closes each follower's
        cost record — a follower is charged ONLY the push (its forward
        was the leader's; device-second conservation is untouched
        because device time accrues via job_batch alone).
        """
        if self.cache is None:
            return
        key = body.get("cache_key")
        if not key:
            return
        followers = (self.cache.pop_followers(key) if final
                     else self.cache.peek_followers(key))
        if followers:
            t_push = time.perf_counter()
            sids = [f.socket_id for f in followers]
            for frame in frames:
                fan_out(self.hub, sids, dict(frame, coalesced=True))
            if verdict is not None:
                # The fan wall splits evenly: push is the ONLY stage a
                # follower is charged for.
                share = (time.perf_counter() - t_push) / len(followers)
                for f in followers:
                    obs.job_charge(f.trace_id or "", "push", share)
                    obs.job_finish(f.trace_id or "", verdict)
        if drop_claim:
            self.cache.abandon(key)

    def _untrack(self, job_id: int) -> None:
        with self._inflight_lock:
            self._inflight.pop(job_id, None)

    def inflight_count(self) -> int:
        """Jobs claimed but not yet finished (obs sampler probe)."""
        with self._inflight_lock:
            return len(self._inflight)

    # ------------------------------------------------------------- deadlines
    @staticmethod
    def _deadline_of(job: Job) -> Optional[Deadline]:
        return Deadline.from_wire(job.body.get("deadline"))

    def _check_deadline(self, job: Job) -> bool:
        """True if the job's deadline already expired (job terminated)."""
        dl = self._deadline_of(job)
        if dl is None:
            return False
        obs.DEADLINE_SLACK.observe(
            max(dl.remaining_s(), 0.0) * 1e3,
            task=str(job.body.get("task_id", "")))
        if not dl.expired():
            return False
        self._expire_job(job)
        return True

    def _expire_job(self, job: Job, *, reason: str = "deadline") -> None:
        """Terminate an expired job: terminal push + ack (the client gave
        up waiting; a forward would be pure waste). Ack, not nack — the
        outcome is final, not retryable. ``reason`` classifies the shed
        (``deadline`` for plain EDF expiry, ``tenant_budget`` when the
        deficit scheduler's fairness tier deferred the job past its
        deadline) so vmt_shed_total separates overload from QoS policy."""
        obs.SHED_COUNTER.inc(reason=reason)
        # One expiry is traffic; a burst is an incident. The spike tracker
        # dumps a postmortem bundle only when expiries cluster.
        obs.record_spike("deadline_spike",
                         trace_id=job.body.get("trace_id"),
                         task_id=job.body.get("task_id", ""))
        frame = {
            "terminal": "Deadline exceeded before the job could be "
                        "served; not retried.",
            "deadline_exceeded": True,
            "question": job.body.get("question", ""),
        }
        log_to_terminal(self.hub, job.body.get("socket_id", ""), frame)
        # Expiry is a terminal: every coalesced follower hears it
        # (exactly one terminal per submit) and the singleflight claim
        # drops so a fresh submit retries with a fresh deadline.
        self._fan_to_followers(job.body, [frame],
                               verdict="deadline", drop_claim=True)
        self.queue.ack(job.id)
        self._untrack(job.id)
        obs.job_finish(job.body.get("trace_id", ""), "deadline")

    def step(self) -> Optional[str]:
        """Claim and run one job. Returns 'acked'/'failed'/None."""
        job = self._claim()
        if job is None:
            return None
        return self.step_one(job)

    def metrics_failure_for(self, job: Job) -> None:
        try:
            self.metrics.record_failure(int(job.body.get("task_id", -1)))
        except (TypeError, ValueError):
            self.metrics.record_failure()

    # ------------------------------------------------------- micro-batching
    def step_batch(self, max_jobs: Optional[int] = None, *,
                   stop_event=None) -> int:
        """Drain up to ``max_jobs`` queued jobs and serve the packable ones
        through batched forwards (engine.run_many — mixed image counts
        share chunks, so NLVR2 pairs, retrieval candidate sets, and
        singles all pack into the same dispatches; see engine.chunk_plan);
        attention-map requests claimed along the way run individually
        (per-request forward flag). Returns jobs completed.

        This is the batched replacement for the reference's strictly
        serial batch=1 loop (worker.py:70,489,672-673): under queue backlog
        the trunk runs once per bucket instead of once per request.
        """
        if max_jobs is None:
            # Drain to the engine's largest compiled row bucket: under deep
            # backlog the worker fills a whole throughput chunk (32 by
            # default) instead of capping at 8 and leaving the MXU starved.
            max_jobs = self.engine.cfg.engine.max_batch_rows()
        packable: List[tuple] = []  # (job, qa_id, prepared, t0)
        done = 0
        failed_ids: set = set()
        while len(packable) < max_jobs:
            if stop_event is not None and stop_event.is_set():
                # Graceful drain: stop CLAIMING; jobs already in hand below
                # still finish (stop() waits drain_grace_s for them).
                break
            job = self._claim(exclude=failed_ids)
            if job is None:
                break
            if self._check_deadline(job):
                done += 1  # terminated with a terminal push — a final state
                continue
            if job.body.get("collect_attention"):
                # attention maps are a per-request forward flag: serve solo
                if self.step_one(job) == "acked":
                    done += 1
                else:
                    failed_ids.add(job.id)  # don't spin its attempts away
                continue
            try:
                # Per-job trace scope: intake spans join the trace each job
                # carried from its own HTTP submit.
                with obs.trace_scope(job.body.get("trace_id")), \
                        obs.span("worker.intake", job_id=job.id,
                                 task_id=job.body.get("task_id", "")):
                    qa_id, prepared, t0 = self._intake(job)
                packable.append((job, qa_id, prepared, t0))
            except Exception:
                self._fail_job(job)
                failed_ids.add(job.id)
        if not packable:
            return done
        # Deadlines can lapse during intake (feature I/O) — re-check so the
        # batched forward never carries an already-dead request.
        still_live = []
        for entry in packable:
            if self._check_deadline(entry[0]):
                done += 1
            else:
                still_live.append(entry)
        packable = still_live
        if not packable:
            return done
        try:
            # One span for the shared batched forward: it serves many
            # traces at once, so it stands alone (its own trace id) with
            # the member jobs recorded as an attribute.
            t_fwd = time.perf_counter()
            with obs.span("worker.batch_forward", n_jobs=len(packable),
                          job_ids=[j.id for j, _, _, _ in packable]):
                results = self.engine.run_many(
                    [p for _, _, p, _ in packable])
            # ...and the same window attributed into each member's trace,
            # so a request's waterfall stays contiguous under batching.
            dur_fwd = time.perf_counter() - t_fwd
            for job, _, p, _ in packable:
                obs.default_tracer().record_span(
                    "worker.infer", t_fwd, dur_fwd,
                    trace_id=job.body.get("trace_id"), job_id=job.id,
                    task_id=p.spec.task_id, batched=True,
                    n_jobs=len(packable))
            # Amortize the shared forward into each member's cost record
            # (no streaming here: success means every member gets a share).
            rows_total = sum(p.n_images for _, _, p, _ in packable)
            obs.job_batch(
                dur_fwd,
                [(j.body.get("trace_id", ""), p.n_images)
                 for j, _, p, _ in packable],
                batch_rows=rows_total,
                bucket=self.engine.cfg.engine.row_bucket_for(rows_total),
                replica=getattr(self.engine, "replica_id", "") or "")
        except ReplicaFailover as e:
            # The REPLICA died under this batch, not the jobs: release the
            # whole batch for redelivery on a healthy replica. No member
            # streamed (this path has no on_result), so none is terminal yet.
            for job, _, _, _ in packable:
                self._failover_job(job, e.replica)
            return done
        except Exception:
            for job, _, _, _ in packable:
                self._fail_job(job)
            return done
        for (job, qa_id, prepared, t0), result in zip(packable, results):
            try:
                with obs.trace_scope(job.body.get("trace_id")):
                    self._finish_job(job, qa_id, prepared, result, t0)
                self.queue.ack(job.id)
                self._untrack(job.id)
                done += 1
            except Exception:
                self._fail_job(job)
        return done

    def _finish_job(self, job: Job, qa_id: int, req, result,
                    t0, attention: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """Marshal + persist + push for one completed request."""
        body = job.body
        socket_id = body.get("socket_id", "")
        trace_id = body.get("trace_id", "")
        t_dec = time.perf_counter()
        payload = result.to_json()
        payload["question"] = body.get("question", "")
        payload["task_name"] = req.spec.name
        if attention is not None:
            payload["attention"] = attention
        answer_images: List[str] = []
        if result.kind == "grounding" and result.boxes:
            src = req.images[0].path
            if os.path.exists(src):
                out_dir = os.path.join(self.serving.media_root,
                                       self.serving.refer_expr_dir)
                # Best-effort: jobs may reference a feature file (.npy/.vlfr)
                # rather than a decodable image — the box ANSWER is still
                # valid, only the rendered overlay is skipped.
                try:
                    answer_images = draw_grounding_boxes(
                        src, result.boxes, out_dir)
                except Exception as e:  # noqa: BLE001 — PIL raises a zoo
                    import logging

                    logging.getLogger(__name__).warning(
                        "grounding render skipped for %s: %s", src, e)
                    answer_images = []
            if answer_images:
                payload["result_images"] = answer_images
                # Web paths for the browser client (the reference hardcodes
                # a production hostname instead, result.html:116-123 — a
                # §2.4 trap knowingly fixed).
                payload["result_image_urls"] = [
                    "/media/" + "/".join(
                        (self.serving.refer_expr_dir, os.path.basename(p)))
                    for p in answer_images
                ]
        with obs.span("worker.persist", qa_id=qa_id,
                      task_id=req.spec.task_id):
            self.store.save_answer(qa_id, payload, answer_images)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.record(req.spec.task_id, elapsed_ms,
                            exemplar_trace_id=trace_id)
        obs.job_charge(trace_id, "decode", time.perf_counter() - t_dec)
        # Write-through BEFORE any push: once the first client can see
        # the answer, an identical submit must already be a cache hit.
        key = body.get("cache_key")
        if self.cache is not None and key:
            self.cache.complete(key, payload)
        t_push = time.perf_counter()
        with obs.span("worker.push", task_id=req.spec.task_id):
            log_to_terminal(self.hub, socket_id, {"result": payload})
            log_to_terminal(
                self.hub, socket_id,
                {"terminal": f"Task completed in {elapsed_ms:.0f} ms"})
            # Singleflight payoff: every coalesced follower gets the one
            # shared result — each charged only its own push.
            self._fan_to_followers(
                body,
                [{"result": payload},
                 {"terminal": f"Task completed in {elapsed_ms:.0f} ms "
                              "(coalesced)"}],
                verdict="ok")
        obs.job_charge(trace_id, "push", time.perf_counter() - t_push)
        obs.job_finish(trace_id, "ok")
        return payload

    def _fail_job(self, job: Job) -> str:
        """nack + telemetry; returns 'requeued' or 'dead'."""
        self.metrics_failure_for(job)
        # Freeze the evidence while the traceback is still current — by
        # the time a redelivery dead-letters, the interesting spans have
        # aged out of the ring.
        obs.record_event("worker_exception", job_id=job.id,
                         trace_id=job.body.get("trace_id"),
                         task_id=job.body.get("task_id", ""),
                         error=traceback.format_exc(limit=5))
        status = self.queue.nack(job.id)
        self._untrack(job.id)
        # A requeued attempt closes THIS record; the redelivery's claim
        # opens a fresh one under the same trace id.
        obs.job_finish(job.body.get("trace_id", ""),
                       "dead_letter" if status == "dead" else "requeued")
        if status == "dead":
            frame = {
                "terminal": "Job failed permanently.",
                "error": traceback.format_exc(limit=3),
                "question": job.body.get("question", ""),
            }
            log_to_terminal(self.hub, job.body.get("socket_id", ""), frame)
            # Dead-letter is a terminal: fan it to every coalesced
            # follower and drop the singleflight claim so the next
            # identical submit retries instead of attaching.
            self._fan_to_followers(job.body, [frame],
                                   verdict="dead_letter", drop_claim=True)
        return "requeued" if status == "pending" else status

    def step_one(self, job: Job) -> str:
        """Run one already-claimed job solo (ack/nack included).

        Returns 'acked', 'requeued', 'dead', or 'deadline'.
        """
        if self._check_deadline(job):
            return "deadline"
        try:
            self.process_job(job)
        except DeadlineExceeded:
            # The engine declined to dispatch — terminate, don't retry.
            self._expire_job(job)
            return "deadline"
        except ReplicaFailover as e:
            return self._failover_job(job, e.replica)
        except Exception:
            return self._fail_job(job)
        self.queue.ack(job.id)
        self._untrack(job.id)
        return "acked"

    def abandon_inflight(self, replica: Optional[str] = None) -> int:
        """Graceful-drain tail: release every still-claimed job back to
        pending (no delivery attempt charged — release(), not nack()) and
        tell each client its job was requeued, not lost. Returns the count.

        ``replica`` stamps WHO abandoned the job into the requeued frame
        (postmortem provenance: /debug/trace shows which replica/worker a
        bounced job last sat on). Defaults to the engine's replica id.

        At-least-once delivery makes this safe to call even for jobs that
        actually completed a moment ago: release() only touches rows still
        in 'inflight'.
        """
        if replica is None:
            replica = getattr(self.engine, "replica_id", None) or "worker"
        with self._inflight_lock:
            abandoned = list(self._inflight.values())
            self._inflight.clear()
        for job in abandoned:
            self.queue.release(job.id)
            obs.record_event("job_abandoned", job_id=job.id,
                             trace_id=job.body.get("trace_id"),
                             replica=replica)
            frame = {
                "terminal": "Server draining; job requeued for the next "
                            "worker.",
                "requeued": True,
                "abandoned_by": replica,
                "process": obs.process_identity().ident,
                "question": job.body.get("question", ""),
            }
            log_to_terminal(self.hub, job.body.get("socket_id", ""), frame)
            # Requeue, not a terminal: followers stay attached and the
            # claim survives — the next worker's terminal fans to them.
            self._fan_to_followers(job.body, [frame], final=False)
        return len(abandoned)

    def scheduler_stats(self) -> Dict[str, float]:
        """Continuous-batching scheduler state for the sampler (empty when
        running the legacy loop)."""
        sched = self.scheduler
        return sched.stats() if sched is not None else {}

    def run_forever(self, *, poll_interval_s: float = 0.05,
                    stop_event=None, batch_jobs: Optional[int] = None) -> None:
        """The consume loop (reference worker.py:672-673).

        With ``serving.sched_enabled`` (the default) this drains through
        the continuous-batching scheduler — pipelined intake, adaptive
        EDF window dispatch, async completion (serve/scheduler.py).
        Otherwise the legacy synchronous step_batch loop; ``batch_jobs``
        applies only there (defaults to the engine's largest compiled row
        bucket). ``stop_event`` is the drain signal either way: claiming
        stops the moment it is set, in-hand work finishes, and the loop
        exits clean."""
        if self.serving.sched_enabled:
            from vilbert_multitask_tpu_torch.serve.scheduler import (
                ContinuousScheduler,
            )

            self.scheduler = ContinuousScheduler(
                self, stop_event=stop_event,
                poll_interval_s=poll_interval_s)
            try:
                self.scheduler.run()
            finally:
                self.scheduler = None
            return
        while stop_event is None or not stop_event.is_set():
            if self.step_batch(batch_jobs, stop_event=stop_event) == 0:
                time.sleep(poll_interval_s)
