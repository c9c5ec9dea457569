"""HTTP tier: job submission, task metadata, uploads, media.

Reference capability: the Django views + URL map (reference demo/urls.py:7-11,
demo/views.py):

- ``POST /``                      submit a job {socket_id, task_id, question,
                                  image_list[]} → enqueue (views.py:19-42)
- ``GET  /get_task_details/<id>/`` task metadata JSON (views.py:45-61)
- ``GET  /get_demo_images/``       random sample of demo images (views.py:64-81)
- ``POST /upload_image/``          multipart upload, uuid-renamed into media
                                   (views.py:84-106) → {"file_paths": [...]}
- ``GET  /media/...``              media serving (vilbert_multitask/urls.py:27-31)

Redesign: stdlib ``ThreadingHTTPServer`` + JSON bodies (the browser-facing
HTML shell is not part of the framework contract; the API is). Submission
returns the queued job id — the answer itself still arrives over the
websocket, preserving the reference's fire-and-forget shape (SURVEY.md §3.1).
"""

from __future__ import annotations

import email
import email.policy
import json
import mimetypes
import os
import random
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.config import ServingConfig, TASK_REGISTRY
from vilbert_multitask_tpu_torch.resilience import AdmissionController, Deadline
from vilbert_multitask_tpu_torch.serve.db import ResultStore
from vilbert_multitask_tpu_torch.serve.push import PushHub, log_to_terminal
from vilbert_multitask_tpu_torch.serve.queue import DurableQueue, make_job_message
from vilbert_multitask_tpu_torch.serve.resultcache import ResultCache, cache_key


class ApiServer:
    def __init__(
        self,
        queue: DurableQueue,
        store: ResultStore,
        hub: PushHub,
        serving: Optional[ServingConfig] = None,
        metrics=None,
        boot_info: Optional[Dict[str, Any]] = None,
        stats_fn=None,
        slos=None,
        timeseries=None,
        pool=None,
        swap_fn=None,
        fleet=None,
        attrib=None,
        tracestore=None,
        cache: Optional[ResultCache] = None,
        autoscaler=None,
    ):
        self.queue = queue
        self.store = store
        self.hub = hub
        self.serving = serving or ServingConfig()
        self.metrics = metrics
        # Live-health wiring (ServeApp): the SLO evaluator behind
        # /debug/slo and the 503-on-PAGE readiness rule, and the sampler's
        # time-series store behind /debug/timeseries.
        self.slos = slos
        self.timeseries = timeseries
        # Live reference filled in by ServeApp as boot stages finish
        # (engine init / warmup timings, kernel path) — surfaced in /healthz.
        self.boot_info = boot_info if boot_info is not None else {}
        # Optional live-stats callable merged into /metrics (ServeApp wires
        # the engine's device input-cache counters and int8 product counts
        # through this).
        self.stats_fn = stats_fn
        # Replica pool (ServeApp wires its ReplicaPool through): /healthz
        # reports per-replica states and readiness requires >=1 ready
        # replica; POST /admin/swap triggers swap_fn (a zero-downtime
        # rolling checkpoint swap).
        self.pool = pool
        self.swap_fn = swap_fn
        # Fleet spine (obs/fleet.py, ServeApp wires it): ?scope=fleet on
        # /metrics, /debug/timeseries, /healthz merges every live peer
        # sharing the spine db, and /debug/trace?trace_id= stitches one
        # timeline across processes.
        self.fleet = fleet
        # Cost-attribution plane (obs/attrib.py + obs/tracestore.py,
        # ServeApp wires both): /debug/costs windows the attributor's
        # completed ring, /debug/traces lists the durable tail-sampled
        # store, /debug/autopsy renders one trace's stage waterfall, and
        # /debug/trace?trace_id= falls back to the store when the span has
        # aged out of every live ring.
        self.attrib = attrib
        self.tracestore = tracestore
        # Durable result cache + singleflight registry (ServeApp wires
        # it; serve/resultcache.py). POST / consults it before any queue
        # publish: hits answer straight from sqlite (no queue, no device),
        # identical in-flight submits coalesce onto one leader job.
        self.cache = cache
        # Closed-loop autoscaler (serve/autoscale.py, ServeApp wires it):
        # /debug/autoscale serves the last-N decision records, /healthz
        # pairs its target replica count with the pool's actual.
        self.autoscaler = autoscaler
        # Actual websocket port for the browser client; ServeApp overwrites
        # this after the bridge binds (ws_port=0 picks a free port in tests).
        self.ws_port: int = self.serving.ws_port
        # Shed-before-enqueue (resilience/): overloaded submits get a fast
        # 429 + Retry-After instead of joining a backlog they'd time out in.
        self.admission = AdmissionController(
            max_queue_depth=self.serving.admission_max_queue_depth,
            max_queue_age_s=self.serving.admission_max_queue_age_s,
            retry_after_s=self.serving.admission_retry_after_s,
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- handlers
    def submit_job(self, payload: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        # Trace root: the id minted here rides in the queue job body and is
        # re-entered by the worker, correlating one request's spans across
        # the HTTP handler / worker thread boundary.
        trace_id = obs.new_trace_id()
        with obs.trace_scope(trace_id), obs.span("http.submit") as sp:
            code, body = self._submit_job(payload, trace_id, sp)
        if code == 200:
            body["trace_id"] = trace_id
        return code, body

    def _submit_job(self, payload: Dict[str, Any], trace_id: str,
                    sp) -> Tuple[int, Dict[str, Any]]:
        try:
            task_id = int(payload["task_id"])
            socket_id = str(payload.get("socket_id", ""))
            question = str(payload.get("question", ""))
            images = list(payload.get("image_list", []))
        except (KeyError, TypeError, ValueError):
            return 400, {"error": "need task_id, socket_id, question, image_list"}
        decision = self._admission_decision()
        if not decision.admitted:
            return 429, {
                "error": "overloaded; retry later",
                "reason": decision.reason,
                "retry_after_s": decision.retry_after_s,
            }
        try:
            budget = payload.get("deadline_s", self.serving.default_deadline_s)
            budget = None if budget is None else float(budget)
        except (TypeError, ValueError):
            return 400, {"error": "deadline_s must be a number"}
        spec = TASK_REGISTRY.get(task_id)
        if spec is None:
            return 400, {"error": f"unknown task_id {task_id}"}
        try:
            spec.validate_num_images(len(images))
        except ValueError as e:
            return 400, {"error": str(e)}
        if self.serving.lowercase_questions:
            question = question.lower()  # reference views.py:27
        log_to_terminal(self.hub, socket_id,
                        {"info": f"Starting {spec.name} job..."})
        collect = payload.get("collect_attention", False)
        # Optional caller-declared tenant for cost attribution
        # (vmt_device_seconds_total{task,tenant}); absent → "anon".
        tenant = str(payload.get("tenant", "") or "") or None
        # --- duplicate-traffic tier (serve/resultcache.py) ---
        # One atomic claim decides the submit's fate: a durable HIT is
        # answered right here (no queue, no device), an identical in-flight
        # submit ATTACHES as a follower of the one leader job (the
        # leader's terminal fans out to it), and everything else LEADS —
        # publishes the one real job with the key stamped on the body.
        # Attention-collecting jobs bypass the tier: their payload
        # (persisted per-request .npz maps) is per-submit state.
        key = None
        if self.cache is not None and not collect:
            key = cache_key(task_id, images, question,
                            self.cache.fingerprint)
            verdict_c, value = self.cache.admit(
                key, socket_id=socket_id, trace_id=trace_id,
                tenant=tenant, coalesce=self.serving.coalesce_enabled)
            if verdict_c == "hit":
                return self._serve_cache_hit(spec, socket_id, trace_id,
                                             tenant, value, sp)
            if verdict_c == "attach":
                obs.COALESCED_SUBMITS.inc()
                # The follower's cost record opens here; the leader's
                # terminal fan-out closes it with only a push charge —
                # its forward is the leader's, shared.
                obs.job_begin(trace_id, job_id=value,
                              task=str(task_id), tenant=tenant or "anon")
                sp.set(task_id=task_id, coalesced=True)
                return 200, {"job_id": value, "task": spec.name,
                             "cache": "coalesced"}
            obs.RESULT_CACHE_MISSES.inc()
        try:
            job_id = self.queue.publish(
                make_job_message(
                    images, question, task_id, socket_id,
                    # "full" passes through (complete per-head maps
                    # persisted); any other truthy value → compact summary.
                    collect_attention=("full" if collect == "full"
                                       else bool(collect)),
                    trace_id=trace_id,
                    tenant=tenant,
                    # The deadline is minted HERE — queueing time counts
                    # against the budget, so a job stuck behind a backlog
                    # expires instead of burning a forward for a long-gone
                    # client.
                    deadline=(Deadline(budget).to_wire()
                              if budget and budget > 0 else None),
                    published_unix=time.time(),
                    cache_key=key))
        except Exception:
            # Leadership was claimed above: a failed publish must drop
            # the claim, or every future identical submit would attach
            # to a leader job that never existed.
            if self.cache is not None and key:
                self.cache.abandon(key)
            raise
        if self.cache is not None and key:
            self.cache.set_leader(key, job_id)
        sp.set(task_id=task_id, job_id=job_id, n_images=len(images))
        body = {"job_id": job_id, "task": spec.name}
        if key:
            body["cache"] = "miss"
        return 200, body

    def _serve_cache_hit(self, spec, socket_id: str, trace_id: str,
                         tenant: Optional[str], payload: Dict[str, Any],
                         sp) -> Tuple[int, Dict[str, Any]]:
        """Answer one submit straight from the durable result cache: the
        same result + completion frames the worker would push, plus the
        payload inline in the 200 body with the ``cache: hit`` marker.
        The cost record charges ONLY the push — zero forward/device
        share, so device-second conservation is untouched (device time
        accrues via job_batch alone)."""
        obs.RESULT_CACHE_HITS.inc()
        obs.job_begin(trace_id, task=str(spec.task_id),
                      tenant=tenant or "anon")
        t_push = time.perf_counter()
        log_to_terminal(self.hub, socket_id,
                        {"result": payload, "cache": "hit"})
        log_to_terminal(self.hub, socket_id,
                        {"terminal": "Task completed from result cache.",
                         "cache": "hit"})
        obs.job_charge(trace_id, "push", time.perf_counter() - t_push)
        obs.job_finish(trace_id, "ok")
        sp.set(task_id=spec.task_id, cache="hit")
        return 200, {"task": spec.name, "cache": "hit", "result": payload}

    def _admission_decision(self):
        counts = self.queue.counts()
        depth = counts.get("pending", 0) + counts.get("inflight", 0)
        return self.admission.admit(
            depth=depth, oldest_age_s=self.queue.oldest_pending_age_s())

    def task_details(self, task_id: int) -> Tuple[int, Dict[str, Any]]:
        task = self.store.get_task(task_id)
        if task is None:
            return 404, {"error": f"unknown task {task_id}"}
        return 200, task

    def demo_images(self, count: int = 8) -> Tuple[int, Dict[str, Any]]:
        demo_dir = os.path.join(self.serving.media_root, "demo")
        files = []
        if os.path.isdir(demo_dir):
            files = [
                os.path.join(demo_dir, f) for f in sorted(os.listdir(demo_dir))
                if f.lower().endswith((".jpg", ".jpeg", ".png"))
            ]
        if len(files) > count:
            files = random.sample(files, count)
        return 200, {
            "demo_images": files,
            # Browser-facing URLs paired index-for-index with the paths the
            # submit payload uses (paths key the feature store; urls render).
            "demo_image_urls": [
                "/media/demo/" + os.path.basename(f) for f in files
            ],
        }

    def save_upload(self, filename: str, data: bytes) -> str:
        """uuid-rename into media/demo (reference views.py:84-103)."""
        ext = os.path.splitext(filename)[1].lower() or ".jpg"
        out_dir = os.path.join(self.serving.media_root, "demo")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{uuid.uuid4()}{ext}")
        with open(path, "wb") as f:
            f.write(data)
        return path

    def health(self) -> Tuple[int, Dict[str, Any]]:
        """Readiness probe: 200 only when the process is past boot AND no
        PAGE-severity SLO is firing — what a load balancer polls before
        routing traffic to this replica. Body carries the evidence."""
        phase = self.boot_info.get("phase")
        booting = phase is not None and phase != "ready"
        # Breaker states as names (BREAKER_GAUGE stores the code).
        codes = {0: "closed", 1: "half_open", 2: "open"}
        breakers = {key[0]: codes.get(int(v), str(v))
                    for key, v in obs.BREAKER_GAUGE.collect().items()}
        slo_states = self.slos.states() if self.slos is not None else {}
        paging = sorted(name for name, state in slo_states.items()
                        if state == obs.STATE_PAGE)
        # Replica-pool readiness: at least one replica must be taking
        # work. Pool state is reconciled by the sampler's probe tick, so a
        # killed replica shows up here within one sampler cadence.
        no_replica = (self.pool is not None
                      and self.pool.ready_count() == 0)
        # Watchdog: any crash-guarded thread that died (by exception or
        # silently) makes the replica unready — a worker with no intake
        # threads drains nothing, whatever the pool says.
        wd = obs.watchdog()
        dead = wd.dead_threads()
        ready = (not booting and not paging and not no_replica
                 and not dead)
        body: Dict[str, Any] = {
            "ok": ready,
            "identity": obs.process_identity().as_dict(),
            "queue": self.queue.counts(),
            "boot": self.boot_info,
            "breakers": breakers,
            "slo": slo_states,
            "threads": {"alive": wd.alive_threads(), "dead": dead},
        }
        if self.pool is not None:
            body["replicas"] = self.pool.replicas_info()
            body["ready_replicas"] = self.pool.ready_count()
            # Target vs actual: an external probe seeing ready < target
            # reads "scale event in progress", not "degraded pool". With
            # no autoscaler the target IS the live replica count.
            body["pool_ready_replicas"] = self.pool.ready_count()
            body["pool_target_replicas"] = (
                self.autoscaler.target_replicas
                if self.autoscaler is not None else
                sum(1 for r in self.pool.replicas_info()
                    if r["state"] != "dead"))
        if not ready:
            body["reason"] = (
                "booting" if booting
                else "no_ready_replica" if no_replica
                else f"thread_died:{','.join(sorted(dead))}" if (
                    dead and not paging)
                else f"slo_page:{','.join(paging)}")
        return (200 if ready else 503), body

    def refresh_gauges(self) -> None:
        """Refresh point-in-time gauges on each Prometheus scrape (pull
        model: queue depth and cache occupancy are read, not pushed)."""
        g = obs.REGISTRY.gauge(
            "vmt_queue_jobs", "Durable queue jobs by state.",
            labelnames=("state",))
        counts = self.queue.counts()
        for state in ("pending", "inflight", "dead"):
            g.set(counts.get(state, 0), state=state)
        if self.metrics is not None and hasattr(self.metrics, "uptime_s"):
            obs.REGISTRY.gauge(
                "vmt_uptime_seconds",
                "Seconds since this serving process booted.",
            ).set(round(self.metrics.uptime_s(), 1))
        if self.slos is not None:
            # Scrapes see current SLO state/burn gauges even when no
            # sampler tick ran since the last change.
            self.slos.evaluate()
        if self.stats_fn is not None:
            try:
                stats = self.stats_fn()
            except Exception:  # noqa: BLE001 — stats best-effort
                stats = {}
            cache = stats.get("input_cache") or {}
            if cache:
                cg = obs.REGISTRY.gauge(
                    "vmt_input_cache", "Engine device input cache stats.",
                    labelnames=("key",))
                for key, value in cache.items():
                    cg.set(value, key=str(key))
            products = stats.get("int8_products") or {}
            if products:
                pg = obs.REGISTRY.gauge(
                    "vmt_int8_products",
                    "int8 GEMM launches a replay of each captured bucket "
                    "makes, by planned kernel.",
                    labelnames=("bucket", "kernel"))
                for bucket, kernels in products.items():
                    for kernel, n in kernels.items():
                        pg.set(n, bucket=str(bucket), kernel=kernel)

    # ------------------------------------------------- cost attribution
    def debug_costs(self, window_s: Optional[float],
                    by: str) -> Tuple[int, Dict[str, Any]]:
        """``GET /debug/costs?window_s=&by=tenant|task``: windowed cost
        aggregates plus the device-second conservation verdict."""
        if self.attrib is None:
            return 200, {"enabled": False, "groups": {}}
        body = self.attrib.window(window_s, by=by)
        body["enabled"] = True
        if self.tracestore is not None:
            body["tracestore"] = self.tracestore.stats()
        return 200, body

    def debug_autoscale(self, limit: int) -> Tuple[int, Dict[str, Any]]:
        """``GET /debug/autoscale?limit=``: the controller's policy knobs,
        live sustain/cooldown state, target-vs-actual replica counts, and
        the last-N decision records (inputs observed, thresholds, action,
        cooldown state) — the ring the autoscaler keeps bounded."""
        if self.autoscaler is None:
            return 200, {"enabled": False, "decisions": []}
        return 200, self.autoscaler.debug_payload(limit=limit)

    def debug_traces(self, *, verdict: Optional[str], task: Optional[str],
                     tenant: Optional[str], scope: str,
                     limit: int) -> Tuple[int, Dict[str, Any]]:
        """``GET /debug/traces?verdict=slow&task=vqa``: stored-trace
        summaries (``scope=fleet`` is the liveness-blind default)."""
        if self.tracestore is None:
            return 200, {"enabled": False, "traces": []}
        # Push this process's buffered keeps first, same freshness
        # contract as the fleet flush on /debug/trace.
        try:
            self.tracestore.flush()
        except Exception:  # noqa: BLE001 — serve what's on disk
            obs.REGISTRY.counter("vmt_tracestore_flush_errors_total").inc()
        rows = self.tracestore.list(verdict=verdict, task=task,
                                    tenant=tenant, scope=scope, limit=limit)
        return 200, {"enabled": True, "scope": scope, "traces": rows,
                     "stats": self.tracestore.stats()}

    def stored_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Chrome-trace doc rebuilt from the durable store — the
        ``/debug/trace`` fallback once a trace has aged out of every live
        span ring (including a dead peer's)."""
        if self.tracestore is None:
            return None
        try:
            self.tracestore.flush()
            rec = self.tracestore.get(trace_id)
        except Exception:  # noqa: BLE001
            rec = None
        if rec is None:
            return None
        events = [{
            "name": s.get("name", ""), "ph": "X", "cat": "obs",
            "ts": round(float(s.get("start_s", 0.0)) * 1e6, 3),
            "dur": round(float(s.get("dur_s", 0.0)) * 1e6, 3),
            "pid": 0, "tid": 0,
            "args": {"trace_id": s.get("trace_id"),
                     "span_id": s.get("span_id"),
                     "parent_id": s.get("parent_id"),
                     "thread_name": s.get("thread_name"),
                     **(s.get("attrs") or {})},
        } for s in rec.get("spans", [])]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "stored": {k: rec.get(k) for k in
                           ("ident", "verdict", "keep_reason", "dur_ms",
                            "stored_unix")}}

    def autopsy(self, trace_id: str) -> Tuple[int, Dict[str, Any]]:
        """``GET /debug/autopsy?trace_id=``: one request's end-to-end
        waterfall — stage charges in pipeline order, device share,
        verdict, and the spans backing them (live record, falling back
        to the durable store)."""
        if not trace_id:
            return 400, {"error": "need trace_id"}
        cost: Optional[Dict[str, Any]] = None
        source = None
        if self.attrib is not None:
            rec = self.attrib.get(trace_id)
            if rec is not None:
                cost, source = rec.as_dict(), "live"
        spans = [s for s in obs.default_tracer().spans()
                 if s.trace_id == trace_id]
        span_dicts = [{"name": s.name, "start_s": s.start_s,
                       "dur_s": s.dur_s, "thread_name": s.thread_name,
                       "attrs": dict(s.attrs)} for s in spans]
        if (cost is None or not span_dicts) and self.tracestore is not None:
            try:
                self.tracestore.flush()
                stored = self.tracestore.get(trace_id)
            except Exception:  # noqa: BLE001
                stored = None
            if stored is not None:
                if cost is None and stored.get("cost"):
                    cost, source = stored["cost"], "store"
                if not span_dicts:
                    span_dicts = stored.get("spans", [])
        if cost is None and not span_dicts:
            return 404, {"error": f"no cost record or stored trace for "
                                  f"{trace_id}"}
        stages = (cost or {}).get("stages", {})
        waterfall = [{"stage": st, "ms": round(stages[st], 3)}
                     for st in obs.COST_STAGES if st in stages]
        return 200, {"trace_id": trace_id, "source": source,
                     "verdict": (cost or {}).get("verdict"),
                     "total_ms": (cost or {}).get("total_ms"),
                     "device_s": (cost or {}).get("device_s"),
                     "waterfall": waterfall, "cost": cost,
                     "spans": span_dicts}

    # --------------------------------------------------------------- server
    def _make_handler(self):
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _json(self, code: int, payload: Dict[str, Any],
                      headers: Optional[Dict[str, str]] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.rstrip("/") or "/"
                if path == "/":
                    # Browsers get the single-page demo app (the reference's
                    # index.html render, views.py:39-42); API clients keep
                    # the JSON contract.
                    if self._wants_html():
                        self._serve_static_page("index.html")
                        return
                    self._json(200, {
                        "tasks": api.store.list_tasks(),
                        "socket_id": str(uuid.uuid4()),
                    })
                elif path == "/config":
                    self._json(200, {
                        "ws_port": api.ws_port,
                        "socket_id": str(uuid.uuid4()),
                        "tasks": api.store.list_tasks(),
                        "max_upload_images": api.serving.max_upload_images,
                        "live_extract": bool(
                            api.boot_info.get("live_extract")),
                    })
                elif path.startswith("/get_task_details/"):
                    try:
                        task_id = int(path.split("/")[2])
                    except (IndexError, ValueError):
                        self._json(400, {"error": "bad task id"})
                        return
                    self._json(*api.task_details(task_id))
                elif path == "/get_demo_images":
                    self._json(*api.demo_images())
                elif self.path.startswith("/media/"):
                    self._serve_media()
                elif path == "/admin":
                    # The admin console page (reference: the Django admin
                    # UI, demo/admin.py) — browsers get HTML, API clients
                    # an index of the admin endpoints.
                    if self._wants_html():
                        self._serve_static_page("admin.html")
                        return
                    self._json(200, {"endpoints": [
                        "/admin/tasks", "/admin/questionanswer",
                        "POST /admin/tasks/<id>",
                        "POST /admin/questionanswer/<id>"]})
                elif path == "/admin/tasks":
                    # Browse surface over the task catalog
                    # (reference demo/admin.py:7-21 TaskAdmin list view).
                    self._json(200, {"tasks": api.store.list_tasks()})
                elif path.startswith("/admin/questionanswer"):
                    # QA audit-log browse (reference demo/admin.py:24-34
                    # QuestionAnswerAdmin: newest-first, readonly).
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        limit = int(q.get("limit", ["50"])[0])
                    except ValueError:
                        limit = 50
                    limit = max(1, min(limit, 500))
                    rows = api.store.recent(limit=limit)
                    # socket_id is the only credential for subscribing to a
                    # client's websocket stream — never expose it here.
                    for r in rows:
                        r.pop("socket_id", None)
                    self._json(200, {"rows": rows})
                elif path.startswith("/attention/"):
                    self._serve_attention(path)
                elif path == "/healthz" or path.startswith("/healthz?"):
                    # NB: ``path`` retains the query string (rstrip only
                    # trims slashes), hence the startswith branch.
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    if q.get("scope", [""])[0] == "fleet":
                        if api.fleet is None:
                            self._json(503, {"error": "no fleet spine "
                                                      "configured"})
                            return
                        fleet = api.fleet.health()
                        self._json(200 if fleet["fleet_ready"] else 503,
                                   fleet)
                        return
                    self._json(*api.health())
                elif path == "/metrics" or path.startswith("/metrics?"):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    if q.get("scope", [""])[0] == "fleet":
                        # Fleet scope is always a scrape: merged Prometheus
                        # text across live peers (counters summed, gauges
                        # per-identity, histograms bucket-merged).
                        self._serve_fleet_prometheus()
                        return
                    if q.get("format", [""])[0] == "prometheus":
                        self._serve_prometheus()
                        return
                    if q.get("format", [""])[0] == "openmetrics":
                        # OpenMetrics exposition: same samples plus bucket
                        # exemplars linking straight to stored trace ids.
                        self._serve_openmetrics()
                        return
                    snap = (api.metrics.snapshot()
                            if api.metrics is not None else {})
                    snap["queue"] = api.queue.counts()
                    if api.stats_fn is not None:
                        try:
                            snap.update(api.stats_fn())
                        except Exception:  # noqa: BLE001 — stats best-effort
                            pass
                    self._json(200, snap)
                elif path == "/debug/slo":
                    if api.slos is None:
                        self._json(200, {"enabled": False, "slos": []})
                        return
                    reports = api.slos.evaluate()
                    states = [r["state"] for r in reports]
                    worst = (obs.STATE_PAGE if obs.STATE_PAGE in states
                             else obs.STATE_WARN if obs.STATE_WARN in states
                             else obs.STATE_OK)
                    self._json(200, {
                        "enabled": True,
                        "worst": worst,
                        "slos": reports,
                    })
                elif (path == "/debug/timeseries"
                      or path.startswith("/debug/timeseries?")):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        window = float(q.get("window_s", ["0"])[0]) or None
                    except ValueError:
                        window = None
                    if q.get("scope", [""])[0] == "fleet":
                        if api.fleet is None:
                            self._json(200, {"enabled": False,
                                             "scope": "fleet", "series": {}})
                            return
                        body = api.fleet.timeseries(window)
                        body["enabled"] = True
                        self._json(200, body)
                        return
                    if api.timeseries is None:
                        self._json(200, {"enabled": False, "series": {}})
                        return
                    self._json(200, {
                        "enabled": True,
                        "series": api.timeseries.snapshot(window),
                    })
                elif path == "/debug/trace" or path.startswith("/debug/trace?"):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        limit = int(q.get("limit", ["0"])[0]) or None
                    except ValueError:
                        limit = None
                    trace_id = q.get("trace_id", [""])[0] or None
                    fleet_scope = (q.get("scope", [""])[0] == "fleet"
                                   or trace_id is not None)
                    if fleet_scope and api.fleet is not None:
                        # Export this process's freshest spans first so a
                        # trace queried right after completion stitches
                        # without waiting out a sampler tick.
                        try:
                            api.fleet.flush()
                        except Exception:  # noqa: BLE001 — serve what's there
                            obs.REGISTRY.counter(
                                "vmt_fleet_flush_errors_total").inc()
                        doc = api.fleet.chrome_trace(trace_id, limit=limit)
                        if trace_id is not None and not any(
                                e.get("ph") == "X"
                                for e in doc.get("traceEvents", [])):
                            # Aged out of every peer's span window — the
                            # durable store is the last line of autopsy.
                            stored = api.stored_trace(trace_id)
                            if stored is not None:
                                self._json(200, stored)
                                return
                        self._json(200, doc)
                        return
                    if trace_id is not None:
                        spans = [s for s in obs.default_tracer().spans()
                                 if s.trace_id == trace_id]
                        if not spans:
                            stored = api.stored_trace(trace_id)
                            if stored is not None:
                                self._json(200, stored)
                                return
                        self._json(200, obs.chrome_trace(spans=spans))
                        return
                    self._json(200, obs.chrome_trace(limit=limit))
                elif (path == "/debug/costs"
                      or path.startswith("/debug/costs?")):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        window = float(q.get("window_s", ["0"])[0]) or None
                    except ValueError:
                        window = None
                    self._json(*api.debug_costs(
                        window, q.get("by", ["task"])[0]))
                elif (path == "/debug/traces"
                      or path.startswith("/debug/traces?")):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        limit = int(q.get("limit", ["50"])[0])
                    except ValueError:
                        limit = 50
                    self._json(*api.debug_traces(
                        verdict=q.get("verdict", [""])[0] or None,
                        task=q.get("task", [""])[0] or None,
                        tenant=q.get("tenant", [""])[0] or None,
                        scope=q.get("scope", ["fleet"])[0] or "fleet",
                        limit=max(1, min(limit, 500))))
                elif (path == "/debug/autopsy"
                      or path.startswith("/debug/autopsy?")):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    self._json(*api.autopsy(q.get("trace_id", [""])[0]))
                elif (path == "/debug/autoscale"
                      or path.startswith("/debug/autoscale?")):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        limit = int(q.get("limit", ["50"])[0])
                    except ValueError:
                        limit = 50
                    self._json(*api.debug_autoscale(
                        limit=max(1, min(limit, 500))))
                else:
                    self._json(404, {"error": "not found"})

            def _wants_html(self) -> bool:
                """Browser-vs-API content negotiation (one place)."""
                return "text/html" in self.headers.get("Accept", "")

            def _serve_prometheus(self) -> None:
                api.refresh_gauges()
                self._send_prometheus(
                    obs.render_prometheus(extra=self._extra_instruments()))

            def _serve_openmetrics(self) -> None:
                api.refresh_gauges()
                self._send_text(
                    obs.render_openmetrics(extra=self._extra_instruments()),
                    obs.OPENMETRICS_CONTENT_TYPE)

            def _extra_instruments(self):
                return ([api.metrics.latency]
                        if api.metrics is not None
                        and hasattr(api.metrics, "latency") else [])

            def _serve_fleet_prometheus(self) -> None:
                if api.fleet is None:
                    self._json(503, {"error": "no fleet spine configured"})
                    return
                # Refresh local gauges and push them to the spine so the
                # answering process is never staler than its own scrape.
                api.refresh_gauges()
                try:
                    api.fleet.flush()
                except Exception:  # noqa: BLE001 — merge what peers wrote
                    obs.REGISTRY.counter(
                        "vmt_fleet_flush_errors_total").inc()
                self._send_prometheus(api.fleet.render_prometheus())

            def _send_prometheus(self, text: str) -> None:
                self._send_text(text, obs.PROMETHEUS_CONTENT_TYPE)

            def _send_text(self, text: str, ctype: str) -> None:
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _serve_static_page(self, name: str):
                page = os.path.join(os.path.dirname(__file__), "static",
                                    name)
                try:
                    with open(page, "rb") as f:
                        body = f.read()
                except OSError:
                    self._json(500, {"error": "frontend asset missing"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _serve_attention(self, path: str):
                """JSON view of a request's persisted full attention maps
                (worker.save_full_attention). Default response is head-
                averaged per bridge — browser-heatmap sized; ``?heads=all``
                returns every head (the complete reference-contract payload,
                worker.py:288). The raw arrays are also downloadable as
                ``/media/attention/qa_<id>.npz``."""
                from urllib.parse import parse_qs, urlsplit

                try:
                    qa_id = int(urlsplit(path).path.split("/")[2])
                except (IndexError, ValueError):
                    self._json(400, {"error": "bad qa id"})
                    return
                npz = os.path.join(api.serving.media_root, "attention",
                                   f"qa_{qa_id}.npz")
                if not os.path.isfile(npz):
                    self._json(404, {"error": f"no attention maps for "
                                              f"qa {qa_id}; submit with "
                                              f"collect_attention='full'"})
                    return
                import numpy as np

                all_heads = parse_qs(urlsplit(self.path).query).get(
                    "heads", [""])[0] == "all"
                try:
                    with np.load(npz) as z:
                        bridges: Dict[int, Dict[str, Any]] = {}
                        for key in z.files:
                            name, direction = key.rsplit("_", 1)
                            idx = int(name.replace("bridge", ""))
                            arr = z[key]  # (H, Nq, Nk)
                            if not all_heads:
                                arr = arr.mean(axis=0)  # head-avg (Nq, Nk)
                            bridges.setdefault(idx, {})[direction] = (
                                np.round(arr, 5).tolist())
                except Exception as e:  # noqa: BLE001 — a corrupt archive
                    # (zipfile.BadZipFile, truncated stream) must yield a
                    # JSON 500, not a dropped connection.
                    self._json(500, {"error": f"attention maps for qa "
                                              f"{qa_id} unreadable: {e}"})
                    return
                self._json(200, {
                    "qa_id": qa_id,
                    "heads": "all" if all_heads else "mean",
                    "bridges": [bridges[i] for i in sorted(bridges)],
                })

            def _serve_media(self):
                from vilbert_multitask_tpu_torch.utils import contained_path

                rel = self.path[len("/media/"):].lstrip("/")
                # containment check: resolved target must stay under media_root
                full = contained_path(
                    api.serving.media_root,
                    os.path.join(api.serving.media_root, rel))
                if full is None:
                    self._json(403, {"error": "forbidden"})
                    return
                if not os.path.isfile(full):
                    self._json(404, {"error": "not found"})
                    return
                ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
                with open(full, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                path = self.path.rstrip("/") or "/"
                if path == "/":
                    try:
                        payload = json.loads(raw or b"{}")
                    except json.JSONDecodeError:
                        self._json(400, {"error": "invalid JSON"})
                        return
                    code, body = api.submit_job(payload)
                    headers = None
                    if code == 429:
                        # RFC 9110 §10.2.3: Retry-After in whole seconds.
                        headers = {"Retry-After": str(max(1, int(round(
                            body.get("retry_after_s", 1)))))}
                    self._json(code, body, headers=headers)
                elif path == "/upload_image":
                    self._handle_upload(raw, ctype)
                elif path.startswith("/worker/"):
                    self._handle_worker(path, raw)
                elif path == "/admin/swap":
                    self._handle_admin_swap(raw)
                elif path.startswith("/admin/"):
                    self._handle_admin_edit(path, raw)
                elif path == "/debug/profile/start":
                    try:
                        p = json.loads(raw or b"{}")
                    except json.JSONDecodeError:
                        self._json(400, {"error": "invalid JSON"})
                        return
                    log_dir = str(p.get("log_dir", "")) or os.path.join(
                        api.serving.media_root, "profiles")
                    os.makedirs(log_dir, exist_ok=True)
                    res = obs.start_profile(log_dir)
                    self._json(200 if res["ok"] else 409, res)
                elif path == "/debug/profile/stop":
                    res = obs.stop_profile()
                    self._json(200 if res["ok"] else 409, res)
                else:
                    self._json(404, {"error": "not found"})

            def _handle_admin_swap(self, raw: bytes):
                """POST /admin/swap {checkpoint_path}: rolling zero-downtime
                checkpoint swap across the replica pool (ServeApp wires
                ``swap_fn``). Runs in this handler thread — the server is
                threaded, so health/metrics/submits keep flowing while
                replicas drain and reload one at a time. Same admin-token
                gate as the admin edit surface."""
                token = getattr(api.serving, "admin_token", None)
                if token:
                    import hmac

                    auth = self.headers.get("Authorization", "")
                    if not hmac.compare_digest(auth, f"Bearer {token}"):
                        self._json(401, {"error": "bad admin token"})
                        return
                if api.swap_fn is None:
                    self._json(409, {"error": "no swap handler wired"})
                    return
                try:
                    p = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "invalid JSON"})
                    return
                ckpt = p.get("checkpoint_path")
                if not ckpt:
                    self._json(400, {"error": "need checkpoint_path"})
                    return
                try:
                    report = api.swap_fn(checkpoint_path=str(ckpt))
                except (ValueError, FileNotFoundError, TimeoutError) as e:
                    self._json(409, {"error": f"swap failed: {e}"})
                    return
                self._json(200, {"ok": True, "swap": report})

            def _handle_admin_edit(self, path: str, raw: bytes):
                """Admin write surface (reference demo/admin.py:11-34: the
                Django admin edits Tasks rows and QuestionAnswer text).
                POST /admin/tasks/<id> and /admin/questionanswer/<id> take a
                JSON object of editable fields and return the updated row
                with the same scrubbing the browse endpoints apply.

                Gated behind ``ServingConfig.admin_token`` when set (the
                reference admin sits behind Django auth, demo/admin.py);
                unset keeps the open loopback-dev posture, but an edited
                row persists across reboots (the reseed never overwrites
                ``edited=1`` rows), so cross-host deployments must set it."""
                token = getattr(api.serving, "admin_token", None)
                if token:
                    import hmac

                    auth = self.headers.get("Authorization", "")
                    if not hmac.compare_digest(auth, f"Bearer {token}"):
                        self._json(401, {"error": "bad admin token"})
                        return
                parts = path.strip("/").split("/")
                if len(parts) != 3 or parts[1] not in (
                        "tasks", "questionanswer"):
                    self._json(404, {"error": "not found"})
                    return
                try:
                    row_id = int(parts[2])
                except ValueError:
                    self._json(400, {"error": "bad id"})
                    return
                try:
                    fields = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "invalid JSON"})
                    return
                if not isinstance(fields, dict):
                    self._json(400, {"error": "body must be a JSON object"})
                    return
                try:
                    if parts[1] == "tasks":
                        row = api.store.update_task(row_id, fields)
                    else:
                        row = api.store.update_question(row_id, fields)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                if row is None:
                    self._json(404, {"error": f"no row {row_id}"})
                    return
                row.pop("socket_id", None)  # same scrub as the browse view
                self._json(200, {"row": row})

            def _handle_worker(self, path: str, raw: bytes):
                """Network face of the queue/store/hub for remote workers
                (serve/remote.py) — the reference's broker is reachable over
                TCP (demo/sender.py:12-15); this keeps web tier and device
                workers deployable on separate hosts."""
                token = getattr(api.serving, "worker_token", None)
                if token:
                    import hmac

                    auth = self.headers.get("Authorization", "")
                    if not hmac.compare_digest(auth, f"Bearer {token}"):
                        self._json(401, {"error": "bad worker token"})
                        return
                try:
                    p = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "invalid JSON"})
                    return
                try:
                    if path == "/worker/claim":
                        claimed_by = p.get("claimed_by") or None
                        job = api.queue.claim(
                            exclude=[int(x) for x in p.get("exclude", [])],
                            claimed_by=(str(claimed_by)
                                        if claimed_by else None))
                        self._json(200, {"job": None if job is None else {
                            "id": job.id, "body": job.body,
                            "attempts": job.attempts,
                            "deliveries": job.deliveries}})
                    elif path == "/worker/dead_letters":
                        jobs = api.queue.pop_dead_letters()
                        self._json(200, {"jobs": [
                            {"id": j.id, "body": j.body,
                             "attempts": j.attempts,
                             "deliveries": j.deliveries} for j in jobs]})
                    elif path == "/worker/ack":
                        api.queue.ack(int(p["job_id"]))
                        self._json(200, {"ok": True})
                    elif path == "/worker/nack":
                        self._json(200,
                                   {"status": api.queue.nack(int(p["job_id"]))})
                    elif path == "/worker/release":
                        api.queue.release(int(p["job_id"]))
                        self._json(200, {"ok": True})
                    elif path == "/worker/question":
                        qa_id = api.store.create_question(
                            int(p["task_id"]), str(p.get("input_text", "")),
                            list(p.get("input_images", [])),
                            str(p.get("socket_id", "")),
                            queue_job_id=p.get("queue_job_id"))
                        self._json(200, {"qa_id": qa_id})
                    elif path == "/worker/answer":
                        api.store.save_answer(
                            int(p["qa_id"]), p.get("answer", {}),
                            list(p.get("answer_images", [])))
                        self._json(200, {"ok": True})
                    elif path == "/worker/push":
                        n = api.hub.publish(str(p.get("socket_id", "")),
                                            p.get("frame", {}))
                        self._json(200, {"subscribers": n})
                    else:
                        self._json(404, {"error": "not found"})
                except (KeyError, TypeError, ValueError) as e:
                    self._json(400, {"error": f"bad worker request: {e}"})

            def _handle_upload(self, raw: bytes, ctype: str):
                if "multipart/form-data" not in ctype:
                    self._json(400, {"error": "expected multipart/form-data"})
                    return
                with obs.span("http.upload", bytes=len(raw)) as sp:
                    msg = email.message_from_bytes(
                        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + raw,
                        policy=email.policy.HTTP,
                    )
                    paths = []
                    for part in msg.iter_parts():
                        name = part.get_filename()
                        if not name:
                            continue
                        if len(paths) >= api.serving.max_upload_images:
                            break  # reference caps uploads (demo_images.html:92-95)
                        paths.append(api.save_upload(
                            name, part.get_payload(decode=True) or b""))
                    sp.set(n_files=len(paths))
                self._json(200, {"file_paths": paths})

        return Handler

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer(
            (self.serving.http_host, self.serving.http_port),
            self._make_handler(),
        )
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http-api")
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
