"""Application composition: engine + queue + worker + HTTP + websocket.

The port's copy of the JAX package's ``serve/app.py``. Reference
capability: the deployment described by SURVEY.md §1 — Django (wsgi/asgi),
a RabbitMQ broker, Redis, Postgres, and a GPU worker process — collapsed
into one self-contained serving binary per host: the engine on one CUDA
device and all tiers share the process; durability lives in the sqlite
queue/store files.

    python -m vilbert_multitask_tpu_torch.serve.app --features <dir>

boots on the card, warms (captures one CUDA graph per row bucket, see
engine/graphs.py) and serves. ``--device cpu`` runs the same binary on the
CPU (plain kernel versions, no graphs). ``--live-extract`` answers uploads
that have no precomputed features through the live detector (detect/);
``--checkpoint`` restores the trunk's weights from a checkpoint directory
of this package (checkpoint/store.py) or the reference's
``pytorch_model_*.bin``, cast on the host to ``EngineConfig.param_dtype``
(``"int8"`` quantizes it), and ``--detector-checkpoint`` reads a maskrcnn
detector ``.pth`` (torch files: the JAX package's Orbax directories are not
read here). Where the JAX app keeps its AOT executable cache, this one
keeps the kernel libraries nvcc builds (``EngineConfig.aot_cache_dir``,
engine/aotcache.py: next to ``--checkpoint``, else under
``serve_state/``): they build while the checkpoint restores, and a
prewarmed directory boots with no nvcc run. The XLA compilation cache has
no counterpart on this backend.

On a process mesh (the ranks started by ``parallel/launch.py``, ``--mesh
dp,tp[,sp]``; NCCL takes one card per rank), the mesh is built before the
restore, as the JAX app builds it: every rank restores its shard and
builds the mesh engine; rank 0 serves, and the other ranks follow its
dispatches (:func:`follow_rank`) until it stops.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.config import (
    DetectorConfig,
    FrameworkConfig,
    config_fingerprint,
)
from vilbert_multitask_tpu_torch.engine.aotcache import default_cache_dir
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
from vilbert_multitask_tpu_torch.features.store import FeatureStore
from vilbert_multitask_tpu_torch.serve.autoscale import Autoscaler
from vilbert_multitask_tpu_torch.serve.db import ResultStore
from vilbert_multitask_tpu_torch.serve.http_api import ApiServer
from vilbert_multitask_tpu_torch.serve.pool import ReplicaPool
from vilbert_multitask_tpu_torch.serve.push import PushHub, WebSocketBridge
from vilbert_multitask_tpu_torch.serve.queue import DurableQueue
from vilbert_multitask_tpu_torch.serve.resultcache import ResultCache
from vilbert_multitask_tpu_torch.serve.worker import ServeWorker

_FLEET_FLUSH_ERRORS = obs.REGISTRY.counter(
    "vmt_fleet_flush_errors_total",
    "Sampler ticks whose fleet-spine flush failed (local tick unaffected).")
_TRACESTORE_FLUSH_ERRORS = obs.REGISTRY.counter(
    "vmt_tracestore_flush_errors_total",
    "Sampler ticks whose trace-store flush failed (local tick unaffected).")
_AUTOSCALE_TICK_ERRORS = obs.REGISTRY.counter(
    "vmt_autoscale_tick_errors_total",
    "Sampler ticks whose autoscale control step raised (tick unaffected).")


class ServeApp:
    def __init__(self, cfg: Optional[FrameworkConfig] = None, *,
                 engine: Optional[InferenceEngine] = None,
                 feature_root: str = "features",
                 checkpoint_path: Optional[str] = None,
                 live_extract: bool = False,
                 detector_checkpoint: Optional[str] = None,
                 detector: Optional[DetectorConfig] = None,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 device: str = "cuda"):
        self.cfg = cfg or FrameworkConfig()
        # A server records its spans (a tracer starts disabled): /metrics'
        # vmt_span_ms, /debug/trace and the trace store read them.
        obs.default_tracer().enable()
        # The kernel-library cache (engine/aotcache.py), as the JAX app
        # places its AOT cache: next to the checkpoint, where a prewarm
        # step fills it and every replica host mounts it, else under
        # serve_state/ with the other durable files. An explicit
        # EngineConfig value wins.
        if self.cfg.engine.aot_cache_dir is None:
            self.cfg = dataclasses.replace(
                self.cfg, engine=dataclasses.replace(
                    self.cfg.engine, aot_cache_dir=default_cache_dir(
                        self.cfg, checkpoint_path)))
        s = self.cfg.serving
        if detector_checkpoint is not None and not live_extract:
            raise ValueError("detector_checkpoint needs live_extract=True")
        # The live detector's geometry (DetectorConfig() at serving width);
        # its fc6 width always follows the trunk's region features.
        self.detector_cfg = dataclasses.replace(
            detector or DetectorConfig(),
            representation_size=self.cfg.model.v_feature_size)
        self.boot_info: dict = {"phase": "booting"}
        self.extractor = None
        self.hub = PushHub()
        self.queue = DurableQueue(
            s.queue_db_path, queue_name=s.queue_name,
            max_delivery_attempts=s.max_delivery_attempts,
            max_deliveries=s.queue_max_deliveries)
        self.store = ResultStore(s.results_db_path)
        if engine is None:
            # A launch of several ranks serves through the process mesh,
            # built before the restore so each rank reads its own shard.
            mesh = mesh_of_world(self.cfg)
            if mesh is not None and s.pool_replicas > 1:
                raise ValueError("a mesh engine spans the ranks: "
                                 "pool_replicas must be 1")
            params = None
            restore = None
            # nvcc builds the variant's missing libraries while the
            # checkpoint restores (the JAX app's overlap of restore and
            # cache); the CPU runs the plain versions and builds nothing.
            aot = _kernel_cache(self.cfg, live_extract, device)
            if aot is not None:
                self.boot_info["aot_prefetched"] = aot.prefetch()
            if checkpoint_path is not None:
                from vilbert_multitask_tpu_torch.checkpoint import (
                    restore_params_async,
                )

                # Cast to the engine's storage dtype on the host ("int8"
                # quantizes: an int8 deployment never serves a checkpoint
                # fat), in the background while the detector is built.
                restore = restore_params_async(
                    checkpoint_path, dtype=self.cfg.engine.param_dtype,
                    cfg=self.cfg.model, mesh=mesh)
            store = FeatureStore(feature_root)
            if live_extract:
                store = self._live_store(store, detector_checkpoint, device)
            phases = {}
            if restore is not None:
                params = restore.join()
                self.boot_info["restore_s"] = round(restore.seconds, 1)
                phases["restore_s"] = restore.seconds
            phases.update(_join_kernel_cache(aot, self.boot_info))
            t0 = time.perf_counter()
            with obs.span("serve.boot"):
                # pool_replicas engines share ONE set of weights (the
                # checkpoint's, or engine 0 draws seeded ones and the rest
                # load its state dict) and one feature store. Each keeps
                # its own slab, input cache, graphs, stream and breaker.
                engines = []
                for i in range(max(1, s.pool_replicas)):
                    engines.append(InferenceEngine(
                        self.cfg, params=params, feature_store=store,
                        replica_id=f"r{i}", mesh=mesh, device=device))
                    if params is None:
                        params = engines[0].state_dict()
                engine = engines
                for phase, seconds in phases.items():
                    engines[0].book_boot_time(phase, seconds)
            self.boot_info["engine_init_s"] = round(
                time.perf_counter() - t0, 1)
            if engine_factory is None:
                # Scale-out builds engines exactly like the boot replicas.
                def engine_factory(_params=params, _store=store):
                    return InferenceEngine(self.cfg, params=_params,
                                           feature_store=_store,
                                           device=device)
        # The serving plane always programs against a ReplicaPool — with
        # one replica it degenerates to a thin facade over the engine; the
        # checkout/checkin seam, health states, and failover semantics stay
        # identical at every pool size. Callers may inject a prebuilt
        # engine, a list of engines, or an existing pool.
        if isinstance(engine, ReplicaPool):
            self.engine = engine
        else:
            engines = list(engine) if isinstance(engine, (list, tuple)) \
                else [engine]
            self.engine = ReplicaPool(engines, serving=s)
        if live_extract and self.extractor is None:
            # An injected engine keeps its feature store, wrapped the same
            # way (one extractor for the pool, one wrapper per store).
            wrapped: Dict[int, Any] = {}
            for rep in self.engine.replicas:
                base = rep.engine.feature_store
                if id(base) not in wrapped:
                    wrapped[id(base)] = self._live_store(
                        base, detector_checkpoint, device)
                rep.engine.feature_store = wrapped[id(base)]
        self.boot_info["replicas"] = [r.name for r in self.engine.replicas]
        self._refresh_boot_phases()
        self.fingerprint = config_fingerprint(self.cfg)
        # Result cache + singleflight registry: a second table pair in the
        # SAME WAL sqlite as the jobs queue (one db to mount, one recovery
        # story). Keyed on (task, image identity, canonical question,
        # fingerprint:generation) — a rolling swap bumps model_gen so every
        # pre-swap entry turns stale atomically. Coalescing rides the cache
        # (followers attach to the leader's cache row), so coalesce without
        # the cache is unsupported by construction.
        self.model_gen = 0
        self.cache: Optional[ResultCache] = None
        if s.result_cache_enabled:
            self.cache = ResultCache(
                s.queue_db_path,
                fingerprint=self._cache_fingerprint(),
                max_rows=s.result_cache_max_rows,
                ttl_s=s.result_cache_ttl_s,
                lease_s=s.coalesce_lease_s)
        self.worker = ServeWorker(self.engine, self.queue, self.store,
                                  self.hub, s, cache=self.cache)
        # Live-health plane (obs/): the time-series store + sampler, the
        # SLO evaluator, and the flight recorder. Built here so /debug/slo
        # and /healthz see them from the first request; the sampler thread
        # and the recorder's global installation happen in start().
        # Placeholders so _build_slos's page hook can close over them; the
        # real instances are built after the fleet spine (shared db path).
        self.attrib: Optional[obs.CostAttributor] = None
        self.tracestore: Optional[obs.TraceStore] = None
        self.timeseries = obs.TimeSeriesStore(points=s.timeseries_points)
        self.slos = self._build_slos()
        self.sampler = obs.Sampler(self.timeseries, self._sample,
                                   cadence_s=s.sampler_cadence_s)
        # Closed-loop autoscaler (serve/autoscale.py): its control step
        # rides _sample() — the same no-new-threads deal as pool.probe().
        # Off by default; the knob block in ServingConfig documents the
        # policy.
        self.autoscaler: Optional[Autoscaler] = None
        if s.autoscale_enabled:
            self.autoscaler = Autoscaler(
                self.engine, s, slos=self.slos, queue=self.queue,
                engine_factory=engine_factory)
        # Fleet observability: this process's identity plus its handle on
        # the shared metrics spine (a WAL sqlite next to the queue db).
        # Every sampler tick flushes instruments/timeseries/spans/heartbeat
        # there; ?scope=fleet queries on any peer merge them back.
        self.identity = obs.process_identity("serve")
        self.fleet: Optional[obs.FleetSpine] = None
        if s.fleet_enabled:
            self.fleet = obs.FleetSpine(
                s.fleet_db_path or obs.default_spine_path(s.queue_db_path),
                self.identity,
                heartbeat_stale_s=s.fleet_heartbeat_stale_s,
                max_spans_per_ident=s.fleet_max_spans,
                spans_per_flush=s.fleet_spans_per_flush,
                timeseries_window_s=s.fleet_timeseries_window_s,
                timeseries=self.timeseries)
        # Cost-attribution plane: per-job stage/device-second records
        # (obs/attrib.py) feeding the durable tail-sampled trace store
        # (obs/tracestore.py) on the SAME sqlite file as the fleet spine —
        # one db to mount, and ?scope=fleet trace reads come for free.
        if s.attrib_enabled:
            self.tracestore = obs.TraceStore(
                s.fleet_db_path or obs.default_spine_path(s.queue_db_path),
                self.identity.ident,
                keep_top_k=s.tracestore_keep_top_k,
                sample_rate=s.tracestore_sample_rate,
                retention_s=s.tracestore_retention_s)
            self.attrib = obs.CostAttributor(on_finish=self._offer_trace)
        rec_dir = s.recorder_dir
        if rec_dir == "serve_state/postmortem":
            # Default follows the queue db (tests and the soak point that
            # at a tmpdir; bundles must land there too, not in CWD).
            rec_dir = os.path.join(
                os.path.dirname(s.queue_db_path) or "serve_state",
                "postmortem")
        self.recorder = obs.FlightRecorder(
            rec_dir, max_bundles=s.recorder_max_bundles,
            max_bytes=s.recorder_max_bytes, spans=s.recorder_spans,
            min_interval_s=s.recorder_min_interval_s,
            sources={
                "timeseries": self.timeseries.snapshot,
                "config_fingerprint": lambda: self.fingerprint,
                "boot_info": lambda: dict(self.boot_info),
                "identity": self.identity.as_dict,
                "fleet": lambda: (self.fleet.snapshot()
                                  if self.fleet is not None else {}),
            })
        self.api = ApiServer(
            self.queue, self.store, self.hub, s,
            metrics=self.worker.metrics, boot_info=self.boot_info,
            stats_fn=lambda: {"input_cache": self.engine.input_cache_stats},
            slos=self.slos, timeseries=self.timeseries,
            pool=self.engine, swap_fn=self.rolling_swap, fleet=self.fleet,
            attrib=self.attrib, tracestore=self.tracestore,
            cache=self.cache, autoscaler=self.autoscaler)
        self.ws = WebSocketBridge(self.hub, s.http_host, s.ws_port)
        self.http_port: Optional[int] = None  # actual bound port after start
        self._stop = threading.Event()
        self._worker_thread: Optional[threading.Thread] = None

    def _live_store(self, store, detector_checkpoint: Optional[str],
                    device: str):
        """Wrap ``store`` so novel uploads with no precomputed features run
        through the live detector (reference worker.py:59-223; detect/).
        Seeded random detector weights unless a maskrcnn checkpoint is
        given."""
        from vilbert_multitask_tpu_torch.detect import (
            FallbackFeatureStore,
            LiveFeatureExtractor,
        )

        if self.extractor is None:
            params = None
            if detector_checkpoint is not None:
                from vilbert_multitask_tpu_torch.detect.convert import (
                    load_torch_detector,
                )

                params = load_torch_detector(detector_checkpoint,
                                             self.detector_cfg)
            self.extractor = LiveFeatureExtractor(
                self.detector_cfg, params=params, device=device)
        self.boot_info["live_extract"] = True
        return FallbackFeatureStore(store, self.extractor,
                                    media_root=self.cfg.serving.media_root)

    def _refresh_boot_phases(self) -> None:
        """Fold the engines' boot-phase split into ``/healthz``'s boot
        section: the JAX app's restore_s (checkpoint restore), cache_load_s
        (loading the built kernel libraries), compile_s (nvcc on a cache
        miss plus the graph captures at warmup, also booked apart as
        nvcc_s and capture_s) and upload_s (weight load). Summed across
        the pool — warmup phases accumulate, so this runs again after
        :meth:`warm`. Tolerates injected test doubles."""
        phases: dict = {}
        for rep in getattr(self.engine, "replicas", []):
            times = getattr(rep.engine, "boot_times", None)
            if not times:
                continue
            for phase, seconds in dict(times).items():
                phases[phase] = round(phases.get(phase, 0.0) + seconds, 3)
        if phases:
            self.boot_info["boot_phases"] = phases

    # ------------------------------------------------------- live health
    def _build_slos(self) -> "obs.SloEvaluator":
        """The serving plane's three SLOs (targets in ServingConfig):
        availability, e2e latency vs. target, deadline-slack floor."""
        s = self.cfg.serving
        m = self.worker.metrics
        slos = [
            obs.availability_slo(
                "availability", m.latency, m.failure_events,
                error_budget=s.slo_availability_budget),
            obs.latency_slo(
                "e2e_latency", m.latency, target_ms=s.slo_e2e_target_ms,
                error_budget=s.slo_e2e_budget),
            obs.slack_floor_slo(
                "deadline_slack", obs.DEADLINE_SLACK,
                floor_ms=s.slo_slack_floor_ms,
                error_budget=s.slo_slack_budget),
        ]
        # One availability objective PER REPLICA, fed by the pool's
        # labelled dispatch histograms: a single sick replica burns its
        # own budget visibly instead of hiding inside the fleet average.
        pool = self.engine
        for rep in pool.replicas:
            def counts(window_s: float, _name=rep.name,
                       _ok=pool.dispatch_ms, _fail=pool.dispatch_fail):
                return (_ok.window_count(window_s, replica=_name),
                        _fail.window_count(window_s, replica=_name))
            slos.append(obs.Slo(
                f"replica_{rep.name}_availability",
                f"dispatches on replica {rep.name} succeed", counts,
                error_budget=s.slo_availability_budget))
        def on_page(name: str, report: dict) -> None:
            # Default recorder trigger, plus: the page's exemplar traces
            # get pinned so the store force-keeps their next offers even
            # when the tail sampler would have dropped them.
            obs.SloEvaluator._page_event(name, report)
            if self.tracestore is not None:
                self.tracestore.pin(report.get("exemplar_trace_ids", []))
        return obs.SloEvaluator(
            slos, fast_window_s=s.slo_fast_window_s,
            slow_window_s=s.slo_slow_window_s,
            warn_burn=s.slo_warn_burn, page_burn=s.slo_page_burn,
            on_page=on_page)

    def _offer_trace(self, cost: "obs.JobCost") -> None:
        """Attributor → store handoff (runs on the finishing worker
        thread, outside the attributor lock): the completed cost record
        plus its spans still in the local tracer ring."""
        store = self.tracestore
        if store is None:
            return
        store.offer(cost, obs.default_tracer().spans())

    def _sample(self) -> dict:
        """One sampler tick's worth of live signals. ``*_total`` keys get
        ``*_per_s`` rate series derived by the sampler (sheds/sec, qps)."""
        vals: dict = {}
        counts = self.queue.counts()
        for state in ("pending", "inflight", "dead"):
            vals[f"queue_{state}"] = float(counts.get(state, 0))
        vals["worker_inflight"] = float(self.worker.inflight_count())
        for key, v in obs.BREAKER_GAUGE.collect().items():
            vals[f"breaker_{key[0]}"] = float(v)
        vals["sheds_total"] = sum(obs.SHED_COUNTER.collect().values())
        m = self.worker.metrics
        vals["requests_total"] = float(
            sum(m.latency.series_counts().values()))
        vals["failures_total"] = float(m.failure_events.count())
        vals.update(self.engine.live_stats())
        # Thread-liveness reconciliation: republishes vmt_thread_alive
        # for every guarded loop, so a crash-guarded death (or a silent
        # one) is visible in /healthz within one sampler cadence.
        vals.update(obs.watchdog().probe())
        # Scheduler plane (empty dict while the legacy loop runs): ready
        # depth, adaptive window, and *_total dispatch counters.
        vals.update(self.worker.scheduler_stats())
        # Result-cache plane: row/follower depths plus the three cache
        # counters (the sampler derives hit/miss/coalesce rates from the
        # *_total keys — the zipf soak's gates read those).
        if self.cache is not None:
            vals.update(self.cache.stats())
            vals["result_cache_hits_total"] = sum(
                obs.RESULT_CACHE_HITS.collect().values())
            vals["result_cache_misses_total"] = sum(
                obs.RESULT_CACHE_MISSES.collect().values())
            vals["coalesced_submits_total"] = sum(
                obs.COALESCED_SUBMITS.collect().values())
        # Per-tenant queueing delay (publish→claim p50), the deficit
        # scheduler's user-facing effect: a tenant throttled below its
        # weighted share queues longer, and that shows up HERE before it
        # shows up as sheds. Label sets merge across tasks per tenant.
        by_tenant: Dict[str, list] = {}
        for key in obs.QUEUE_WAIT.series_counts():
            task, tenant = key
            by_tenant.setdefault(tenant, []).extend(
                obs.QUEUE_WAIT.samples(task=task, tenant=tenant))
        for tenant, samples in by_tenant.items():
            p50 = obs.percentile(samples, 50.0)
            if p50 is not None:
                vals[f"queue_wait_p50_ms_tenant_{tenant}"] = float(p50)
        # Burn-rate states ride the same cadence, so PAGE transitions trip
        # the recorder even when nobody is scraping /debug/slo.
        worst = self.slos.worst_state()
        vals["slo_worst"] = float(
            {"ok": 0, "warn": 1, "page": 2}.get(worst, 0))
        # Autoscaler control step: sensors read the instruments the lines
        # above just refreshed (live_stats ran pool.probe), actions land
        # on the pool inline — no thread of its own. Isolated failure
        # domain: a raising actuator must not cost the tick.
        if self.autoscaler is not None:
            try:
                vals.update(self.autoscaler.tick())
            except Exception:  # noqa: BLE001
                _AUTOSCALE_TICK_ERRORS.inc()
        # Publish this tick to the fleet spine (heartbeat + instrument
        # snapshots + timeseries deltas + fresh spans). Isolated failure
        # domain: a locked/corrupt spine db must not cost the LOCAL tick.
        if self.fleet is not None:
            try:
                self.fleet.flush({"phase": self.boot_info.get("phase"),
                                  "slo_worst": worst})
            except Exception:  # noqa: BLE001
                _FLEET_FLUSH_ERRORS.inc()
        # Trace-store flush rides the same tick, isolated the same way.
        if self.tracestore is not None:
            try:
                self.tracestore.flush()
            except Exception:  # noqa: BLE001
                _TRACESTORE_FLUSH_ERRORS.inc()
        return vals

    def warm(self) -> None:
        """Capture every row bucket's CUDA graph (engine.warmup) and run the
        live detector once, if enabled (its kernels build and cuDNN plans
        its convolutions before the first upload, never in the worker
        thread); timings land in ``/healthz``. An un-warmed engine serves
        eagerly — debug only: every request then pays the host's launch
        cost."""
        prev_phase = self.boot_info.get("phase")
        self.boot_info["phase"] = "warming"
        t0 = time.perf_counter()
        with obs.span("serve.warmup",
                      buckets=list(self.cfg.engine.all_row_buckets())):
            self.engine.warmup()
            if self.extractor is not None:
                self.extractor.warmup()
                self.boot_info["detector_warm"] = True
        self.boot_info.update(
            warmup_s=round(time.perf_counter() - t0, 1),
            buckets=list(self.cfg.engine.all_row_buckets()),
            pallas=self.engine.pallas_enabled,
            kernel_fallback=self.engine.kernel_fallback,
        )
        self._refresh_boot_phases()
        # Warming before start() returns to "booting" (still not serving);
        # a live re-warm must not flip an already-ready replica out of the
        # load balancer.
        self.boot_info["phase"] = ("ready" if prev_phase == "ready"
                                   else "booting")

    def rolling_swap(self, checkpoint_path: Optional[str] = None,
                     params=None) -> dict:
        """Zero-downtime checkpoint swap across the replica pool.

        Loads the new tree once (host-side), then walks the pool's
        drain → load → ready sequence one replica at a time — at least one
        replica stays ready throughout (n >= 2), and since HTTP ingest only
        enqueues, no request observes the swap at all. Same-shape trees
        swap with ZERO recompiles (compiled programs take params as a call
        argument — engine.load_params copies into the captured weights in
        place). ``checkpoint_path`` is a checkpoint directory or an
        upstream ``.bin``/``.pth`` (:func:`..checkpoint.restore_params`),
        cast to the engine's ``param_dtype``, so an int8 deployment
        re-quantizes an incoming f32 checkpoint; ``params`` an
        upstream-layout state dict. On a mesh every rank loads its own
        shard: of ``checkpoint_path``, which each rank restores
        (``InferenceEngine.load_checkpoint``), or of ``params``, which rank
        0 broadcasts leaf by leaf (``InferenceEngine.broadcast_params``;
        the report's ``broadcast_bytes``). A load that fails on any rank
        fails the swap and leaves every rank on its old weights."""
        if params is None and checkpoint_path is None:
            raise ValueError("rolling_swap needs checkpoint_path or params")
        name = "<in-memory>" if params is not None else checkpoint_path
        if self.engine.mesh is not None:
            # One replica spans the ranks. It stays ready: the load takes
            # the engine's dispatch lock, so it waits for the forward in
            # flight, and a job claimed meanwhile runs after it, on the new
            # weights. A refused load leaves it serving the old ones.
            rep = self.engine.replicas[0]
            t0 = time.perf_counter()
            obs.record_event("rolling_swap_start", checkpoint=name)
            sent = 0
            if params is None:
                rep.engine.load_checkpoint(checkpoint_path)
            else:
                sent = rep.engine.broadcast_params(params)
            rep.swaps += 1
            report = {"replicas": [{"name": rep.name, "load_s": round(
                time.perf_counter() - t0, 3)}], "skipped": [],
                "min_ready_seen": self.engine.ready_count(),
                "broadcast_bytes": sent}
            return self._swapped(report, name, t0)
        if params is None:
            from vilbert_multitask_tpu_torch.checkpoint import restore_params

            params = restore_params(checkpoint_path,
                                    dtype=self.cfg.engine.param_dtype,
                                    cfg=self.cfg.model)
        t0 = time.perf_counter()
        obs.record_event("rolling_swap_start", checkpoint=name)
        report = self.engine.rolling_swap(
            lambda eng: eng.load_params(params))
        return self._swapped(report, name, t0)

    def _swapped(self, report: dict, checkpoint: str, t0: float) -> dict:
        """A finished swap's bookkeeping: its report, the model generation
        and the result cache."""
        report["total_s"] = round(time.perf_counter() - t0, 3)
        report["checkpoint"] = checkpoint
        # The swap changed what the model computes: bump the generation so
        # the cache-key fingerprint rotates, and drop every entry minted
        # under the old generation in one transaction. A post-swap replay
        # of a pre-swap request is therefore a MISS (fresh forward pass),
        # never a stale hit. In-flight leaders keep their follower rows —
        # their old-generation result still fans out, it just isn't cached.
        self.model_gen += 1
        if self.cache is not None:
            dropped = self.cache.invalidate(self._cache_fingerprint())
            obs.RESULT_CACHE_INVALIDATIONS.inc(dropped)
            report["cache_invalidated"] = dropped
        self.boot_info["last_swap"] = report
        return report

    def _cache_fingerprint(self) -> str:
        """Cache-key config component: the static config fingerprint plus
        the rolling-swap generation. Both a config change (across restarts)
        and a live swap (within one process) rotate every key."""
        return f"{self.fingerprint}:g{self.model_gen}"

    def _run_worker(self) -> None:
        """Thread entry for the in-process worker. The crash guard lives
        HERE, not in ``run_forever``: remote deployments call
        ``run_forever`` synchronously from their own main thread and must
        see exceptions, while this daemon thread's only observer is the
        watchdog."""
        with obs.crash_guard("serve-worker"):
            self.worker.run_forever(stop_event=self._stop)

    def start(self, worker: bool = True) -> None:
        """Boot the tiers; ``worker=False`` serves HTTP/ws only (an external
        worker — serve/remote.py, or the chaos soak's scripted one — drains
        the queue instead)."""
        # Fleet-inventory identity: which build/config this replica is.
        from vilbert_multitask_tpu_torch import __version__

        backend = "cpu"
        for rep in getattr(self.engine, "replicas", []):
            backend = getattr(getattr(rep.engine, "device", None), "type",
                              backend)

        obs.REGISTRY.gauge(
            "vmt_build_info",
            "Build/config identity labels (value is always 1).",
            labelnames=("version", "backend", "param_dtype",
                        "config_fingerprint"),
        ).set(1, version=__version__, backend=backend,
              param_dtype=self.cfg.engine.param_dtype,
              config_fingerprint=self.fingerprint)
        self.boot_info["config_fingerprint"] = self.fingerprint
        self.boot_info["identity"] = self.identity.as_dict()
        # Process-identity stamping: every exposition sample gains
        # instance/role labels (merged at render time, so instrument
        # schemas and observe calls are untouched), and every span gains
        # matching attrs — the fleet merge's join keys. stop() clears
        # both (the registry/tracer are process globals).
        obs.REGISTRY.set_default_labels(**self.identity.labels())
        obs.default_tracer().set_default_attrs(
            instance=self.identity.ident, role=self.identity.role)
        # The flight recorder goes live before any tier can trip it.
        obs.install_recorder(self.recorder)
        # Same discipline for cost attribution: the module-plane helper
        # sites in worker/scheduler become live before the first claim.
        if self.attrib is not None:
            obs.set_attributor(self.attrib)
        # Websocket first: /config must never advertise an unbound ws port
        # (the browser caches it and would reconnect to ws://host:0 forever).
        self.ws.start()
        self.api.ws_port = self.ws.bound_port
        self.http_port = self.api.start()
        # Replicas still 'booting' here were never warmed (--no-warmup /
        # test boots): admit them as ready, compile-at-request.
        self.engine.mark_ready()
        if worker:
            self._worker_thread = threading.Thread(
                target=self._run_worker,
                daemon=True, name="serve-worker")
            self._worker_thread.start()
        self.sampler.start()
        self.boot_info["phase"] = "ready"
        # First heartbeat immediately: peers must see this process in
        # ?scope=fleet without waiting out a sampler cadence.
        if self.fleet is not None:
            try:
                self.fleet.flush({"phase": "ready"})
            except Exception:  # noqa: BLE001
                _FLEET_FLUSH_ERRORS.inc()

    def stop(self) -> None:
        """Graceful drain: signal the worker to stop CLAIMING, give it
        ``drain_grace_s`` to finish jobs in hand, then release anything
        still claimed back to pending (terminal "requeued" push, no
        delivery attempt charged) before tearing the web tiers down."""
        # Snapshot the pre-drain state while the queues/inflight are still
        # interesting (a SIGTERM during an incident is the bundle you want).
        obs.record_event("drain", phase=self.boot_info.get("phase"),
                         inflight=self.worker.inflight_count())
        self.boot_info["phase"] = "draining"
        self._stop.set()
        if self._worker_thread:
            self._worker_thread.join(timeout=self.cfg.serving.drain_grace_s)
        # After the join (clean or timed out): anything still tracked as
        # in-flight goes back to the queue for the next worker. A clean
        # drain finds the set empty — at-least-once makes this idempotent.
        self.worker.abandon_inflight()
        self.api.stop()
        self.ws.stop()
        self.sampler.stop()
        # Withdraw from the fleet (heartbeat/instruments/timeseries rows;
        # spans stay stitchable) and un-stamp the process-global registry
        # and tracer — other apps in this process must not inherit a dead
        # incarnation's identity labels.
        if self.fleet is not None:
            try:
                self.fleet.retire()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                _FLEET_FLUSH_ERRORS.inc()
        # Final trace-store flush (keeps buffered since the last tick must
        # survive the shutdown), then detach the module-plane attributor —
        # but only OUR OWN installation, like the recorder below.
        if self.tracestore is not None:
            try:
                self.tracestore.flush()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                _TRACESTORE_FLUSH_ERRORS.inc()
        if self.attrib is not None and obs.get_attributor() is self.attrib:
            obs.set_attributor(None)
        obs.REGISTRY.set_default_labels()
        obs.default_tracer().set_default_attrs()
        # Uninstall only our own recorder (another app may have replaced
        # it); close() drains queued triggers and joins the writer thread.
        if obs.active_recorder() is self.recorder:
            obs.clear_recorder()
        else:
            self.recorder.close()
        # A mesh engine's other ranks follow rank 0's dispatches: end them.
        for rep in getattr(self.engine, "replicas", []):
            stop = getattr(rep.engine, "stop_followers", None)
            if stop is not None:
                stop()


def _kernel_cache(cfg: FrameworkConfig, live_extract: bool, device):
    """The boot's :class:`..engine.aotcache.AotCache` over
    ``cfg.engine.aot_cache_dir`` on the card; None on the CPU, and where
    the card asked for is missing (the engine then refuses to start)."""
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None
    from vilbert_multitask_tpu_torch.engine.aotcache import (
        AotCache,
        compile_fingerprint,
    )

    return AotCache(cfg.engine.aot_cache_dir,
                    compile_fingerprint(cfg, live_extract=live_extract))


def _join_kernel_cache(aot, boot_info: dict) -> Dict[str, float]:
    """Wait for the boot's library builds and load them (a failed build
    raises: no kernel, no server); the boot phases they take."""
    if aot is None:
        return {"cache_load_s": 0.0, "compile_s": 0.0}
    built = aot.join()
    boot_info["aot_cache"] = {
        "dir": aot.root, "misses": built["misses"],
        "libraries": {n: {"status": r["status"],
                          "seconds": round(r["seconds"], 3)}
                      for n, r in built["libraries"].items()}}
    return {"cache_load_s": built["cache_load_s"],
            "compile_s": built["compile_s"], "nvcc_s": built["compile_s"]}


def mesh_of_world(cfg: FrameworkConfig):
    """The process mesh of ``cfg.mesh`` when this process is one rank of a
    world of several (the launcher's), else None (one device)."""
    from vilbert_multitask_tpu_torch.parallel import build_mesh, distributed

    if distributed.world_size() > 1:
        return build_mesh(cfg.mesh)
    return None


def follow_rank(cfg: FrameworkConfig, *, checkpoint_path: Optional[str] = None,
                device: str = "cuda") -> None:
    """A rank other than 0 of a serving launch: build the mesh (as rank 0's
    ``ServeApp`` does), restore this rank's shard, build the mesh engine
    and run rank 0's dispatches until it stops."""
    mesh = mesh_of_world(cfg)
    params = None
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, aot_cache_dir=default_cache_dir(cfg, checkpoint_path)))
    aot = _kernel_cache(cfg, False, device)
    if aot is not None:
        aot.prefetch()
    if checkpoint_path is not None:
        from vilbert_multitask_tpu_torch.checkpoint import restore_params

        params = restore_params(checkpoint_path,
                                dtype=cfg.engine.param_dtype,
                                cfg=cfg.model, mesh=mesh)
    _join_kernel_cache(aot, {})
    InferenceEngine(cfg, params=params, mesh=mesh, device=device).follow()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="ViLBERT multi-task server (PyTorch/CUDA port)")
    p.add_argument("--features", default="features",
                   help="precomputed region-feature directory (.npy/.vlfr)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine runs (cuda raises without a card)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip capturing the per-bucket CUDA graphs at boot "
                        "(requests then run eagerly, paying the host's "
                        "launch cost; debug only)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model and detector configs (rehearsals and "
                        "tests; features must be 32-wide)")
    p.add_argument("--http-port", type=int, default=None,
                   help="HTTP port (default ServingConfig.http_port; 0 = "
                        "any free port)")
    p.add_argument("--ws-port", type=int, default=None,
                   help="websocket port (default ServingConfig.ws_port)")
    p.add_argument("--checkpoint", default=None,
                   help="the trunk's weights: a checkpoint directory "
                        "of this package or the reference's "
                        "pytorch_model_*.bin (upstream torch layout); "
                        "omitting it serves SEEDED RANDOM weights")
    p.add_argument("--live-extract", action="store_true",
                   help="run the Faster R-CNN on uploads with no "
                        "precomputed features (detect/); seeded random "
                        "weights unless --detector-checkpoint is given")
    p.add_argument("--detector-checkpoint", default=None,
                   help="maskrcnn_benchmark detector checkpoint (.pth, "
                        "torch layout) for --live-extract")
    p.add_argument("--mesh", default=None, metavar="DP,TP[,SP]",
                   help="the process mesh of a launch of several ranks "
                        "(python -m vilbert_multitask_tpu_torch.parallel."
                        "launch --nproc N --backend gloo|nccl -- "
                        "vilbert_multitask_tpu_torch.serve.app ...); "
                        "default: dp over every rank")
    args = p.parse_args(argv)

    from vilbert_multitask_tpu_torch.parallel import distributed
    from vilbert_multitask_tpu_torch.parallel.mesh import parse_mesh

    cfg = FrameworkConfig()
    if args.tiny:
        cfg = dataclasses.replace(cfg, model=cfg.model.tiny())
    if args.mesh:
        cfg = dataclasses.replace(cfg, mesh=parse_mesh(args.mesh))
    # One rank of a launch (its variables set): join the world first.
    distributed.initialize(device=args.device)
    if distributed.rank() != 0:
        follow_rank(cfg, checkpoint_path=args.checkpoint, device=args.device)
        distributed.shutdown()
        return
    ports = {k: v for k, v in (("http_port", args.http_port),
                               ("ws_port", args.ws_port)) if v is not None}
    cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, **ports))
    app = ServeApp(cfg, feature_root=args.features, device=args.device,
                   checkpoint_path=args.checkpoint,
                   live_extract=args.live_extract,
                   detector_checkpoint=args.detector_checkpoint,
                   detector=DetectorConfig().tiny() if args.tiny else None)
    if args.checkpoint is None:
        print("WARNING: no --checkpoint given; serving seeded random "
              "weights (answers will be meaningless)")
    if not args.no_warmup:
        print("capturing bucket graphs...")
        app.warm()
        print(f"boot: {app.boot_info}")
    app.start()
    s = app.cfg.serving
    print(f"http://{s.http_host}:{app.http_port}  "
          f"ws://{s.http_host}:{app.ws.bound_port}  queue={s.queue_db_path}")
    # Graceful drain on SIGTERM (the orchestrator's stop signal): stop
    # claiming, finish in-flight within drain_grace_s, release the rest
    # with a terminal push, exit 0. Ctrl-C takes the same path.
    import signal

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    print(f"draining (grace {s.drain_grace_s:.0f}s)...")
    app.stop()
    distributed.shutdown()


if __name__ == "__main__":
    main()
