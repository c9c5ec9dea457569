"""Process-wide observability: span tracing, instruments, exporters.

Three pillars (see ARCHITECTURE.md "Observability"):

- ``obs.span("engine.forward", task_id=...)`` — monotonic-clocked spans
  with thread-local parenting and cross-queue trace-id resumption
  (:mod:`vilbert_multitask_tpu_torch.obs.trace`);
- ``obs.REGISTRY`` — counters / gauges / log-bucket histograms, plus the
  one shared :func:`percentile` used by serve, bench, and the soak
  (:mod:`vilbert_multitask_tpu_torch.obs.instruments`);
- Prometheus text exposition, Chrome-trace JSON, and ``torch.profiler``
  toggles (:mod:`vilbert_multitask_tpu_torch.obs.export`).

Importing the package wires the default tracer's observer to feed every
completed span into the ``vmt_span_ms{name,task}`` histogram, which is
what ``GET /metrics?format=prometheus`` serves as per-task stage
latencies.
"""

from __future__ import annotations

from vilbert_multitask_tpu_torch.obs.trace import (
    Span,
    Tracer,
    current_trace_id,
    default_tracer,
    new_trace_id,
    span,
    trace_scope,
)
from vilbert_multitask_tpu_torch.obs.instruments import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    REGISTRY,
    log_buckets,
    percentile,
)
from vilbert_multitask_tpu_torch.obs.export import (
    OPENMETRICS_CONTENT_TYPE,
    PROMETHEUS_CONTENT_TYPE,
    chrome_trace,
    dump_trace,
    render_openmetrics,
    render_prometheus,
    start_profile,
    stop_profile,
)
from vilbert_multitask_tpu_torch.obs.attrib import (
    STAGES as COST_STAGES,
    CostAttributor,
    JobCost,
    get_attributor,
    job_batch,
    job_begin,
    job_charge,
    job_finish,
    set_attributor,
)
from vilbert_multitask_tpu_torch.obs.tracestore import TraceStore
from vilbert_multitask_tpu_torch.obs.timeseries import (
    SAMPLER_THREAD_NAME,
    Sampler,
    TimeSeriesStore,
)
from vilbert_multitask_tpu_torch.obs.recorder import (
    RECORDER_THREAD_NAME,
    FlightRecorder,
    active_recorder,
    clear_recorder,
    install_recorder,
    record_event,
    record_spike,
)
from vilbert_multitask_tpu_torch.obs.watchdog import (
    THREAD_ALIVE_GAUGE,
    ThreadWatchdog,
    crash_guard,
    watchdog,
)
from vilbert_multitask_tpu_torch.obs.slo import (
    STATE_OK,
    STATE_PAGE,
    STATE_WARN,
    Slo,
    SloEvaluator,
    availability_slo,
    latency_slo,
    slack_floor_slo,
)
from vilbert_multitask_tpu_torch.obs.identity import (
    WorkerIdentity,
    mint_identity,
    process_identity,
    reset_process_identity,
)
from vilbert_multitask_tpu_torch.obs.fleet import (
    FleetSpine,
    default_spine_path,
)
from vilbert_multitask_tpu_torch.obs.ledger import (
    append_entry as ledger_append,
    check as ledger_check,
    default_ledger_path,
    read_entries as ledger_entries,
)

__all__ = [
    "Span", "Tracer", "current_trace_id", "default_tracer", "new_trace_id",
    "span", "trace_scope",
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "log_buckets", "percentile",
    "OPENMETRICS_CONTENT_TYPE", "PROMETHEUS_CONTENT_TYPE", "chrome_trace",
    "dump_trace", "render_openmetrics", "render_prometheus",
    "start_profile", "stop_profile",
    "COST_STAGES", "CostAttributor", "JobCost", "TraceStore",
    "get_attributor", "job_batch", "job_begin", "job_charge", "job_finish",
    "set_attributor",
    "SHED_COUNTER", "RETRY_COUNTER", "BREAKER_GAUGE", "DEADLINE_SLACK",
    "BATCH_FILL", "SCHED_WAIT", "QUEUE_WAIT", "BATCHES_DISPATCHED",
    "REPLICA_STATE", "FAILOVER_COUNTER", "POISON_COUNTER",
    "RESULT_CACHE_HITS", "RESULT_CACHE_MISSES",
    "RESULT_CACHE_INVALIDATIONS", "COALESCED_SUBMITS", "TENANT_DEFICIT",
    "SAMPLER_THREAD_NAME", "Sampler", "TimeSeriesStore",
    "RECORDER_THREAD_NAME", "FlightRecorder", "active_recorder",
    "clear_recorder", "install_recorder", "record_event", "record_spike",
    "THREAD_ALIVE_GAUGE", "ThreadWatchdog", "crash_guard", "watchdog",
    "STATE_OK", "STATE_PAGE", "STATE_WARN", "Slo", "SloEvaluator",
    "availability_slo", "latency_slo", "slack_floor_slo",
    "WorkerIdentity", "mint_identity", "process_identity",
    "reset_process_identity",
    "FleetSpine", "default_spine_path",
    "ledger_append", "ledger_check", "ledger_entries",
    "default_ledger_path",
]

SPAN_HISTOGRAM = REGISTRY.histogram(
    "vmt_span_ms",
    "Span durations by span name and task (ms).",
    labelnames=("name", "task"),
)

# Resilience instruments (resilience/ policy plane). Defined here so the
# policy module stays import-light and every exporter sees them.
SHED_COUNTER = REGISTRY.counter(
    "vmt_shed_total",
    "Requests/jobs shed before doing work, by reason "
    "(queue_depth, queue_age, deadline).",
    labelnames=("reason",),
)
RETRY_COUNTER = REGISTRY.counter(
    "vmt_retries_total",
    "Retry attempts actually slept for, by call site.",
    labelnames=("site",),
)
BREAKER_GAUGE = REGISTRY.gauge(
    "vmt_breaker_state",
    "Circuit-breaker state: 0 closed, 1 half-open, 2 open.",
    labelnames=("breaker",),
)
DEADLINE_SLACK = REGISTRY.histogram(
    "vmt_deadline_slack_ms",
    "Remaining deadline budget when the worker picked the job up (ms).",
    labelnames=("task",),
)

# Continuous-batching scheduler instruments (serve/scheduler.py).
BATCH_FILL = REGISTRY.histogram(
    "vmt_batch_fill",
    "Dispatched-chunk occupancy as a fraction of its row bucket (1.0 = "
    "the bucket was full; lower = padded rows burned).",
    labelnames=("bucket",),
    buckets=tuple(i / 16 for i in range(1, 17)),
)
SCHED_WAIT = REGISTRY.histogram(
    "vmt_sched_wait_ms",
    "Time a ready (claimed + prepped) job waited in the scheduler's "
    "ready-queue before its batch fired (ms).",
)
QUEUE_WAIT = REGISTRY.histogram(
    "vmt_queue_wait_ms",
    "Publish-to-claim latency (ms): POST / stamp to worker claim, the "
    "queueing delay Metrics.record's intake-anchored e2e cannot see. "
    "The tenant label is the deficit scheduler's user-facing effect: a "
    "tenant throttled below its weighted share queues longer, visibly.",
    labelnames=("task", "tenant"),
)
BATCHES_DISPATCHED = REGISTRY.counter(
    "vmt_batches_dispatched_total",
    "Device chunks dispatched by the continuous-batching scheduler.",
)

# Replica-pool instruments (serve/pool.py).
REPLICA_STATE = REGISTRY.gauge(
    "vmt_replica_state",
    "Replica health state: 0 booting, 1 warming, 2 ready, 3 degraded, "
    "4 draining, 5 dead.",
    labelnames=("replica",),
)
FAILOVER_COUNTER = REGISTRY.counter(
    "vmt_failovers_total",
    "In-flight jobs released back to the queue because their replica "
    "died or tripped its breaker mid-dispatch.",
    labelnames=("replica",),
)
POISON_COUNTER = REGISTRY.counter(
    "vmt_poison_jobs_total",
    "Jobs dead-lettered by the queue after exhausting queue_max_deliveries "
    "total deliveries (poison-job quarantine).",
)

# Duplicate-traffic tier instruments (serve/resultcache.py + scheduler).
RESULT_CACHE_HITS = REGISTRY.counter(
    "vmt_result_cache_hits_total",
    "Submits answered from the durable result cache — no queue publish, "
    "no device forward.",
)
RESULT_CACHE_MISSES = REGISTRY.counter(
    "vmt_result_cache_misses_total",
    "Submits that missed the result cache and published a real job "
    "(the submit became the singleflight leader).",
)
RESULT_CACHE_INVALIDATIONS = REGISTRY.counter(
    "vmt_result_cache_invalidations_total",
    "Cache rows dropped because a rolling swap changed the config "
    "fingerprint / model generation.",
)
COALESCED_SUBMITS = REGISTRY.counter(
    "vmt_coalesced_submits_total",
    "Submits attached as followers to an identical in-flight job "
    "(singleflight): they pay one shared forward instead of N.",
)
TENANT_DEFICIT = REGISTRY.gauge(
    "vmt_tenant_deficit",
    "Weighted-deficit scheduler credit per tenant (rows); persistently "
    "negative means the tenant is consuming above its weighted share.",
    labelnames=("tenant",),
)


def _observe_span(s: Span) -> None:
    SPAN_HISTOGRAM.observe(
        s.dur_s * 1e3, name=s.name, task=str(s.attrs.get("task_id", "")))


default_tracer().set_observer(_observe_span)
