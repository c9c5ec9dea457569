"""The port's typed config tree (a copy of the JAX package's config.py).

Field names are the JAX package's own (``vilbert_multitask_tpu/config.py``),
so one config JSON or one ``dataclasses.asdict`` dump feeds both packages:

- :class:`ViLBertConfig`   — the model (mirrors config/bert_base_6layer_6conect.json
  plus the overrides applied at reference worker.py:509-522).
- :class:`TaskSpec` / :data:`TASK_REGISTRY` — the served task types.
- :class:`EngineConfig`    — the inference-engine fields this package reads.
- :class:`MeshConfig`      — the dp×tp(×sp) process mesh (parallel/).
- :class:`ServingConfig`   — the web/queue tier (a full copy).
- :class:`FrameworkConfig` — the root aggregate; :meth:`FrameworkConfig.from_dict`
  takes a JAX-package config dump and ignores the fields this package lacks.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class ViLBertConfig:
    """Two-stream ViLBERT architecture knobs.

    Field names follow the reference config JSON (``bert_base_6layer_6conect.json``,
    loaded at reference worker.py:472,495) so checkpoints and configs translate
    1:1. Defaults are the values the reference demo actually serves with,
    including the runtime overrides at worker.py:509-523 (``v_target_size=1601``,
    ``predict_feature=False``, ``task_specific_tokens=True``,
    ``visualization=True``, ``num_labels=3129``).
    """

    # --- text stream (BERT-base) ---
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    # --- visual stream ---
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 8
    v_intermediate_size: int = 1024
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_attention_probs_dropout_prob: float = 0.1
    v_initializer_range: float = 0.02

    # --- co-attention bridge ---
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 8
    bi_intermediate_size: int = 1024
    # Text layer i in t_biattention_id co-attends with visual layer j at the
    # same position in v_biattention_id ("6 connect" in the config name).
    v_biattention_id: Sequence[int] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Sequence[int] = (6, 7, 8, 9, 10, 11)
    fusion_method: str = "mul"  # pooled_t ∘ pooled_v fusion for vil_* heads

    # --- behavior flags (reference worker.py:509-523) ---
    predict_feature: bool = False
    task_specific_tokens: bool = True
    num_task_tokens: int = 20  # task-token embedding table size
    dynamic_attention: bool = False
    visualization: bool = True  # return per-layer attention maps (10th output)
    # Run the co-attention bridges through the flash attention kernel
    # (ops/coattention.py, csrc/flash_attn.cu). Off when attention maps are
    # requested — the blockwise kernel never materializes probabilities.
    # The field names are the JAX package's, so one config feeds both.
    use_pallas_coattention: bool = False
    # Same kernel for the single-stream self-attention; a stream only takes
    # the kernel path when its head_dim is a multiple of 128 (the 1024/8
    # visual stream is; BERT-base text's 64 is not and stays dense).
    use_pallas_self_attention: bool = False
    # Training: recompute each encoder layer and bridge in the backward pass
    # instead of keeping its activations (torch.utils.checkpoint per layer,
    # models/encoder.py; the JAX package's nn.remat). Serving runs without
    # gradients and is unaffected.
    remat: bool = False

    # --- heads ---
    num_labels: int = 3129  # VQA answer space (worker.py:523)
    gqa_num_labels: int = 1533  # GQA answer space (12-in-1 head width)

    def __post_init__(self):
        if len(self.v_biattention_id) != len(self.t_biattention_id):
            raise ValueError("v_biattention_id and t_biattention_id must pair up")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide num_attention_heads")
        if self.v_hidden_size % self.v_num_attention_heads:
            raise ValueError("v_hidden_size must divide v_num_attention_heads")
        if self.bi_hidden_size % self.bi_num_attention_heads:
            raise ValueError("bi_hidden_size must divide bi_num_attention_heads")

    @property
    def num_connection_layers(self) -> int:
        return len(self.v_biattention_id)

    @classmethod
    def from_json_file(cls, path: str) -> "ViLBertConfig":
        """Load a reference-format config JSON (ignores unknown keys)."""
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["v_biattention_id"] = list(self.v_biattention_id)
        d["t_biattention_id"] = list(self.t_biattention_id)
        return json.dumps(d, indent=2, sort_keys=True)

    def tiny(self, **overrides) -> "ViLBertConfig":
        """A scaled-down config for CPU tests (same topology, small dims)."""
        small = dict(
            # >= the committed assets/wordpiece_vocab.txt size, so tiny
            # models accept ids from the default serving tokenizer.
            vocab_size=1088,
            hidden_size=48,
            num_hidden_layers=4,
            num_attention_heads=4,
            intermediate_size=64,
            max_position_embeddings=64,
            v_feature_size=32,
            v_target_size=11,
            v_hidden_size=32,
            v_num_hidden_layers=2,
            v_num_attention_heads=2,
            v_intermediate_size=32,
            bi_hidden_size=32,
            bi_num_attention_heads=2,
            bi_intermediate_size=32,
            v_biattention_id=(0, 1),
            t_biattention_id=(2, 3),
            num_labels=17,
            gqa_num_labels=13,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One served task type (reference: UI dropdown result.html:318-336 +
    worker dispatch worker.py:250-263,295-386)."""

    task_id: int
    name: str
    head: str  # which model output decodes this task
    decode: str  # decode family: "labels" | "binary" | "trinary" | "ranking" | "grounding"
    min_images: int
    max_images: int
    top_k: int  # how many ranked answers the demo shows
    label_map: str | None = None  # key into the label-map store, if any
    description: str = ""
    placeholder: str = ""

    def validate_num_images(self, n: int) -> None:
        """Image-count gating, matching the asserts at worker.py:256-263."""
        if not (self.min_images <= n <= self.max_images):
            raise ValueError(
                f"task {self.task_id} ({self.name}) requires "
                f"{self.min_images}..{self.max_images} images, got {n}"
            )


# The 8 served task types. task_id values are the reference's wire protocol —
# they appear in queue messages (demo/sender.py:26-31) and the UI (result.html:318-336).
TASK_REGISTRY: Mapping[int, TaskSpec] = {
    t.task_id: t
    for t in [
        TaskSpec(1, "VQA", head="vil_prediction", decode="labels", min_images=1,
                 max_images=1, top_k=3, label_map="vqa",
                 description="Visual question answering (VQAv2)",
                 placeholder="e.g. What is the man holding?"),
        TaskSpec(2, "VQA-variant", head="vil_prediction", decode="labels", min_images=1,
                 max_images=1, top_k=3, label_map="vqa",
                 description="Alias of VQA; decodable but absent from the reference UI "
                             "(worker.py:295,564 vs result.html:318-336)"),
        TaskSpec(15, "GQA", head="vil_prediction_gqa", decode="labels", min_images=1,
                 max_images=1, top_k=3, label_map="gqa",
                 description="Spatial-reasoning QA (GQA)",
                 placeholder="e.g. Is the bowl to the right of the mug?"),
        TaskSpec(4, "Visual7W", head="vision_logit", decode="grounding", min_images=1,
                 max_images=1, top_k=3,
                 description="Pointing QA — answer is a box",
                 placeholder="e.g. Which object can you eat?"),
        TaskSpec(11, "RefCOCO", head="vision_logit", decode="grounding", min_images=1,
                 max_images=1, top_k=3,
                 description="Referring-expression grounding",
                 placeholder="e.g. the woman in the red coat"),
        TaskSpec(16, "GuessWhat", head="vision_logit", decode="grounding", min_images=1,
                 max_images=1, top_k=3,
                 description="Referring dialog grounding (Q:..? A:.. format)",
                 placeholder="e.g. Q: is it a person? A: no Q: is it red? A: yes"),
        TaskSpec(13, "SNLI-VE", head="vil_tri_prediction", decode="trinary", min_images=1,
                 max_images=1, top_k=3,
                 description="Visual entailment: contradiction/neutral/entailment",
                 placeholder="e.g. Two dogs are playing in the snow."),
        TaskSpec(12, "NLVR2", head="vil_binary_prediction", decode="binary", min_images=2,
                 max_images=2, top_k=2,
                 description="Does the caption describe the image pair? True/False",
                 placeholder="e.g. Both images contain exactly two wolves."),
        TaskSpec(7, "Retrieval", head="vil_logit", decode="ranking", min_images=2,
                 max_images=10, top_k=0,  # top_k=#images, resolved at decode time
                 description="Caption-based image retrieval over the uploaded set",
                 placeholder="e.g. A man riding a horse on the beach."),
    ]
}

# Decode label maps that are fixed (not loaded from disk).
NLVR2_LABELS = ("False", "True")  # worker.py:327
SNLI_VE_LABELS = ("contradiction (false)", "neutral", "entailment (true)")  # worker.py:342


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The inference-engine fields the port reads (a subset of the JAX
    package's EngineConfig, same names and defaults). Left out: the knobs
    only JAX reads (the XLA compilation cache and ``parallel_warmup``)."""

    max_text_len: int = 37  # wordpiece tokens incl. [CLS]/[SEP] (worker.py:408)
    max_regions: int = 101  # 100 detector boxes + 1 global feature (worker.py:71,433)
    num_features: int = 100  # detector boxes kept per image (worker.py:71)
    # Shape buckets for the image axis: NLVR2 needs 2, retrieval 2..10
    # (worker.py:256-284).
    image_buckets: Sequence[int] = (1, 2, 4, 8, 10)
    # Row buckets used only by run_many's chunking (the queue-backlog
    # batched path): a packed chunk of single-image requests is not bound
    # by the 10-image retrieval cap, and the intermediate 16 keeps 11-31
    # row batches off the 32-row padding cliff. None/() → chunk at
    # max(image_buckets).
    throughput_buckets: Sequence[int] | None = (16, 32)
    compute_dtype: str = "bfloat16"
    # Storage of the served weights: a floating dtype or "int8". A floating
    # value keeps Linear/Embedding weights in the compute dtype and
    # LayerNorm parameters in f32 (the engine casts once at load). "int8"
    # stores every matrix as a per-channel {"int8", "scale"} pair (quant.py;
    # checkpoints are quantized host-side at restore) and every Linear runs
    # the int8 GEMM (ops/int8_linear.py), which dequantizes inside the
    # product; the fused head slabs are int8 too.
    param_dtype: str = "float32"
    # Run the nine per-task decode heads as ONE batched program (stacked
    # weight slabs + a per-row gather by task id) instead of nine small
    # matmuls. Off → the per-head module path, which the tests hold it to.
    fused_task_heads: bool = True
    # The engine forces these onto the model config: serving runs the flash
    # attention kernel for every eligible attention (see ViLBertConfig).
    use_pallas_coattention: bool = True
    use_pallas_self_attention: bool = True
    # Region-count threshold for sequence-parallel ring attention on the
    # visual stream (parallel/ring.py): on a mesh with an "sp" axis
    # (MeshConfig.sp > 1), a bucket whose region count reaches it and
    # divides by sp routes the visual self-attention through the ring;
    # below it the dense path (or the flash kernel) runs.
    ring_min_regions: int = 256
    # Text/label assets. None → the committed copies in this package's assets/.
    vocab_path: str | None = None
    labels_root: str | None = None
    # Device input cache (LRU entries): store-backed images are
    # content-stable, so their encoded region rows stay in the engine's
    # device row slab after first use instead of being re-uploaded (~0.41
    # MB per image in bf16). 0 disables. Keys are explicit
    # (prepare(cache_keys=...), set by prepare_from_store). 64 entries ≈
    # 26 MB of bf16 features.
    device_input_cache_entries: int = 64
    # Where the kernel libraries are built and looked up (engine/
    # aotcache.py; a prewarm step fills it ahead of a boot). None: the
    # package's _build/ for an engine; next to the checkpoint, else under
    # serve_state/, for a server (the JAX app's rule).
    aot_cache_dir: str | None = None

    def bucket_for(self, n_images: int) -> int:
        for b in self.image_buckets:
            if n_images <= b:
                return b
        raise ValueError(f"no shape bucket holds {n_images} images")

    def all_row_buckets(self) -> list:
        """Every row count serving can dispatch: the image buckets (run())
        plus the throughput buckets (run_many), sorted. The one source for
        warmup coverage (one CUDA graph each) and chunk-fitting."""
        return sorted({*self.image_buckets,
                       *(self.throughput_buckets or ())})

    def row_bucket_for(self, n_rows: int) -> int:
        """Smallest dispatchable row count that fits a run_many chunk
        (batched rows are independent single-image requests, so the
        image-axis semantics of bucket_for don't constrain them)."""
        if n_rows < 1:
            raise ValueError(f"row count must be >=1, got {n_rows}")
        for b in self.all_row_buckets():
            if n_rows <= b:
                return b
        raise ValueError(f"no row bucket holds {n_rows} rows")

    def max_batch_rows(self) -> int:
        """Largest dispatchable row count — run_many's chunk size and the
        natural drain depth for a backlogged worker."""
        return max(max(self.image_buckets),
                   *(self.throughput_buckets or (0,)))


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Faster R-CNN region-feature extractor (detect/model.py).

    Defaults mirror the reference's X-152-32x8d-FPN geometry
    (maskrcnn_benchmark driven from reference worker.py:59-89): ResNeXt
    bottleneck stages (3, 8, 36, 3) with 32 groups × width 8, a 256-channel
    FPN, class-agnostic proposals, fc6 2048-d region features, 1601 VG
    classes. ``tiny()`` scales the same topology down for CPU tests.
    The serving default remains precomputed features; live extraction
    serves novel uploads.
    """

    # --- backbone (ResNeXt) ---
    stem_channels: int = 64
    stage_blocks: Sequence[int] = (3, 8, 36, 3)  # X-152
    groups: int = 32
    width_per_group: int = 8
    stage_channels: Sequence[int] = (256, 512, 1024, 2048)
    # --- FPN ---
    fpn_channels: int = 256
    # --- RPN ---
    anchor_sizes: Sequence[int] = (32, 64, 128, 256, 512)  # per level P2..P6
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0)
    rpn_pre_nms_top_n: int = 1000
    rpn_post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    # --- ROI box head ---
    roi_resolution: int = 7
    roi_sampling: int = 2
    representation_size: int = 2048  # fc6/fc7 width → the ViLBERT v_feature
    num_classes: int = 1601  # VG classes incl. background col 0
    # --- input canvas (one fixed size) ---
    canvas: int = 1344  # fits short-side-800/long-side-1333 preprocessing

    def tiny(self, **overrides) -> "DetectorConfig":
        small = dict(
            stem_channels=8, stage_blocks=(1, 1, 1, 1), groups=2,
            width_per_group=4, stage_channels=(16, 32, 64, 128),
            fpn_channels=16, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32,
            roi_resolution=3, roi_sampling=2, representation_size=32,
            num_classes=7, canvas=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Web/queue tier (replaces Django settings + demo/constants.py +
    sender/worker pika constants). A copy of the JAX package's
    ServingConfig: same fields, same defaults."""

    queue_name: str = "vilbert_multitask_queue"  # wire-compatible (sender.py:18)
    queue_db_path: str = "serve_state/queue.sqlite3"
    results_db_path: str = "serve_state/results.sqlite3"
    media_root: str = "media"
    refer_expr_dir: str = "refer_expressions_task"  # worker.py:600
    http_host: str = "127.0.0.1"
    http_port: int = 8400
    ws_port: int = 8401
    max_upload_images: int = 10
    max_delivery_attempts: int = 3  # poison-message bound (fixes worker.py:650-655)
    lowercase_questions: bool = True  # reference lowercases server-side (views.py:27)
    # Shared secret for the /worker/* endpoints (remote workers, serve/remote.py).
    # None → open, matching the reference broker's default-credentials posture
    # (sender.py:12-15); set it when workers cross host boundaries.
    worker_token: str | None = None
    # Shared secret for the ADMIN WRITE surface (POST /admin/*). The
    # reference's Django admin is login-gated (demo/admin.py); here edits
    # mutate the persistent task catalog, so when set, writes require
    # ``Authorization: Bearer <token>`` (admin.html prompts for it).
    # None → open — acceptable only on the loopback default bind.
    admin_token: str | None = None
    # --- resilience/ knobs (see ARCHITECTURE.md "Resilience") ---
    # Time budget minted at POST / and carried in the job body; the worker
    # and engine terminate expired jobs with a terminal push instead of
    # dispatching a forward. None disables deadlines; a per-request
    # "deadline_s" in the submit payload overrides the default.
    default_deadline_s: float | None = 300.0
    # Admission control at the HTTP door: shed with 429 + Retry-After when
    # pending+inflight depth, or the oldest pending job's age, crosses a
    # threshold (0 disables that signal).
    admission_max_queue_depth: int = 512
    admission_max_queue_age_s: float = 120.0
    admission_retry_after_s: float = 2.0
    # Shared RetryPolicy shape for the remote-worker transport (full
    # jitter; the per-process RetryBudget bounds total retry volume).
    retry_max_attempts: int = 5
    retry_base_delay_s: float = 0.5
    retry_max_delay_s: float = 30.0
    # CircuitBreaker over the remote transport: trip after
    # breaker_failure_threshold failures within breaker_window_s, probe
    # again after breaker_reset_timeout_s.
    breaker_failure_threshold: int = 5
    breaker_window_s: float = 30.0
    breaker_reset_timeout_s: float = 10.0
    # Graceful drain: how long stop() waits for the worker to finish
    # in-flight jobs before releasing them back to the queue.
    drain_grace_s: float = 10.0
    # --- replica pool (serve/pool.py) ---
    # Engine replicas behind the queue/scheduler seam: separate devices or
    # mesh shards on hardware, CPU threads in dryrun. 1 keeps the
    # single-engine data path but still health-gates it through the pool.
    pool_replicas: int = 1
    # How long checkout() waits for a ready replica before raising
    # NoReadyReplica (jobs stay queued; the durable queue absorbs brief
    # all-replicas-busy or rolling-swap windows).
    pool_checkout_timeout_s: float = 30.0
    # Dispatches a single replica may hold concurrently. 1 = strictly
    # serial per replica (scaling comes from replica count alone).
    pool_max_inflight_per_replica: int = 1
    # Per-replica dispatch breaker: stricter than the engine's own funnel
    # breaker — a replica that keeps failing leaves the rotation
    # (ready→degraded) after this many failures in the window, and is
    # probed again (half-open checkout) after the reset timeout.
    pool_breaker_failure_threshold: int = 3
    pool_breaker_window_s: float = 30.0
    pool_breaker_reset_timeout_s: float = 5.0
    # Rolling checkpoint swap: max seconds to wait for a draining replica's
    # in-flight dispatches to finish before swapping params anyway.
    pool_swap_drain_timeout_s: float = 30.0
    # Total deliveries (claims) a job gets before the queue dead-letters
    # it as poison — counts every redelivery, including visibility-timeout
    # and release()-based failover redeliveries that charge no *attempt*.
    queue_max_deliveries: int = 3
    # --- continuous-batching scheduler (serve/scheduler.py) ---
    # When enabled, run_forever drains through the pipelined three-stage
    # data plane (intake pool -> EDF window scheduler -> completion stage)
    # instead of the synchronous step_batch loop.
    sched_enabled: bool = True
    # Intake pool width: threads claiming jobs and running feature I/O +
    # prep concurrently with the device forward.
    sched_intake_threads: int = 4
    # Max READY (claimed + prepped, undispatched) jobs. Doubles as intake
    # backpressure AND the admission signal: ready jobs stay 'inflight' in
    # the durable queue, so they keep counting against the
    # AdmissionController's pending+inflight depth at the HTTP door.
    sched_ready_depth: int = 64
    # Adaptive batching window bounds: the scheduler lingers up to the
    # current window for co-arriving jobs before firing a partial batch;
    # the window stretches (x2 up to max) after full buckets and shrinks
    # (/2 down to min) after partial ones, so an idle system fires nearly
    # immediately and a backlogged one packs bigger batches.
    sched_window_min_s: float = 0.002
    sched_window_max_s: float = 0.05
    # A ready member whose deadline slack drops below this fires the batch
    # immediately (EDF front of the queue must not wait out the window).
    sched_near_deadline_ms: float = 250.0
    # Bound on completed-but-unpersisted results queued to the completion
    # stage (persist/push backpressure on the dispatch thread).
    sched_completion_depth: int = 128
    # --- obs/ live-health knobs (see ARCHITECTURE.md "SLOs & flight
    # recorder") ---
    # Background sampler: snapshot cadence and ring length of the
    # in-process time-series store (points per series; at a 1 s cadence
    # 512 points ≈ the last 8.5 minutes).
    sampler_cadence_s: float = 1.0
    timeseries_points: int = 512
    # Multi-window burn-rate evaluation: PAGE/WARN need the burn over the
    # threshold on BOTH windows (fast = "happening now", slow =
    # "sustained").
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0
    slo_warn_burn: float = 1.0
    slo_page_burn: float = 4.0
    # SLO targets: e2e latency p-objective, availability, and the
    # deadline-slack floor ROADMAP item 1 asks evidence for. Budgets are
    # the allowed bad-event ratio per objective.
    slo_e2e_target_ms: float = 2000.0
    slo_e2e_budget: float = 0.05
    slo_availability_budget: float = 0.02
    slo_slack_floor_ms: float = 1000.0
    slo_slack_budget: float = 0.05
    # Flight recorder: bundle directory (under serve_state by default so
    # a soak tmpdir sweeps it), rotation/size caps, spans per bundle, and
    # the per-event re-trigger floor.
    recorder_dir: str = "serve_state/postmortem"
    recorder_max_bundles: int = 16
    recorder_max_bytes: int = 1_000_000
    recorder_spans: int = 256
    recorder_min_interval_s: float = 30.0
    # Fleet observability spine (obs/fleet.py): every process's sampler
    # tick flushes instrument snapshots, timeseries deltas, spans, and a
    # heartbeat into a shared WAL sqlite db (next to the queue db when
    # unset), so any process can answer ?scope=fleet queries for the
    # whole fleet. A peer whose heartbeat is older than the staleness
    # bound is treated as dead (SIGKILL leaves no tombstone).
    fleet_enabled: bool = True
    fleet_db_path: str | None = None
    fleet_heartbeat_stale_s: float = 15.0
    fleet_max_spans: int = 2048
    fleet_spans_per_flush: int = 256
    fleet_timeseries_window_s: float = 600.0
    # Cost attribution + durable trace store (obs/attrib.py,
    # obs/tracestore.py): per-job stage/device-second accounting and
    # tail-sampled trace persistence on the fleet spine db. The keep
    # policy is verdict-based — non-ok terminals always persist, the
    # top-K slowest completions per task persist, the rest are
    # p-sampled — and rows older than the retention window are trimmed
    # on each flush.
    attrib_enabled: bool = True
    tracestore_keep_top_k: int = 8
    tracestore_sample_rate: float = 0.05
    tracestore_retention_s: float = 3600.0
    # --- duplicate-traffic tier (serve/resultcache.py; ROADMAP item 3) ---
    # Durable result cache: a WAL-sqlite table next to the jobs table
    # (same db file), keyed on (task, feature-content hash, canonical
    # question, config fingerprint/model generation). Hits skip the
    # queue and TPU entirely; a rolling swap bumps the model generation
    # and invalidates.
    result_cache_enabled: bool = True
    result_cache_max_rows: int = 4096
    result_cache_ttl_s: float = 3600.0
    # In-flight coalescing (singleflight): concurrent identical submits
    # attach as followers to the one in-flight leader job; every
    # terminal frame fans out to all followers. The lease bounds how
    # long a dead leader can strand its key before a fresh submit takes
    # the claim over and republishes.
    coalesce_enabled: bool = True
    coalesce_lease_s: float = 120.0
    # Tenant-weighted fairness in the EDF scheduler: select_batch grants
    # per-tenant row budgets by weighted deficit (DRR) ABOVE deadline
    # ordering, so one hot tenant cannot starve the rest. Weights are
    # relative shares; tenants absent from the map get the default
    # weight, and None weights means every tenant is equal.
    tenant_fairness_enabled: bool = True
    tenant_weights: Mapping[str, float] | None = None
    tenant_default_weight: float = 1.0
    # --- closed-loop autoscaler (serve/autoscale.py; ROADMAP item 1) ---
    # Target-tracking on queue-wait p95 and SLO burn rate, riding the obs
    # sampler cadence. Breach above target*band_high for breach_ticks
    # consecutive ticks scales OUT (pool.add_replica); slack below
    # target*band_low AND burn below threshold for slack_ticks ticks
    # scales IN (pool.retire_replica, never below min). Scale-out is
    # additionally gated on pool health: any open replica breaker or a
    # poison/dead-letter rate above max_poison_rate_per_s reads as
    # "unhealthy, don't scale", not "overloaded, add replicas".
    autoscale_enabled: bool = False
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 4
    autoscale_target_queue_wait_p95_ms: float = 500.0
    autoscale_burn_threshold: float = 1.0
    autoscale_band_high: float = 1.2
    autoscale_band_low: float = 0.5
    autoscale_breach_ticks: int = 3
    autoscale_slack_ticks: int = 12
    autoscale_cooldown_out_s: float = 30.0
    autoscale_cooldown_in_s: float = 60.0
    autoscale_max_poison_rate_per_s: float = 0.5
    autoscale_window_s: float = 30.0
    autoscale_decision_history: int = 128


# The storage modes EngineConfig.param_dtype takes.
PARAM_DTYPES = ("float16", "bfloat16", "float32", "float64", "int8")


def _known(cls, raw: Mapping[str, Any]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in raw.items() if k in names}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh layout (parallel/mesh.py), the JAX package's fields and
    defaults: ``dp`` shards request batches, ``tp`` shards weight matrices
    (Megatron), ``sp > 1`` adds an "sp" axis for ring attention over the
    visual stream. One process (rank) per mesh position."""

    dp: int = -1  # -1: all remaining ranks
    tp: int = 1
    sp: int = 1
    axis_names: Sequence[str] = ("dp", "tp")


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    model: ViLBertConfig = dataclasses.field(default_factory=ViLBertConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "FrameworkConfig":
        """Build from a nested dict such as ``dataclasses.asdict`` of the
        JAX package's FrameworkConfig; keys this package lacks are ignored."""
        return cls(
            model=ViLBertConfig(**_known(ViLBertConfig, raw.get("model", {}))),
            engine=EngineConfig(**_known(EngineConfig, raw.get("engine", {}))),
            mesh=MeshConfig(**_known(MeshConfig, raw.get("mesh", {}))),
            serving=ServingConfig(**_known(ServingConfig,
                                           raw.get("serving", {}))),
        )


def config_fingerprint(cfg: FrameworkConfig) -> str:
    """Short stable hash of the full config tree — the "which exact
    configuration was this process running" field for ``vmt_build_info``,
    flight-recorder bundles and the result cache's keys (sorted-key JSON
    over the dataclass dict)."""
    import hashlib

    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def add_backend_args(parser) -> None:
    """The shared --tiny/--cpu CLI knobs of the eval harness and the
    onboarding CLI (the JAX package's ``add_backend_args``)."""
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model config (rehearsal/tests; must "
                             "match any checkpoint being loaded)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (f32, dense attention, the "
                             "plain versions of the kernels)")


def apply_backend_args(cfg: FrameworkConfig, args) -> FrameworkConfig:
    """Apply add_backend_args selections: --cpu means f32 compute and dense
    attention (the engine then runs on ``backend_device(args)``, the CPU);
    --tiny the tiny model."""
    if getattr(args, "cpu", False):
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, compute_dtype="float32",
            use_pallas_coattention=False, use_pallas_self_attention=False))
    if getattr(args, "tiny", False):
        cfg = dataclasses.replace(cfg, model=cfg.model.tiny())
    return cfg


def backend_device(args) -> str:
    """The engine device the backend args select: the card unless --cpu."""
    return "cpu" if getattr(args, "cpu", False) else "cuda"
