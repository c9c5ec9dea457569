"""Serving runtime: bucketed ViLBERT inference on one CUDA device.

Counterpart of ``vilbert_multitask_tpu/engine/runtime.py`` — the engine
the serve tier drives: :meth:`InferenceEngine.prepare` /
:meth:`~InferenceEngine.prepare_from_store` (WordPiece tokenization, region
encode, bucketing), :meth:`~InferenceEngine.run` (one request: the trunk
forward, the fused heads and the on-device softmax/top-3 bundle),
:meth:`~InferenceEngine.run_many` (a backlog packed into row-bucket chunks,
:meth:`~InferenceEngine.chunk_plan`), :meth:`~InferenceEngine.decode` (host
numpy), :meth:`~InferenceEngine.predict` and :meth:`~InferenceEngine.warmup`.

- **Device.** The engine runs on ``cuda`` unless the caller passes
  ``device="cpu"`` (the tests do); asking for CUDA where there is none
  raises instead of carrying on on the CPU. On the CPU every kernel wrapper
  takes its plain PyTorch version and the engine runs eagerly.
- **Kernels.** The engine forces ``use_pallas_coattention`` and
  ``use_pallas_self_attention`` onto the model config, so on the card every
  eligible attention — the 12 bridge directions and the 6 visual
  self-attentions of a forward at serving width — runs the hand-written
  flash kernel (ops/coattention.py). A failed build, launch or graph
  capture raises; there is no degrade-to-dense path (``kernel_fallback``
  is always False).
- **The row slab.** Image rows live in a device-resident slab: slot 0 is
  the permanent pad row, then ``device_input_cache_entries`` LRU cache
  slots for content-stable store images (keyed by ``cache_keys``), then a
  scratch rotor of ``max_batch_rows()`` slots for keyless rows. A forward
  gathers its rows by a slot vector, so a cached image uploads nothing
  and the pad rows of a bucket never upload.
- **Stream order instead of functional updates.** The JAX engine updates
  the slab functionally: a forward dispatched earlier keeps reading its
  own slab value. Here the slab is written in place, so the engine gets
  the same safety from stream order: every slab write, forward and bundle
  copy of an engine is enqueued on one ``torch.cuda.Stream`` it owns, and
  a dispatch (pack, slab writes, forward, bundle copy) is enqueued under
  one lock, so a later pack's writes land after every earlier forward on
  the card. Pinned staging buffers come from PyTorch's pinned-memory
  cache, which reuses one only after the event behind its last
  non-blocking copy has completed. Setup (the slab, ``load_params``) also
  runs on the engine stream and waits on that stream only, never on the
  whole device: other replicas on the card keep running meanwhile.
- **CUDA graphs.** :meth:`~InferenceEngine.warmup` captures one graph per
  row bucket (engine/graphs.py); a dispatch then copies its pack into the
  graph's static input and replays it, and the few-KB bundle is copied to
  pinned host memory right behind the replay. ``collect_attention=True``
  runs eagerly (the JAX package compiles it as a separate program), as
  does an engine that was not warmed.
- **Weights.** With a floating ``EngineConfig.param_dtype`` (the
  default), Linear and Embedding weights are stored in the compute dtype.
  Flax's ``Dense(dtype=bf16)`` over f32 parameters casts the kernel, the
  bias and the input to bf16 before the product on every call, so the one
  cast at load is bit-equivalent. LayerNorm parameters stay f32, as flax's
  ``LayerNorm(dtype=bf16)`` uses them (statistics in f32).
  ``param_dtype="int8"`` is the int8 storage mode (models/int8.py): every
  matrix is an int8 ``{"int8", "scale"}`` pair quantized on the host at
  load (quant.py), every Linear of the trunk and every product of the fused
  heads runs the hand-written int8 GEMM (ops/int8_linear.py), and the
  numerics are the JAX int8 engine's (its forward computes with
  ``dequantize_tree(params, compute_dtype)``: the trunk's vectors,
  LayerNorm parameters included, rounded to the compute dtype; the head
  slabs dequantized in f32, ``_make_head_slab_builder``).
  :meth:`~InferenceEngine.load_params` copies into the existing tensors,
  so captured graphs stay valid across a swap.
- **Shapes.** Text is always ``max_text_len`` (37, +1 task token) and
  regions ``max_regions`` (101); the image axis pads to one of
  ``EngineConfig.image_buckets`` (``run``) or a row bucket
  (``run_many``). NLVR2 pairs and retrieval candidates score in one
  forward with the question replicated per image row.
- **Meshes.** ``InferenceEngine(..., mesh=)`` (a ``parallel.build_mesh``
  mesh; one engine per rank, every rank builds it) serves through the
  dp×tp(×sp) mesh, as the JAX engine does with its ``mesh``: the model is
  made tensor-parallel (parallel/tp.py) before it gets storage and
  ``load_params`` slices each rank's shard of a global state dict
  (parallel/sharding.py; a ``ShardedStateDict`` is taken as it is); the
  fused head slabs stay replicated. Rank 0 serves: each dispatch (its
  bucket, flags and the packed batch) is broadcast to every rank, each
  rank takes its dp rows (``place_batch``), runs the same forward with
  the tp collectives, and the decode bundle's rows are all-gathered over
  dp for rank 0 to decode. The other ranks run :meth:`~InferenceEngine.
  follow` until rank 0 calls :meth:`~InferenceEngine.stop_followers`;
  they wait for each dispatch's header on a host group of its own
  (``parallel.mesh.idle_axis``), so a server idle for longer than the
  collectives' timeout keeps its followers. An attention whose heads tp
  does not divide runs whole on every rank (``parallel.tp.parallelize``).
  :meth:`~InferenceEngine.load_checkpoint` swaps the weights on every
  rank: rank 0 broadcasts a load, each rank restores its own shard, and
  none copies until all have restored. There is no row slab and
  there are no CUDA graphs on a mesh (the JAX mesh path has no row cache
  either); forwards run eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vilbert_multitask_tpu_torch import assets, obs, quant
from vilbert_multitask_tpu_torch.config import (
    PARAM_DTYPES,
    TASK_REGISTRY,
    FrameworkConfig,
    TaskSpec,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.engine import decode as dec
from vilbert_multitask_tpu_torch.engine import graphs
from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore
from vilbert_multitask_tpu_torch.features.pipeline import (
    GLOBAL_BOX,
    RegionFeatures,
    batch_images,
    clip_regions,
    encode_image,
)
from vilbert_multitask_tpu_torch.features.store import FeatureStore
from vilbert_multitask_tpu_torch.models.heads import (
    SERVED_HEADS,
    build_head_slabs,
    build_int8_head_slabs,
    stack_head_slabs,
)
from vilbert_multitask_tpu_torch.models.int8 import quantize_modules
from vilbert_multitask_tpu_torch.models.vilbert import (
    ViLBertForVLTasks,
    ViLBertOutput,
    fused_head_output,
)
from vilbert_multitask_tpu_torch.parallel import comm
from vilbert_multitask_tpu_torch.parallel import sharding as shd
from vilbert_multitask_tpu_torch.parallel.mesh import axis as mesh_axis
from vilbert_multitask_tpu_torch.parallel.mesh import idle_axis, world_axis
from vilbert_multitask_tpu_torch.parallel.ring import RingContext
from vilbert_multitask_tpu_torch.parallel.tp import layout, parallelize
from vilbert_multitask_tpu_torch.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    ReplicaKilled,
)
from vilbert_multitask_tpu_torch.resilience.faults import fault_point
from vilbert_multitask_tpu_torch.text.pipeline import (
    EncodedText,
    encode_question,
)
from vilbert_multitask_tpu_torch.text.wordpiece import FullTokenizer

# The compute dtypes the flash kernel takes.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``torch.device`` for an engine: CUDA must exist when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def init_state_dict(cfg: ViLBertConfig, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """Seeded random weights as an f32 CPU state dict (upstream keys),
    drawn from one ``torch.Generator``: Linear weights N(0, 1/fan_in) (the
    variance of flax's default lecun-normal), biases N(0, 0.02²), embedding
    rows N(0, 1/dim), LayerNorm weight 1 and bias 0. The JAX package's
    initializers have the same laws but other bits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = ViLBertForVLTasks(cfg)
    sd: Dict[str, torch.Tensor] = {}
    for mname, mod in shapes.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, nn.LayerNorm):
            sd[pre + "weight"] = torch.ones(mod.weight.shape)
            sd[pre + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, nn.Embedding):
            n, d = mod.weight.shape
            sd[pre + "weight"] = torch.randn(n, d, generator=gen) / d ** 0.5
        elif isinstance(mod, nn.Linear):
            if pre + "weight" == "cls.predictions.decoder.weight":
                continue  # tied to the word embeddings, set below
            out_f, in_f = mod.weight.shape
            sd[pre + "weight"] = (torch.randn(out_f, in_f, generator=gen)
                                  / in_f ** 0.5)
            if mod.bias is not None:
                sd[pre + "bias"] = 0.02 * torch.randn(out_f, generator=gen)
    sd["cls.predictions.bias"] = torch.zeros(cfg.vocab_size)
    sd["cls.predictions.decoder.weight"] = sd[
        "bert.embeddings.word_embeddings.weight"]
    return sd


@dataclasses.dataclass
class PreparedRequest:
    """Host-side buffers for one request, already bucketed. ``features`` is
    a CPU tensor in the engine's transfer dtype (bf16 when the engine
    computes in bf16: the model casts its inputs to the compute dtype
    anyway, so the early cast is exact and halves the upload)."""

    spec: TaskSpec
    n_images: int
    bucket: int
    text: EncodedText  # (bucket, Nt)
    features: torch.Tensor  # (bucket, Nv, D) transfer dtype, on the CPU
    spatials: np.ndarray  # (bucket, Nv, 5) f32 (decode reads these host-side)
    image_mask: np.ndarray  # (bucket, Nv)
    task_ids: np.ndarray  # (bucket, 1)
    images: List[dec.ImageMeta]
    # Stable per-image identities for the device input cache (one string
    # per REAL image row, length n_images), or None for novel uploads /
    # synthetic defaults. Row-level so any bucket size shares entries.
    cache_keys: Optional[List[str]] = None


# ------------------------------------------------------------ bundle packing
def _leaves(tree, path=()):
    """(path, tensor) leaves of a decode bundle, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _flatten_bundle(bundle: dict, rows: int
                    ) -> Tuple[torch.Tensor, List[tuple]]:
    """The decode bundle as ONE ``(rows, W)`` f32 tensor (so a dispatch
    fetches it with one copy) and the spec to undo it. Every leaf has
    ``rows`` rows' worth of values (the paired NLVR2 head's ``(rows/2, 2)``
    included); top-k indices are < 2^24 and cross exactly as f32."""
    parts, spec = [], []
    for path, x in _leaves(bundle):
        parts.append(x.reshape(rows, -1).float())
        spec.append((path, tuple(x.shape), x.dtype.is_floating_point))
    return torch.cat(parts, dim=1), spec


def _unflatten_bundle(flat: np.ndarray, spec: List[tuple]) -> dict:
    """Inverse of :func:`_flatten_bundle` on the host: numpy leaves of the
    original shapes (indices back to int64), tuples and dicts rebuilt."""
    out: dict = {}
    col = 0
    for path, shape, is_float in spec:
        width = int(np.prod(shape)) // flat.shape[0]
        x = flat[:, col:col + width].reshape(shape)
        col += width
        x = x.copy() if is_float else x.astype(np.int64)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return _tuples(out)


def _tuples(tree):
    """Dicts keyed 0..n-1 (from tuple paths) back into tuples."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, int) for k in tree):
        return tuple(_tuples(tree[i]) for i in range(len(tree)))
    return {k: _tuples(v) for k, v in tree.items()}


def _align(n: int, to: int = 16) -> int:
    return (n + to - 1) // to * to


@dataclasses.dataclass
class _Dispatch:
    """One enqueued forward: its bundle is (being) copied into ``host``;
    ``event`` completes when the copy has landed (None on the CPU).
    While the ``engine.replay`` span records, ``start`` is recorded on the
    engine stream just before the forward and both are timing events;
    otherwise ``start`` is None."""

    host: torch.Tensor  # (rows, W) f32, pinned on the card
    spec: List[tuple]
    event: Optional["torch.cuda.Event"]
    out: Optional[ViLBertOutput]
    start: Optional["torch.cuda.Event"] = None

    def fetch(self) -> dict:
        """Wait for the bundle, then unflatten it. The ``engine.fetch``
        span carries the forward's device time (``device_ms``: ``start``
        to ``event``), read after the wait."""
        with obs.span("engine.fetch") as sp:
            if self.event is not None:
                self.event.synchronize()
                if sp.recording and self.start is not None:
                    sp.set(device_ms=self.start.elapsed_time(self.event))
            return _unflatten_bundle(self.host.numpy(), self.spec)


def _leaf_shape(v) -> tuple:
    """A state-dict leaf's shape (an int8 pair's: its values')."""
    return tuple((v[quant.QVALUES] if quant.is_quantized_leaf(v)
                  else v).shape)


def _clone_output(out: ViLBertOutput) -> ViLBertOutput:
    """A graph's static output tensors are overwritten by its next replay:
    run() hands its caller copies."""
    return dataclasses.replace(out, **{
        f.name: getattr(out, f.name).clone()
        for f in dataclasses.fields(out)
        if isinstance(getattr(out, f.name), torch.Tensor)})


class InferenceEngine:
    """One engine per process (or per pool replica): owns the model,
    tokenizer and stores, the device row slab, the per-bucket graphs and
    one CUDA stream."""

    # Max label-decode fanout (TaskSpec.top_k ≤ 3 for the labels family).
    _TOPK = 3
    # At most this many chunks in flight (enqueued, bundle not yet fetched)
    # during a chunked run_many: 2 overlaps packing chunk k+1 on the host
    # with chunk k on the card; more only grows the memory footprint.
    _MAX_INFLIGHT_CHUNKS = 2
    # There is no degrade-to-dense path on this backend: a failed kernel
    # raises (the serve tier reads the flag).
    kernel_fallback = False

    def __init__(
        self,
        cfg: Optional[FrameworkConfig] = None,
        *,
        params: Optional[Dict] = None,
        tokenizer: Optional[FullTokenizer] = None,
        feature_store: Optional[FeatureStore] = None,
        label_store: Optional[LabelMapStore] = None,
        seed: int = 0,
        replica_id: Optional[str] = None,
        mesh=None,
        device="cuda",
    ):
        self.cfg = cfg or FrameworkConfig()
        ecfg = self.cfg.engine
        # Replica identity (serve/pool.py): None for standalone engines.
        # Threads through the breaker name, live_stats and forward spans.
        self.replica_id = replica_id
        # Flipped by ReplicaPool.kill() (chaos) or by the pool when a
        # health probe declares this replica dead: every later dispatch
        # fails fast with ReplicaKilled.
        self.killed = False
        # The dp×tp(×sp) process mesh (parallel/mesh.py), or None.
        self.mesh = mesh
        # Where the other ranks wait for rank 0's next dispatch header: a
        # group whose timeout is not the collectives' (an idle server is
        # not a dead peer). None off a mesh.
        self._idle = idle_axis(mesh) if mesh is not None else None
        self._ring_v = RingContext.from_mesh(
            mesh, min_seq=ecfg.ring_min_regions)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The f32 parity runs compare with the CPU in full f32: TF32
            # (about three decimal digits) must not creep into any matmul
            # or convolution, whatever the process default.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if ecfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {ecfg.compute_dtype}")
        self.compute_dtype = _DTYPES[ecfg.compute_dtype]
        # Storage of the served weights: a floating dtype keeps them in the
        # compute dtype, "int8" quantizes them (see the module docstring).
        if ecfg.param_dtype not in PARAM_DTYPES:
            raise ValueError(f"engine.param_dtype must be a floating dtype "
                             f"or 'int8', got {ecfg.param_dtype!r}")
        self.param_quantized = ecfg.param_dtype == "int8"
        # Engine kernel knobs win over the model config, unconditionally.
        self.model_config = dataclasses.replace(
            self.cfg.model,
            use_pallas_coattention=ecfg.use_pallas_coattention,
            use_pallas_self_attention=ecfg.use_pallas_self_attention,
        )
        self.tokenizer = tokenizer or FullTokenizer.from_vocab_file(
            ecfg.vocab_path or assets.default_vocab_path())
        self._check_vocab_coherence()
        self.feature_store = feature_store
        self.labels = label_store or LabelMapStore(
            root=ecfg.labels_root or assets.default_labels_root(),
            sizes={"vqa": self.cfg.model.num_labels,
                   "gqa": self.cfg.model.gqa_num_labels})
        # Task-id → label-head gather table for the fused decode bundle
        # (index 1 = the GQA head, 0 = the VQA head).
        n_tasks = max(TASK_REGISTRY) + 1
        self._gqa_gather = torch.tensor(
            [1 if (t in TASK_REGISTRY
                   and TASK_REGISTRY[t].head == "vil_prediction_gqa") else 0
             for t in range(n_tasks)], dtype=torch.long, device=self.device)
        # Boot-phase split for /healthz: upload_s (weights), compile_s
        # (graph capture at warmup, also booked as capture_s; the server
        # adds restore_s, cache_load_s and nvcc's share of compile_s).
        self.boot_times: Dict[str, float] = {}
        self._boot_lock = threading.Lock()
        # Every slab write, forward and bundle copy goes on this stream
        # (the pool and scheduler call from several threads, and torch's
        # current stream is per thread); one dispatch is enqueued under
        # _dispatch_lock. Lock order: _dispatch_lock, then
        # _input_cache_lock.
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._dispatch_lock = threading.Lock()
        # Breaker over the forward funnel (_call_forward): sustained device
        # failures fail jobs fast toward the queue's dead-letter path.
        breaker_name = ("engine.forward" if replica_id is None
                        else f"engine.forward.{replica_id}")
        self._breaker = CircuitBreaker(
            name=breaker_name, failure_threshold=8, window_s=60.0,
            reset_timeout_s=15.0)
        # Device input cache: key → slab slot, LRU over
        # EngineConfig.device_input_cache_entries.
        self._input_cache: "OrderedDict[str, int]" = OrderedDict()
        self._input_cache_lock = threading.Lock()
        self._input_cache_hits = 0
        self._input_cache_misses = 0
        # Row slab state (built lazily): the slab tensors, the free
        # cache-slot pool and the scratch rotor.
        self._slab: Optional[Dict[str, torch.Tensor]] = None
        self._slab_free: List[int] = []
        self._slab_scratch0 = 0
        self._slab_scratch_n = 0
        self._scratch_next = 0
        self._pack_keys: set = set()
        # One captured graph per row bucket (warmup), one shared pool.
        self._graphs: Dict[int, graphs.BucketGraph] = {}
        self._graph_pool = None
        # Built on the meta device (no allocation, no init kernels), then
        # given storage once: Linear/Embedding weights in the compute dtype
        # (or their int8 forms), the rest f32. load_params copies into
        # these tensors.
        t_up = time.perf_counter()
        with torch.device("meta"):
            self.model = ViLBertForVLTasks(self.model_config,
                                           ring_v=self._ring_v)
            if self.param_quantized:
                quantize_modules(self.model, self.compute_dtype)
            if mesh is not None:
                parallelize(self.model, mesh)
        # Where each leaf of the served state dict is sharded on this
        # mesh (an attention whose heads tp does not divide stays whole).
        self._layout = layout(self.model) if mesh is not None else None
        self.model.to_empty(device=self.device)
        if not self.param_quantized:
            for mod in self.model.modules():
                if isinstance(mod, (nn.Linear, nn.Embedding)):
                    mod.to(self.compute_dtype)
        self.model.eval().requires_grad_(False)
        self.head_slabs: Optional[Dict[str, torch.Tensor]] = None
        self.load_params(self.init_params(seed) if params is None else params)
        self.book_boot_time("upload_s", time.perf_counter() - t_up)

    # ------------------------------------------------------------------ init
    def _check_vocab_coherence(self) -> None:
        """Boot-time guard: the loaded vocab must fit the embedding table
        (an over-range token id would index out of it)."""
        n_vocab = len(self.tokenizer.vocab)
        n_rows = self.cfg.model.vocab_size
        if n_vocab > n_rows:
            raise ValueError(
                f"vocab file has {n_vocab} tokens but ViLBertConfig."
                f"vocab_size is {n_rows}: token ids would index out of the "
                f"embedding table. Fix vocab_path or vocab_size.")
        if n_rows > 2 * n_vocab:
            logging.getLogger(__name__).warning(
                "embedding table has %d rows but the vocab only %d tokens "
                "(%.0f%% dead weight) — expected with the committed "
                "synthetic vocab", n_rows, n_vocab,
                100 * (1 - n_vocab / n_rows))

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Seeded random weights for this engine's model (see
        :func:`init_state_dict`)."""
        return init_state_dict(self.model_config, seed)

    def load_params(self, params: Dict) -> None:
        """Load an upstream-layout state dict (numpy arrays or tensors; the
        reference checkpoint's keys, or ``checkpoint.convert.
        from_flax_params`` of a JAX tree) with ``strict=True`` into the
        model's existing tensors (each value is cast to its parameter's
        dtype on the copy, as a cast at load would), and rebuild the fused
        head slabs into theirs: the captured graphs read those addresses.
        An int8 engine quantizes an f32 tree on the host first
        (``quant.quantize_tree``) and takes an already-quantized one as it
        is; a floating engine refuses a quantized tree.
        The copies go on the engine stream behind any dispatch already
        enqueued there, and only that stream is waited on: other engines
        on the card keep running (and may be capturing) meanwhile.

        On a mesh every rank calls it (with the same tree): a global
        state dict is quantized first when the engine is int8, then each
        rank keeps its shard; a ``ShardedStateDict`` (``checkpoint.
        restore_params(..., mesh=)``) is this rank's already, and the
        served heads' leaves are gathered over tp for the slabs. A tree
        that only rank 0 of a served mesh holds goes through
        :meth:`broadcast_params`."""
        sd, heads = self._local_state(params)
        if heads is None:
            heads = self._gathered_heads(sd)
        with self._dispatch_lock:
            self._copy_state(sd, heads)

    def _stored(self, params: Dict) -> Dict:
        """``params`` as tensors in the engine's storage: quantized on an
        int8 engine (an already-quantized tree as it is); a floating engine
        refuses a quantized tree."""
        sd = {k: quant.leaf_to(v) for k, v in params.items()}
        if self.param_quantized:
            if isinstance(params, shd.ShardedStateDict) and any(
                    not quant.is_quantized_leaf(v) and v.dim() >= 2
                    and v.is_floating_point() for v in sd.values()):
                # A shard's per-channel scales are not the matrix's.
                raise ValueError("an int8 mesh engine takes a sharded "
                                 "state dict quantized before sharding "
                                 "(restore_params(..., dtype='int8'))")
            return quant.quantize_tree(sd)
        if quant.tree_is_quantized(sd):
            raise ValueError("a quantized (int8) state dict needs "
                             "EngineConfig.param_dtype='int8'")
        return sd

    def _local_state(self, params: Dict) -> Tuple[Dict, Optional[Dict]]:
        """:meth:`load_params`' work on this rank alone: the state dict to
        copy (quantized on an int8 engine; this rank's shard on a mesh) and
        the served heads' global leaves, or None where a sharded dict's
        heads must be gathered over tp (:meth:`_gathered_heads`)."""
        sd = self._stored(params)
        if self.mesh is None:
            return sd, sd
        if isinstance(params, shd.ShardedStateDict):
            return sd, None
        return shd.shard_state_dict(sd, self.mesh, self._layout), sd

    def _gathered_heads(self, sd: Dict) -> Dict:
        """The served heads' leaves of this rank's shards, gathered over tp
        (a collective: every rank of the tp axis calls it)."""
        return shd.gather_state_dict(
            {k: quant.leaf_to(v, self.device) for k, v in sd.items()
             if k.startswith(SERVED_HEADS)},
            self.mesh, self._global_shapes(), self._layout)

    def _check_state(self, sd: Dict) -> None:
        """Refuse, before anything is copied, a state dict whose keys or
        shapes are not the model's: ``load_state_dict`` copies the leaves
        that fit and raises after, which would leave a mix of weights."""
        self._check_shapes({k: _leaf_shape(v) for k, v in sd.items()},
                           {k: _leaf_shape(v) for k, v in
                            self.model.state_dict().items()})

    @staticmethod
    def _check_shapes(got: Dict[str, tuple], want: Dict[str, tuple]
                      ) -> None:
        """Raise unless ``got`` has ``want``'s keys and shapes."""
        if set(got) != set(want):
            raise ValueError(f"state dict keys differ from the model's: "
                             f"missing {sorted(set(want) - set(got))[:5]}, "
                             f"unexpected {sorted(set(got) - set(want))[:5]}")
        bad = [k for k in want if tuple(got[k]) != tuple(want[k])]
        if bad:
            raise ValueError(f"shapes differ from the model's at {bad[:5]}")

    def _copy_state(self, sd: Dict, heads: Dict) -> None:
        """Copy ``sd`` into the model's tensors and rebuild the head slabs
        in place (the caller holds ``_dispatch_lock``)."""
        with torch.no_grad(), self._stream_ctx():
            self.model.load_state_dict(sd, strict=True)
            slabs = None
            if self.cfg.engine.fused_task_heads:
                slabs = (build_int8_head_slabs(heads, self.model_config,
                                               self.compute_dtype,
                                               self.device)
                         if self.param_quantized else
                         build_head_slabs(self.model, self.model_config)
                         if self.mesh is None else
                         self._replicated_head_slabs(heads))
            if self.head_slabs is None or slabs is None:
                self.head_slabs = slabs
            else:
                for name, t in self.head_slabs.items():
                    t.copy_(slabs[name])
            if self._stream is not None:
                self._stream.synchronize()

    def load_checkpoint(self, path: str) -> None:
        """Restore the checkpoint at ``path`` (``checkpoint.restore_params``,
        cast to ``EngineConfig.param_dtype``) and load it.

        On a mesh rank 0 calls it, and every rank restores and loads its
        own shard: rank 0 broadcasts a load (the path and the storage
        dtype) on the idle group, and each rank restores its shard and
        checks it against its model (:meth:`_mesh_load`)."""
        from vilbert_multitask_tpu_torch.checkpoint.store import (
            restore_params,
        )

        if self.mesh is None:
            fault_point("engine.load")
            self.load_params(restore_params(
                path, dtype=self.cfg.engine.param_dtype,
                cfg=self.model_config))
            return
        self._start_mesh_load({"source": "checkpoint",
                               "path": os.path.abspath(path),
                               "dtype": self.cfg.engine.param_dtype})

    def broadcast_params(self, params: Dict) -> int:
        """Rank 0 of a served mesh: load the upstream-layout state dict
        ``params``, which only this rank holds, on every rank. Returns the
        bytes broadcast.

        The tree is put in the engine's storage here first: an int8 engine
        quantizes a floating tree (a row shard's per-channel scale needs
        the whole input axis), a floating engine casts each leaf to the
        dtype its tensor holds (what the copy would do). Rank 0 broadcasts
        a load whose request names every leaf's key, shape and dtype, and
        the ranks check those against the model's global shapes and agree
        before any weight moves. The leaves then travel one at a time on
        the idle group; each rank keeps its shard of each and the served
        heads whole (for the slabs), so no rank holds a second copy of the
        model. Checks, agreement and copies then go as for a checkpoint
        (:meth:`_mesh_load`)."""
        if self.mesh is None:
            raise RuntimeError("broadcast_params needs a mesh; load_params "
                               "loads a tree on one device")
        sd = self._stored(params)
        own = self.model.state_dict()
        tree, leaves = {}, []
        for key, v in sd.items():
            parts = v if quant.is_quantized_leaf(v) else {None: v}
            if None in parts and key in own and v.is_floating_point():
                parts = {None: v.to(own[key].dtype)}
            parts = {p: t.detach().cpu().contiguous()
                     for p, t in parts.items()}
            tree[key] = parts
            leaves.append([key, [[p, list(t.shape), str(t.dtype)[6:]]
                                 for p, t in parts.items()]])
        return self._start_mesh_load({"source": "tree", "leaves": leaves},
                                     tree)[0]

    def _start_mesh_load(self, job: dict, tree: Optional[Dict] = None
                         ) -> tuple:
        """Rank 0: send a load to every rank (:meth:`_mesh_load`)."""
        if world_axis(self.mesh).index != 0:
            raise RuntimeError("on a mesh only rank 0 starts a load; the "
                               "other ranks run follow()")
        request = json.dumps(job).encode()
        header = torch.tensor([self._OP_LOAD, len(request), 0, 0])
        with self._dispatch_lock, torch.inference_mode(), \
                self._stream_ctx():
            return self._mesh_exchange(header, (request, tree))

    def _mesh_load(self, payload: Optional[tuple], n: int) -> tuple:
        """A load on every rank of a mesh (rank 0 passes the payload: the
        request and, for a tree, its host leaves; the others receive the
        request's ``n`` bytes). Every rank passes the ``engine.load`` fault
        site and checks what it will load against its model, and the
        ranks agree on the idle group before any rank copies: a failure
        anywhere leaves every rank on its weights and raises on rank 0
        with the failed ranks' errors. A checkpoint is restored and
        checked shard by shard before that agreement. A tree's leaf list
        is checked against the global shapes before it, and its leaves are
        broadcast after it; the shards are then checked and the ranks
        agree again. After the copies they agree once more, so the next
        forward runs on the new weights everywhere. Returns (bytes of
        leaves broadcast,); a follower keeps following."""
        from vilbert_multitask_tpu_torch.checkpoint.store import (
            restore_params,
        )

        request, tree = payload if payload is not None else (None, None)
        buf = (torch.frombuffer(bytearray(request), dtype=torch.uint8)
               if request is not None else torch.empty(n, dtype=torch.uint8))
        job = json.loads(bytes(comm.broadcast(buf, self._idle).tolist()))
        what = job["path"] if job["source"] == "checkpoint" else "a tree"
        sent, error, sd, heads = 0, None, None, None
        try:
            fault_point("engine.load")
            if job["source"] == "checkpoint":
                sd, heads = self._local_state(restore_params(
                    job["path"], dtype=job["dtype"], cfg=self.model_config,
                    mesh=self.mesh))
                self._check_state(sd)
            else:
                self._check_shapes(
                    {key: shape for key, parts in job["leaves"]
                     for part, shape, _ in parts
                     if part in (None, quant.QVALUES)},
                    self._global_shapes())
        except Exception as e:  # noqa: BLE001 — every rank reports
            error = e
        failed = self._agree(error)
        if failed is None and job["source"] == "tree":
            try:
                sd, heads, sent = self._receive_tree(job["leaves"], tree)
                self._check_state(sd)
            except Exception as e:  # noqa: BLE001 — every rank reports
                error = e
            failed = self._agree(error)
        if failed is None:
            try:
                if heads is None:
                    heads = self._gathered_heads(sd)
                self._copy_state(sd, heads)
            except Exception as e:  # noqa: BLE001 — every rank reports
                error = e
            failed = self._agree(error)
            if failed is not None:
                failed = ("the copies failed after every rank restored; the "
                          "ranks may hold different weights: " + failed)
        else:
            failed = "every rank keeps its weights: " + failed
        if failed is not None and world_axis(self.mesh).index == 0:
            raise RuntimeError(f"load of {what} on the mesh failed; "
                               f"{failed}")
        return (sent,)

    def _receive_tree(self, leaves: list, tree: Optional[Dict]) -> tuple:
        """Every leaf of a tree load broadcast from rank 0 (whose ``tree``
        holds them; the other ranks receive into buffers the request's
        ``leaves`` describe) → (this rank's shard of each leaf, the served
        heads' global leaves, the bytes broadcast). Only one global leaf is
        held at a time."""
        sd, heads, sent = shd.ShardedStateDict(), {}, 0
        for key, parts in leaves:
            got = {}
            for part, shape, dtype in parts:
                t = (tree[key][part] if tree is not None else
                     torch.empty(shape, dtype=getattr(torch, dtype)))
                got[part] = comm.broadcast(t, self._idle)
                sent += t.numel() * t.element_size()
            leaf = got[None] if None in got else got
            if key.startswith(SERVED_HEADS):
                heads[key] = leaf
            sd[key] = shd.shard_state_dict({key: leaf}, self.mesh,
                                           self._layout)[key]
        return sd, heads, sent

    def _agree(self, error: Optional[BaseException]) -> Optional[str]:
        """Every rank's error of a mesh load, gathered on the idle group
        (no collective timeout: a restore may take long on one rank):
        None when every rank succeeded, else the failed ranks' errors."""
        errors: List[Optional[str]] = [None] * world_axis(self.mesh).size
        mine = None if error is None else f"{type(error).__name__}: {error}"
        torch.distributed.all_gather_object(errors, mine,
                                            group=self._idle.group)
        failed = [f"rank {r}: {e}" for r, e in enumerate(errors)
                  if e is not None]
        return "; ".join(failed) if failed else None

    def _replicated_head_slabs(self, sd: Dict) -> Dict[str, torch.Tensor]:
        """The floating head slabs of a mesh engine, from the global
        served-head leaves of ``sd`` in the dtypes the single-device
        engine's modules hold them (Linear leaves in the compute dtype,
        the LayerNorm ``logit_fc.2`` leaves in f32), on every rank."""
        def leaf(key):
            dt = (torch.float32 if ".logit_fc.2." in key
                  else self.compute_dtype)
            return torch.as_tensor(sd[key]).to(self.device, dt)

        return stack_head_slabs(leaf, self.model_config)

    def _global_shapes(self) -> Dict[str, tuple]:
        """Every upstream key's global shape (a meta model of the config)."""
        with torch.device("meta"):
            full = ViLBertForVLTasks(self.model_config)
        return {k: tuple(v.shape) for k, v in full.state_dict().items()}

    def state_dict(self) -> Dict:
        """The served weights as an upstream-key state dict of the engine's
        own tensors: ``{"int8", "scale"}`` pairs and f32 vectors on an int8
        engine (``load_params`` takes it back unchanged). On a mesh, this
        rank's shards (a ``ShardedStateDict``)."""
        sd = self.model.state_dict()
        return shd.ShardedStateDict(sd) if self.mesh is not None else sd

    def book_boot_time(self, phase: str, seconds: float) -> None:
        """Accumulate one boot-phase duration (upload_s / compile_s);
        surfaces in live_stats() → /healthz."""
        with self._boot_lock:
            self.boot_times[phase] = (
                self.boot_times.get(phase, 0.0) + seconds)

    @property
    def pallas_enabled(self) -> bool:
        """Whether the hand-written attention kernel is selected (the JAX
        engine's name for its Pallas kernels)."""
        return (self.model_config.use_pallas_coattention
                or self.model_config.use_pallas_self_attention)

    # -------------------------------------------------------------- prepare
    @property
    def transfer_dtype(self) -> torch.dtype:
        """Dtype region features ship to the device in: the compute dtype
        when it is a 16-bit float, f32 otherwise."""
        if self.compute_dtype.is_floating_point and (
                self.compute_dtype.itemsize == 2):
            return self.compute_dtype
        return torch.float32

    def prepare_from_store(self, task_id: int, question: str,
                           image_paths: Sequence[str]) -> PreparedRequest:
        """prepare() with regions AND device-cache identities from the
        attached feature store in one read (``store.fetch``): the identity
        is captured at read time, so the cache can never bind a fresh key
        to stale tensors. Stores without ``fetch`` skip device caching."""
        if self.feature_store is None:
            raise RuntimeError("prepare_from_store() needs a FeatureStore; "
                               "use prepare() with in-memory regions instead")
        fetch = getattr(self.feature_store, "fetch", None)
        with obs.span("engine.prepare", task_id=task_id):
            with obs.span("engine.features", source="store",
                          n_images=len(image_paths), task_id=task_id):
                if fetch is not None:
                    pairs = [fetch(p) for p in image_paths]
                    regions = [r for r, _ in pairs]
                    cache_keys: Optional[List[str]] = [k for _, k in pairs]
                else:
                    regions = self.feature_store.get_batch(image_paths)
                    cache_keys = None
            return self._prepare(task_id, question, regions, image_paths,
                                 cache_keys)

    def prepare(self, task_id: int, question: str,
                regions: Sequence[RegionFeatures],
                image_paths: Optional[Sequence[str]] = None, *,
                cache_keys: Optional[Sequence[str]] = None
                ) -> PreparedRequest:
        """Host-side preprocessing: validate, tokenize, encode, bucket
        (reference ``custom_prediction``, worker.py:388-458, with the repeat
        semantics of worker.py:256-284). ``cache_keys`` (one stable
        identity per image) opts the request's rows into the device input
        cache — pass them only for content-stable images."""
        with obs.span("engine.prepare", task_id=task_id):
            return self._prepare(task_id, question, regions, image_paths,
                                 cache_keys)

    def _prepare(self, task_id: int, question: str,
                 regions: Sequence[RegionFeatures],
                 image_paths: Optional[Sequence[str]],
                 cache_keys: Optional[Sequence[str]]) -> PreparedRequest:
        """prepare()'s work, inside the caller's ``engine.prepare`` span:
        the ``engine.tokenize`` and ``engine.features`` (encode) stages."""
        if task_id not in TASK_REGISTRY:
            raise ValueError(f"unknown task_id {task_id}")
        spec = TASK_REGISTRY[task_id]
        n = len(regions)
        spec.validate_num_images(n)
        ecfg = self.cfg.engine
        bucket = n if n == 1 else ecfg.bucket_for(n)

        with obs.span("engine.tokenize", task_id=task_id):
            text = encode_question(
                self.tokenizer, question, ecfg.max_text_len,
                task_id=task_id,
                lowercase=self.cfg.serving.lowercase_questions,
            ).stack(bucket)
        with obs.span("engine.features", source="encode", n_images=n,
                      task_id=task_id):
            regions = clip_regions(regions, ecfg.max_regions,
                                   num_features=ecfg.num_features)
            encoded = [encode_image(r, ecfg.max_regions) for r in regions]
            feats, spatials, image_mask = batch_images(encoded,
                                                       pad_to=bucket)
            feats = torch.from_numpy(feats).to(self.transfer_dtype)
        task_ids = np.full((bucket, 1), task_id, np.int32)
        if cache_keys is not None:
            if len(cache_keys) != n:
                raise ValueError(
                    f"got {len(cache_keys)} cache keys for {n} images")
            cache_keys = (list(cache_keys)
                          if ecfg.device_input_cache_entries > 0 else None)
        paths = list(image_paths or [f"image_{i}" for i in range(n)])
        if len(paths) != n:
            raise ValueError(
                f"got {len(paths)} image paths for {n} feature sets")
        images = [dec.ImageMeta(p, r.image_width, r.image_height)
                  for p, r in zip(paths, regions)]
        return PreparedRequest(spec, n, bucket, text, feats, spatials,
                               image_mask, task_ids, images,
                               cache_keys=cache_keys)

    # ---------------------------------------------------------------- bundles
    @classmethod
    def _decode_bundle(cls, out: ViLBertOutput) -> dict:
        """Device-side decode prep for the per-head path: f32 softmax and
        top-3 of both label heads, f32 copies of the small heads."""
        f32 = lambda x: x.float()  # noqa: E731
        vqa = torch.topk(torch.softmax(f32(out.vil_prediction), -1), cls._TOPK)
        gqa = torch.topk(torch.softmax(f32(out.vil_prediction_gqa), -1),
                         cls._TOPK)
        return {
            "labels_top": {"vil_prediction": (vqa.values, vqa.indices),
                           "vil_prediction_gqa": (gqa.values, gqa.indices)},
            "vil_logit": f32(out.vil_logit),
            "vil_tri_prediction": f32(out.vil_tri_prediction),
            "vision_logit": f32(out.vision_logit),
            # The paired NLVR2 head only exists for even batches.
            **({"vil_binary_prediction": f32(out.vil_binary_prediction)}
               if out.vil_binary_prediction is not None else {}),
        }

    @classmethod
    def _fused_bundle(cls, out: ViLBertOutput, label_logits: torch.Tensor,
                      task_ids: torch.Tensor, gqa_gather: torch.Tensor
                      ) -> dict:
        """Decode bundle for the fused heads: ONE f32 softmax/top-3 over the
        label head gathered per row by task id, written under BOTH label
        keys so :meth:`decode` stays family-agnostic. Padded label columns
        sit at heads.PAD_LOGIT_BIAS and underflow to probability zero."""
        f32 = lambda x: x.float()  # noqa: E731
        sel = gqa_gather[task_ids[:, 0].clamp(0, gqa_gather.shape[0] - 1)]
        row = torch.take_along_dim(f32(label_logits), sel[:, None, None],
                                   dim=1)[:, 0]
        top = torch.topk(torch.softmax(row, -1), cls._TOPK)
        pair = (top.values, top.indices)
        return {
            "labels_top": {"vil_prediction": pair,
                           "vil_prediction_gqa": pair},
            "vil_logit": f32(out.vil_logit),
            "vil_tri_prediction": f32(out.vil_tri_prediction),
            "vision_logit": f32(out.vision_logit),
            **({"vil_binary_prediction": f32(out.vil_binary_prediction)}
               if out.vil_binary_prediction is not None else {}),
        }

    # ------------------------------------------------------------ row slab
    def _row_slab(self) -> Dict[str, torch.Tensor]:
        """The device-resident row slab: one (S, Nv, ...) tensor per image
        input kind, S = 1 pad slot + cache slots + scratch slots.

        - slot 0 is the permanent padding row (zero features, the global
          box, mask[0] = 1 — features/pipeline.py batch_images): bucket
          padding references it by index and uploads nothing, ever;
        - slots 1..cache_entries hold content-stable store rows (LRU, keyed
          by the cache_keys from prepare());
        - the trailing max_batch_rows() scratch slots receive keyless rows,
          rotor-allocated per pack.

        Built once, on the device, and written in place thereafter (the
        graphs read it at a fixed address); see the module docstring for
        why in-place writes are safe.
        """
        if self._slab is None:
            with self._input_cache_lock:
                if self._slab is None:
                    ecfg, mcfg = self.cfg.engine, self.cfg.model
                    cache_slots = ecfg.device_input_cache_entries
                    scratch = ecfg.max_batch_rows()
                    n_rows = 1 + cache_slots + scratch
                    nv, dim = ecfg.max_regions, mcfg.v_feature_size
                    dev = self.device
                    with torch.inference_mode(), self._stream_ctx():
                        spat = torch.zeros((n_rows, nv, 5), device=dev)
                        spat[0, 0] = torch.from_numpy(GLOBAL_BOX).to(dev)
                        mask = torch.zeros((n_rows, nv), dtype=torch.int32,
                                           device=dev)
                        mask[0, 0] = 1
                        feats = torch.zeros((n_rows, nv, dim),
                                            dtype=self.transfer_dtype,
                                            device=dev)
                    if self._stream is not None:
                        self._stream.synchronize()
                    self._slab_scratch0 = 1 + cache_slots
                    self._slab_scratch_n = scratch
                    self._slab_free = list(range(1, 1 + cache_slots))
                    self._slab = dict(features=feats, spatials=spat,
                                      image_mask=mask)
        return self._slab

    def _row_slot_locked(self, key: Optional[str], inserts: dict,
                         host_row: dict) -> int:
        """Slab slot for one image row of a pack (caller holds
        _input_cache_lock): cache hit → existing slot; keyed miss → LRU
        cache slot + insert; keyless → next scratch slot + insert. Inserts
        are collected into ``inserts`` (slot → row) and written before the
        pack's forward.

        One departure from the JAX engine: a keyed miss that would evict a
        slot this same pack already reads (possible only when a pack holds
        more distinct keys than the cache has entries) takes a scratch
        slot and stays uncached. The JAX engine evicts it, and the earlier
        row of the pack then reads the later row's image."""
        if key is not None:
            slot = self._input_cache.get(key)
            if slot is not None:
                self._input_cache.move_to_end(key)
                self._input_cache_hits += 1
                return slot
            self._input_cache_misses += 1
            if self._slab_free:
                slot = self._slab_free.pop()
                self._input_cache[key] = slot
            elif next(iter(self._input_cache)) not in self._pack_keys:
                # Cache full: reuse the LRU entry's slot. Every forward
                # that read it was enqueued earlier on the engine stream,
                # so the overwrite lands after them.
                _, slot = self._input_cache.popitem(last=False)
                self._input_cache[key] = slot
            else:
                slot = None  # every entry is this pack's: scratch, uncached
            if slot is not None:
                inserts[slot] = host_row
                return slot
        # No stable identity → scratch rotor. One pack needs at most
        # max_batch_rows slots (= the scratch region size); a rotor wrap by
        # a later pack is ordered after this pack's forward.
        slot = self._slab_scratch0 + (
            self._scratch_next % self._slab_scratch_n)
        self._scratch_next += 1
        inserts[slot] = host_row
        return slot

    @property
    def input_cache_stats(self) -> Dict[str, int]:
        """entries/hits/misses of the device input cache (observability)."""
        with self._input_cache_lock:
            return {"entries": len(self._input_cache),
                    "hits": self._input_cache_hits,
                    "misses": self._input_cache_misses}

    def live_stats(self) -> Dict[str, float]:
        """Point-in-time engine internals for the obs sampler: slab/cache
        occupancy, captured-graph count, dispatch-breaker state. Cheap — a
        few lock holds, no device work. The keys are the JAX engine's
        (``engine_compiled_programs`` counts captured graphs)."""
        cache_slots = self.cfg.engine.device_input_cache_entries
        with self._input_cache_lock:
            free = (len(self._slab_free) if self._slab is not None
                    else cache_slots)
            stats = {
                "engine_cache_entries": float(len(self._input_cache)),
                "engine_slab_slots_used": float(cache_slots - free),
                "engine_slab_slots_total": float(cache_slots),
            }
        stats["engine_compiled_programs"] = float(len(self._graphs))
        with self._boot_lock:
            for phase, secs in self.boot_times.items():
                stats[f"engine_boot_{phase}"] = float(secs)
        stats["engine_breaker_open"] = float(
            self._breaker.state != "closed")
        return stats

    def _request_rows(self, req: PreparedRequest) -> List[tuple]:
        """A request's real image rows as (host_row, cache_key) pairs."""
        return [(dict(features=req.features[i], spatials=req.spatials[i],
                      image_mask=req.image_mask[i]),
                 req.cache_keys[i] if req.cache_keys is not None else None)
                for i in range(req.n_images)]

    # ------------------------------------------------------------- dispatch
    def _pack_host(self, text: dict, slots: Sequence[int]) -> np.ndarray:
        """The per-dispatch input: ``(bucket, 3·Nt + 2)`` int64 columns
        [input ids | segment ids | text mask | task id | slab slot]. A
        dispatch packs with every slot 0 (the pad row); :meth:`_run_rows`
        writes its rows' slots in."""
        return np.concatenate([
            np.asarray(text["input_ids"], np.int64),
            np.asarray(text["segment_ids"], np.int64),
            np.asarray(text["input_mask"], np.int64),
            np.asarray(text["task_ids"], np.int64).reshape(-1, 1),
            np.asarray(slots, np.int64)[:, None]], axis=1)

    def _upload(self, inserts: dict, pack: np.ndarray) -> List[torch.Tensor]:
        """Move a dispatch's pack and its new slab rows to the device (on
        the engine stream, inside the dispatch lock): ``[pack]`` or
        ``[pack, slots, features, spatials, image_mask]``. On the card all
        of it goes through one pinned staging buffer in one copy. The
        buffer goes back to PyTorch's pinned-memory cache when this returns,
        which hands it out again only after the event it recorded behind
        the non-blocking copy has completed: a copy still in flight never
        reads a refilled buffer."""
        parts = [torch.from_numpy(pack)]
        if inserts:
            rows = list(inserts.values())
            parts += [
                torch.tensor(list(inserts), dtype=torch.long),
                torch.stack([r["features"] for r in rows]),
                torch.from_numpy(np.stack([r["spatials"] for r in rows])),
                torch.from_numpy(np.stack([r["image_mask"] for r in rows]))]
        if self._stream is None:
            return parts
        spans, total = [], 0
        for t in parts:
            nbytes = t.numel() * t.element_size()
            spans.append((total, nbytes))
            total += _align(nbytes)
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)

        def views(b):
            return [b[o:o + n].view(t.dtype).view(t.shape)
                    for t, (o, n) in zip(parts, spans)]

        for dst, src in zip(views(buf), parts):
            dst.copy_(src)
        return views(buf.to(self.device, non_blocking=True))

    def _write_slab(self, slots: torch.Tensor, *rows: torch.Tensor) -> None:
        """Write uploaded rows (features, spatials, image_mask) into their
        slab slots, in place."""
        for name, t in zip(("features", "spatials", "image_mask"), rows):
            dst = self._slab[name]
            dst.index_copy_(0, slots, t.to(dst.dtype))

    def _rows_step(self, pack: torch.Tensor, collect_attention: bool = False
                   ) -> Tuple[ViLBertOutput, torch.Tensor, List[tuple]]:
        """One forward over a device pack: gather the rows from the slab
        by slot, run the trunk, the heads and the decode bundle, and
        flatten the bundle. What warmup captures per bucket."""
        nt = self.cfg.engine.max_text_len
        slots = pack[:, 3 * nt + 1]
        slab = self._slab
        image_mask = slab["image_mask"].index_select(0, slots)
        return self._forward(
            pack, slab["features"].index_select(0, slots),
            slab["spatials"].index_select(0, slots), image_mask,
            collect_attention)

    def _forward(self, pack: torch.Tensor, features: torch.Tensor,
                 spatials: torch.Tensor, image_mask: torch.Tensor,
                 collect_attention: bool
                 ) -> Tuple[ViLBertOutput, torch.Tensor, List[tuple]]:
        """The trunk, the heads and the flattened decode bundle over the
        pack's text columns and the rows' image inputs."""
        nt = self.cfg.engine.max_text_len
        task_ids = pack[:, 3 * nt:3 * nt + 1]
        args = (pack[:, :nt], features, spatials, pack[:, nt:2 * nt],
                pack[:, 2 * nt:3 * nt], image_mask, None, task_ids)
        if self.head_slabs is not None:
            trunk_out = self.model.trunk(
                *args, output_all_attention_masks=collect_attention)
            out, label_logits = fused_head_output(
                self.model_config, self.head_slabs, trunk_out, image_mask,
                self.compute_dtype)
            bundle = self._fused_bundle(out, label_logits, task_ids,
                                        self._gqa_gather)
        else:
            out = self.model(
                *args, output_all_attention_masks=collect_attention,
                compute_pretraining_heads=False)
            bundle = self._decode_bundle(out)
        flat, spec = _flatten_bundle(bundle, pack.shape[0])
        return out, flat, spec

    def _call_forward(self, fn):
        """All device forwards funnel through here — resilience gate first:
        ``fault_point("engine.dispatch")`` lets a chaos plan flap/slow the
        device path, a killed replica fails fast, and the breaker turns
        sustained dispatch failures into fast fails."""
        fault_point("engine.dispatch")
        if self.killed:
            raise ReplicaKilled(
                f"engine replica {self.replica_id or '?'} is dead")
        self._breaker.preflight()
        try:
            result = fn()
        except Exception:
            self._breaker.record_failure()
            raise
        self._breaker.record_success()
        return result

    def _stream_ctx(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _run_rows(self, bucket: int, collect_attention: bool,
                  pack: np.ndarray, rows: Sequence[tuple], *,
                  keep_out: bool = False) -> _Dispatch:
        """Enqueue one dispatch of the host ``pack`` (:meth:`_pack_host`,
        every slot 0): resolve each (host_row, cache_key) to a slab slot
        (``engine.cache``; pad slots stay 0), upload the new rows and the
        pack and write the slab (``engine.upload``), then the forward — the
        bucket's graph when one is captured and no attention maps are asked
        for, else eager — and the bundle's copy to pinned host memory
        (``engine.replay``). Returns without waiting on the card.
        ``keep_out`` keeps the model output (copied off the graph's static
        tensors)."""
        if self.mesh is not None:
            return self._mesh_run(bucket, collect_attention, pack, rows,
                                  keep_out)
        self._row_slab()  # built outside the (non-reentrant) lock hold
        with self._dispatch_lock, torch.inference_mode(), \
                self._stream_ctx():
            inserts: dict = {}
            with obs.span("engine.cache") as sp, self._input_cache_lock:
                hits, misses = (self._input_cache_hits,
                                self._input_cache_misses)
                self._pack_keys = set()  # keys this pack reads (hits too)
                for i, (row, key) in enumerate(rows):
                    pack[i, -1] = self._row_slot_locked(key, inserts, row)
                    if key is not None:
                        self._pack_keys.add(key)
                sp.set(hits=self._input_cache_hits - hits,
                       misses=self._input_cache_misses - misses)
            with obs.span("engine.upload", rows=len(inserts)):
                parts = self._upload(inserts, pack)
                if inserts:
                    self._write_slab(*parts[1:])
            graph = (None if collect_attention
                     else self._graphs.get(bucket))

            with obs.span("engine.replay", bucket=bucket,
                          graph=graph is not None) as sp:
                # Timing events only while the span records: engine.fetch
                # reads them then, and an untimed event is cheaper.
                timed = sp.recording and self._stream is not None
                start = torch.cuda.Event(enable_timing=True) if timed else None

                def forward():
                    if start is not None:
                        start.record(self._stream)
                    if graph is None:
                        return self._rows_step(parts[0], collect_attention)
                    graph.static_pack.copy_(parts[0])
                    graph.replay()
                    return graph.out, graph.flat, graph.spec

                out, flat, spec = self._call_forward(forward)
                if self._stream is None:
                    return _Dispatch(flat, spec, None,
                                     out if keep_out else None)
                if keep_out:
                    out = _clone_output(out) if graph is not None else out
                host = torch.empty(flat.shape, dtype=torch.float32,
                                   pin_memory=True)
                host.copy_(flat, non_blocking=True)
                event = torch.cuda.Event(enable_timing=timed)
                event.record(self._stream)
                return _Dispatch(host, spec, event,
                                 out if keep_out else None, start)

    # ------------------------------------------------------------- the mesh
    # A dispatch's header, broadcast from rank 0 on the host over the idle
    # group: [op, bucket, collect, keep_out]. _OP_STOP ends follow();
    # _OP_LOAD swaps the weights (its bucket field is the byte count of the
    # load's request, broadcast next).
    _OP_STOP, _OP_FORWARD, _OP_LOAD = 0, 1, 2

    def _mesh_rows(self, rows: Sequence[tuple], bucket: int):
        """A dispatch's image inputs as dense host tensors (bucket, Nv, ·):
        the real rows, then pad rows (zero features, the global box,
        mask[0] = 1: the slab's slot 0)."""
        nv = self.cfg.engine.max_regions
        dim = self.cfg.model.v_feature_size
        feats = torch.zeros((bucket, nv, dim), dtype=self.transfer_dtype)
        spat = torch.zeros((bucket, nv, 5))
        mask = torch.zeros((bucket, nv), dtype=torch.int32)
        spat[:, 0] = torch.from_numpy(GLOBAL_BOX)
        mask[:, 0] = 1
        for i, (row, _key) in enumerate(rows):
            feats[i] = torch.as_tensor(row["features"]).to(feats.dtype)
            spat[i] = torch.as_tensor(np.asarray(row["spatials"]))
            mask[i] = torch.as_tensor(np.asarray(row["image_mask"]))
        return feats, spat, mask

    def _mesh_exchange(self, header: Optional[torch.Tensor] = None,
                       payload=None):
        """One mesh dispatch, on every rank (rank 0 passes the header and
        the host payload; the others receive them): broadcast, this
        rank's dp rows, the forward, and the bundle's rows (and, when
        kept, the output) gathered over dp. Returns (out, host bundle,
        spec), (bytes broadcast,) after a load (:meth:`_mesh_load`, whose
        request and tree are the payload), or None at a stop message."""
        world = world_axis(self.mesh)
        head = header if header is not None else torch.zeros(
            4, dtype=torch.long)
        op, bucket, collect, keep_out = comm.broadcast(
            head, self._idle).tolist()
        if op == self._OP_STOP:
            return None
        if op == self._OP_LOAD:
            return self._mesh_load(payload, bucket)
        ecfg, nt = self.cfg.engine, self.cfg.engine.max_text_len
        nv, dim = ecfg.max_regions, self.cfg.model.v_feature_size
        shapes = (((bucket, 3 * nt + 2), torch.long),
                  ((bucket, nv, dim), self.transfer_dtype),
                  ((bucket, nv, 5), torch.float32),
                  ((bucket, nv), torch.int32))
        parts = []
        for i, (shape, dt) in enumerate(shapes):
            t = (payload[i].to(self.device) if payload is not None
                 else torch.empty(shape, dtype=dt, device=self.device))
            parts.append(comm.broadcast(t, world))
        batch = shd.place_batch(
            dict(zip(("pack", "features", "spatials", "image_mask"), parts)),
            self.mesh, global_batch=True)
        out, flat, spec = self._forward(
            batch["pack"], batch["features"], batch["spatials"],
            batch["image_mask"], bool(collect))
        dp = mesh_axis(self.mesh, "dp")
        rows_sharded = shd.shards_batch(bucket, dp.size)
        if rows_sharded:  # every leaf's leading dim counts rows (or pairs)
            flat = comm.all_gather(flat, dp, 0)
            spec = [(path, (shape[0] * dp.size, *shape[1:]), is_float)
                    for path, shape, is_float in spec]
        if keep_out:
            out = self._gather_output(out, rows_sharded)
        return out, flat.cpu(), spec

    def _gather_output(self, out: ViLBertOutput, rows_sharded: bool
                       ) -> ViLBertOutput:
        """The model output of every rank's rows (and every tp rank's
        heads of the attention maps), on every rank."""
        dp, tp = mesh_axis(self.mesh, "dp"), mesh_axis(self.mesh, "tp")

        def rows(x):
            return comm.all_gather(x, dp, 0) if rows_sharded else x

        fields = {f.name: rows(getattr(out, f.name))
                  for f in dataclasses.fields(out)
                  if isinstance(getattr(out, f.name), torch.Tensor)}
        heads = self.model_config.bi_num_attention_heads
        fields["attn_data_list"] = [
            tuple(None if p is None else rows(
                p if p.shape[1] == heads else comm.all_gather(p, tp, 1))
                  for p in maps) for maps in out.attn_data_list]
        return dataclasses.replace(out, **fields)

    def _mesh_run(self, bucket: int, collect_attention: bool,
                  pack: np.ndarray, rows: Sequence[tuple], keep_out: bool
                  ) -> _Dispatch:
        """Rank 0's dispatch on a mesh (see :meth:`_mesh_exchange`)."""
        if world_axis(self.mesh).index != 0:
            raise RuntimeError("on a mesh only rank 0 dispatches; the other "
                               "ranks run follow()")
        pack = torch.from_numpy(pack)
        header = torch.tensor([self._OP_FORWARD, bucket,
                               int(collect_attention), int(keep_out)])
        with self._dispatch_lock, torch.inference_mode(), \
                self._stream_ctx():
            out, host, spec = self._call_forward(
                lambda: self._mesh_exchange(
                    header, (pack, *self._mesh_rows(rows, bucket))))
        return _Dispatch(host, spec, None, out if keep_out else None)

    def follow(self) -> None:
        """The ranks other than 0 of a mesh: run every dispatch rank 0
        broadcasts, collectives included, until it sends the stop message
        (:meth:`stop_followers`)."""
        if self.mesh is None:
            raise RuntimeError("follow() needs a mesh")
        while True:
            with self._dispatch_lock, torch.inference_mode(), \
                    self._stream_ctx():
                if self._mesh_exchange() is None:
                    return

    def stop_followers(self) -> None:
        """Rank 0 of a mesh: end every other rank's :meth:`follow`."""
        if self.mesh is None or world_axis(self.mesh).size == 1:
            return
        with self._dispatch_lock, self._stream_ctx():
            self._mesh_exchange(torch.tensor([self._OP_STOP, 0, 0, 0]))

    def bundle(self, req: PreparedRequest, *, collect_attention: bool = False
               ) -> Tuple[ViLBertOutput, dict]:
        """Upload, trunk + heads + decode bundle on the device, and the one
        blocking fetch of the few-KB bundle → (device output, host bundle)."""
        with obs.span("engine.pack"):
            pack = self._pack_host(dict(
                input_ids=req.text.input_ids,
                segment_ids=req.text.segment_ids,
                input_mask=req.text.input_mask, task_ids=req.task_ids),
                [0] * req.bucket)
        d = self._run_rows(req.bucket, collect_attention, pack,
                           self._request_rows(req), keep_out=True)
        return d.out, d.fetch()

    def run(self, req: PreparedRequest, *, collect_attention: bool = False,
            deadline=None) -> Tuple[ViLBertOutput, dec.TaskResult]:
        """Device forward for a prepared request → (output, decoded result).

        ``deadline`` (a :class:`resilience.Deadline`) is checked at entry:
        an expired budget raises :class:`DeadlineExceeded` before any
        device work. The ``engine.forward`` span covers pack, upload,
        forward and the bundle fetch; decode is then pure host math."""
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded(
                f"deadline expired {-deadline.remaining_s():.2f}s before "
                f"dispatch (task {req.spec.task_id})")
        with obs.span("engine.forward", bucket=req.bucket,
                      task_id=req.spec.task_id,
                      replica=self.replica_id or ""):
            out, bundle = self.bundle(req,
                                      collect_attention=collect_attention)
        with obs.span("engine.decode", task_id=req.spec.task_id):
            result = self.decode(req, bundle)
        return out, result

    def run_many(self, reqs: Sequence[PreparedRequest], *,
                 chunk_rows: Optional[int] = None, deadline=None,
                 on_result=None) -> List[dec.TaskResult]:
        """Cross-task micro-batching: many requests, few forwards.

        Every head computes over the whole batch anyway (the trunk
        dominates), and per-row ``task_ids`` keep the task-token
        embeddings per request, so any mix of tasks packs into one chunk.
        Multi-image requests (NLVR2 pairs, retrieval) share chunks too: a
        request's rows stay consecutive and even-image-count requests lead
        each chunk (see :meth:`chunk_plan`).

        At most ``_MAX_INFLIGHT_CHUNKS`` chunks are enqueued ahead of the
        oldest fetch, so the host packs chunk k+1 while the card computes
        chunk k. ``on_result(pos, result)`` streams each member's decoded
        result as its chunk drains; exceptions from the callback
        propagate. ``deadline`` is checked once at entry.

        Under its ``engine.run_many`` span each chunk opens ``engine.pack``,
        ``engine.cache``, ``engine.upload``, ``engine.replay``,
        ``engine.fetch`` and ``engine.decode``.
        """
        if not reqs:
            return []
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded(
                f"deadline expired {-deadline.remaining_s():.2f}s before "
                f"batch dispatch ({len(reqs)} requests)")
        plan = self.chunk_plan([r.n_images for r in reqs],
                               chunk_rows=chunk_rows)
        chunks = [[(pos, reqs[pos]) for pos in idxs] for idxs in plan]
        out: List[Optional[dec.TaskResult]] = [None] * len(reqs)
        pending: deque = deque()

        def _drain_one() -> None:
            c, dispatch = pending.popleft()
            bundle = dispatch.fetch()
            with obs.span("engine.decode", n_requests=len(c)):
                row = 0
                for pos, r in c:
                    out[pos] = self.decode(r, bundle, row=row)
                    row += r.n_images
                    if on_result is not None:
                        on_result(pos, out[pos])

        with obs.span("engine.run_many", replica=self.replica_id or "",
                      n_requests=len(reqs), n_chunks=len(chunks)):
            for c in chunks:
                pending.append((c, self._dispatch_many([r for _, r in c])))
                if len(pending) >= self._MAX_INFLIGHT_CHUNKS:
                    _drain_one()
            while pending:
                _drain_one()
        return out

    def chunk_plan(self, image_counts: Sequence[int], *,
                   chunk_rows: Optional[int] = None) -> List[List[int]]:
        """run_many's packing, exposed: request indices per chunk.

        Chunks pack at the largest row bucket (``max_batch_rows``) unless
        ``chunk_rows`` says otherwise (it must fit a row bucket). Mixed
        image counts share chunks; two invariants make that safe:

        - a request's rows stay consecutive (each chunk lists whole
          requests; :meth:`_dispatch_many` packs spans in plan order);
        - even-image-count requests precede odd ones inside a chunk, so
          every even-count request starts at an even row offset — the
          binary head pairs batch rows 2k/2k+1, and NLVR2's pair must be
          one of those pairs.

        This is the one copy of the packing arithmetic: run_many executes
        it and :meth:`padded_rows` counts from it.
        """
        max_bucket = (chunk_rows if chunk_rows is not None
                      else self.cfg.engine.max_batch_rows())
        self.cfg.engine.row_bucket_for(max_bucket)  # raises on <1 or misfit
        for n in image_counts:
            if n > max_bucket:
                raise ValueError(
                    f"request with {n} images exceeds the "
                    f"{max_bucket}-row chunk; raise throughput_buckets or "
                    f"chunk_rows")
        order = ([i for i, n in enumerate(image_counts) if n % 2 == 0]
                 + [i for i, n in enumerate(image_counts) if n % 2])
        chunks: List[List[int]] = []
        cur: List[int] = []
        cur_rows = 0
        for i in order:
            n = image_counts[i]
            if cur_rows + n > max_bucket:
                chunks.append(cur)
                cur, cur_rows = [], 0
            cur.append(i)
            cur_rows += n
        if cur:
            chunks.append(cur)
        return chunks

    def padded_rows(self, image_counts: Sequence[int], *,
                    chunk_rows: Optional[int] = None) -> int:
        """Total device rows a run_many over these requests dispatches,
        bucket padding included — the work term of rows/s and FLOP
        accounting."""
        counts = list(image_counts)
        return sum(
            self.cfg.engine.row_bucket_for(sum(counts[i] for i in chunk))
            for chunk in self.chunk_plan(counts, chunk_rows=chunk_rows))

    def _dispatch_many(self, reqs: Sequence[PreparedRequest]) -> _Dispatch:
        """Pack one ≤max-bucket chunk and enqueue its forward. A request's
        rows (one per image, text replicated) stay consecutive, in request
        order; pad rows repeat the last row's text and read slab slot 0."""
        with obs.span("engine.pack"):
            spans = [(r, i) for r in reqs for i in range(r.n_images)]
            bucket = self.cfg.engine.row_bucket_for(len(spans))
            pad = bucket - len(spans)

            def stack(rows, pad_row):
                return np.stack(list(rows) + [pad_row] * pad, axis=0)

            last = reqs[-1]
            text = dict(
                input_ids=stack([r.text.input_ids[i] for r, i in spans],
                                last.text.input_ids[-1]),
                segment_ids=stack([r.text.segment_ids[i] for r, i in spans],
                                  last.text.segment_ids[-1]),
                input_mask=stack([r.text.input_mask[i] for r, i in spans],
                                 last.text.input_mask[-1]),
                task_ids=stack([r.task_ids[i] for r, i in spans],
                               last.task_ids[-1]),
            )
            pack = self._pack_host(text, [0] * bucket)
            rows = [(dict(features=r.features[i], spatials=r.spatials[i],
                          image_mask=r.image_mask[i]),
                     r.cache_keys[i] if r.cache_keys is not None else None)
                    for r, i in spans]
        return self._run_rows(bucket, False, pack, rows)

    # --------------------------------------------------------------- warmup
    def warmup(self, buckets: Optional[Sequence[int]] = None,
               parallel: Optional[bool] = None) -> None:
        """Make every row bucket ready before the first request: on the
        card, capture one CUDA graph per bucket (engine/graphs.py); on the
        CPU, run each bucket's forward once.

        Default buckets: ``all_row_buckets()`` — the image buckets (run())
        and the throughput buckets (run_many). Each bucket first runs its
        step eagerly on the engine stream over a pack of pad rows, then is
        captured. ``parallel`` is accepted for the serve tier's seam and
        unused on this backend: capture is not thread-safe the way XLA
        compiles are, so buckets capture one at a time. A failed capture
        raises.
        """
        del parallel  # one bucket at a time (see above)
        if self.mesh is not None:
            return  # a mesh runs its forwards eagerly (no graphs)
        buckets = list(buckets if buckets is not None
                       else self.cfg.engine.all_row_buckets())
        self._row_slab()
        nt = self.cfg.engine.max_text_len
        for b in buckets:
            if b in self._graphs:
                continue
            t0 = time.perf_counter()
            with self._dispatch_lock, torch.inference_mode(), \
                    self._stream_ctx():
                pack = torch.zeros((b, 3 * nt + 2), dtype=torch.long,
                                   device=self.device)
                pack[:, 2 * nt:3 * nt] = 1  # text mask; slot 0 = pad row
                self._rows_step(pack)
                if self._stream is None:
                    continue
                self._stream.synchronize()
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                self._graphs[b] = graphs.capture(
                    b, self._rows_step, pack, stream=self._stream,
                    pool=self._graph_pool)
            seconds = time.perf_counter() - t0
            self.book_boot_time("compile_s", seconds)
            self.book_boot_time("capture_s", seconds)

    # ---------------------------------------------------------------- decode
    def decode(self, req: PreparedRequest, bundle: dict, row: int = 0
               ) -> dec.TaskResult:
        """Decode one request from the host decode bundle, batch row ``row``."""
        spec = req.spec
        if spec.decode == "labels":
            top_p, top_i = bundle["labels_top"][spec.head]
            return dec.decode_labels_topk(spec, np.asarray(top_i)[row],
                                          np.asarray(top_p)[row], self.labels)
        if spec.decode == "binary":
            # paired head: batch row 2k/2k+1 → pair row k (row must be even)
            return dec.decode_binary(
                spec, np.asarray(bundle["vil_binary_prediction"])[row // 2])
        if spec.decode == "trinary":
            return dec.decode_trinary(
                spec, np.asarray(bundle["vil_tri_prediction"])[row])
        if spec.decode == "ranking":
            scores = np.asarray(bundle["vil_logit"])[
                row: row + len(req.images)]
            return dec.decode_ranking(spec, scores, req.images)
        if spec.decode == "grounding":
            return dec.decode_grounding(
                spec, np.asarray(bundle["vision_logit"])[row],
                req.spatials[0], req.images[0])
        raise ValueError(f"unknown decode family {spec.decode}")

    def predict(self, task_id: int, question: str,
                image_paths: Sequence[str], *,
                collect_attention: bool = False) -> dec.TaskResult:
        """Full request path: feature lookup → prepare → forward → decode."""
        if self.feature_store is None:
            raise RuntimeError("predict() needs a FeatureStore; use "
                               "prepare()+run() with in-memory regions instead")
        req = self.prepare_from_store(task_id, question, image_paths)
        _, result = self.run(req, collect_attention=collect_attention)
        return result
