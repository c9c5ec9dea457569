"""One CUDA graph per row bucket: the engine's forward, recorded once at
warmup and replayed for every request of that bucket.

Counterpart of the JAX engine's per-bucket compiled program
(``vilbert_multitask_tpu/engine/runtime.py``: ``_forward_rows`` and the
AOT-cached ``_AotProgram``). XLA turns the whole forward into one program
per shape; eager PyTorch launches some 650 kernels per bucket-1 request
from Python, and the card waits on the host for most of the request. A
graph captured over static input buffers replays all of them with one
host call.

What is captured, for one bucket (:meth:`InferenceEngine._rows_step`):
the gather of the request's image rows from the device row slab by a slot
vector, the trunk (including the hand-written flash kernel's 18 launches,
the residual-add LayerNorm's and the text attentions' dense-core kernels
and, in the int8 storage mode, the int8 GEMM's),
the fused heads, and the softmax/top-3 decode bundle flattened into one
f32 tensor. The inputs are one static ``(bucket, 3·Nt + 2)`` int64 pack
(text ids, segment ids, text mask, task id, slab slot per row); the slab,
the weights and the head slabs are read at fixed addresses, so the engine
updates them in place only (``load_params`` copies into them).

- Capture runs one bucket at a time on the engine's stream, after one
  eager run of the same step on that stream (that first launch sets the
  flash kernel's shared-memory limit and warms cuBLAS outside capture).
  A failed capture raises; nothing carries on eagerly in its place.
- All buckets share one graph memory pool. Replays are ordered on the one
  engine stream and each replay's outputs are copied out before the next
  replay is enqueued, so the buckets never need their intermediates at
  the same time.
- Capture uses CUDA's ``thread_local`` capture mode. Other replicas of a
  pool keep dispatching from other threads while one replica captures
  (scale-out, re-warm), and their allocator misses, pinned allocations
  and event waits are calls that the default ``global`` mode forbids
  while any capture is open: the capture then fails with
  ``cudaErrorStreamCaptureInvalidated``. Only the capturing thread is held
  to the capture rules, and it makes no unsafe call inside the captured
  step.
- A kernel wrapper counts its launches in Python, which a replay does not
  run. A call made while its thread's stream captures launches nothing
  and is recorded instead (``ops/routes.py``); :func:`capture` takes what
  its thread recorded, and :meth:`BucketGraph.replay` adds it to each
  wrapper's ``launches`` for every replay: the counters keep counting
  kernel launches on the card, also while other threads launch during a
  capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from vilbert_multitask_tpu_torch.config import EngineConfig
from vilbert_multitask_tpu_torch.ops import dense_attention as dense_ops
from vilbert_multitask_tpu_torch.ops import routes


def launches_per_forward(mcfg, rows: int, *,
                         collect_attention: bool = False,
                         ecfg: Optional[EngineConfig] = None
                         ) -> Dict[str, int]:
    """Launches of the trunk's and heads' kernels in one served forward of
    ``rows`` image rows with the engine's kernels on (``use_pallas_*`` as
    ``EngineConfig``'s default; the compute dtype, text length and region
    count of ``ecfg``, by default ``EngineConfig()``), by kernel (the int8
    storage mode adds ``int8_linear``'s):

    - ``flash_attn``: each self-attention whose head_dim passes the
      ``% 128`` gate, both directions of each bridge unless its maps are
      collected;
    - ``dense_attention``: each other self-attention that the dense core's
      gate takes (``ops/dense_attention.py:fits``: bf16, head_dim % 16, at
      most 128 keys);
    - ``scaled_masked_softmax``: every other attention (an f32 engine's,
      the bridges' when their maps are collected);
    - ``add_layer_norm``: after each attention and each feed-forward (2 a
      single-stream layer, 4 a bridge), one per embedding, the label
      pair's grouped one, and the NLVR2 head's when ``rows`` is even.
    """
    ecfg = ecfg or EngineConfig()
    dtype = getattr(torch, ecfg.compute_dtype)

    def flash(hidden: int, heads: int) -> bool:
        return (hidden // heads) % 128 == 0

    def dense(hidden: int, heads: int, keys: int) -> bool:
        return (not flash(hidden, heads)
                and dense_ops.fits(hidden // heads, keys, dtype))

    bridges = len(mcfg.v_biattention_id)
    text = flash(mcfg.hidden_size, mcfg.num_attention_heads)
    visual = flash(mcfg.v_hidden_size, mcfg.v_num_attention_heads)
    bridge = not collect_attention
    n_flash = (mcfg.num_hidden_layers * text
               + mcfg.v_num_hidden_layers * visual + 2 * bridges * bridge)
    # Text rows are max_text_len tokens and the task token.
    n_dense = (mcfg.num_hidden_layers * dense(
        mcfg.hidden_size, mcfg.num_attention_heads, ecfg.max_text_len + 1)
        + mcfg.v_num_hidden_layers * dense(
            mcfg.v_hidden_size, mcfg.v_num_attention_heads,
            ecfg.max_regions))
    n_attn = (mcfg.num_hidden_layers + mcfg.v_num_hidden_layers
              + 2 * bridges)
    return {"flash_attn": n_flash,
            "dense_attention": n_dense,
            "scaled_masked_softmax": n_attn - n_flash - n_dense,
            "add_layer_norm": (2 * mcfg.num_hidden_layers
                               + 2 * mcfg.v_num_hidden_layers + 4 * bridges
                               + 2 + 1 + (rows % 2 == 0))}


@dataclasses.dataclass
class BucketGraph:
    """A captured forward and the static tensors it reads and writes."""

    bucket: int
    graph: "torch.cuda.CUDAGraph"
    static_pack: torch.Tensor  # (bucket, 3·Nt + 2) int64, copied into
    out: object  # the ViLBertOutput of the captured step (static tensors)
    flat: torch.Tensor  # (bucket, W) f32 decode bundle (static)
    spec: List[tuple]  # how to unflatten ``flat`` (runtime._flatten_bundle)
    launches: Dict[Callable, int]  # per wrapper, kernel launches per replay
    capture_s: float

    def replay(self) -> None:
        """Enqueue the recorded launches on the stream they were captured
        on (the engine's), and count them."""
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n


def capture(bucket: int, step: Callable[[torch.Tensor], Tuple],
            static_pack: torch.Tensor, *, stream: "torch.cuda.Stream",
            pool) -> BucketGraph:
    """Record ``step(static_pack) -> (out, flat, spec)`` into a CUDA graph
    on ``stream``, sharing the memory ``pool``. The caller has run ``step``
    eagerly on ``stream`` once already. Raises on any capture error."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with routes.recording() as recorded, torch.cuda.graph(
            graph, pool=pool, stream=stream,
            capture_error_mode="thread_local"):
        out, flat, spec = step(static_pack)
    stream.synchronize()
    return BucketGraph(bucket, graph, static_pack, out, flat, spec,
                       recorded, time.perf_counter() - t0)


def pool_bytes(pool, device) -> Optional[float]:
    """Bytes of device memory held by the segments of graph memory pool
    ``pool`` (from the caching allocator's snapshot), or None when this
    PyTorch's snapshot does not name segment pools."""
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    want = tuple(pool)
    idx = torch.device(device).index
    return float(sum(
        s["total_size"] for s in segments
        if tuple(s["segment_pool_id"]) == want
        and (idx is None or s.get("device", idx) == idx)))
