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
vector, the trunk (including the hand-written flash kernel's 18 launches and,
in the int8 storage mode, the int8 GEMM's),
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
  run. A wrapper called while its thread's current stream is capturing
  counts into its thread-local ``recorded`` tally instead of
  ``launches`` (capture launches nothing), :func:`capture` reads that
  tally, and :meth:`BucketGraph.replay` adds it to ``launches`` for every
  replay: the counters keep counting kernel launches on the card, also
  while other threads launch during a capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from vilbert_multitask_tpu_torch.detect.model import roi_align
from vilbert_multitask_tpu_torch.ops.coattention import flash_cross_attention
from vilbert_multitask_tpu_torch.ops.int8_linear import int8_linear
from vilbert_multitask_tpu_torch.ops.nms import nms_mask

# Every hand-written kernel's wrapper (each carries a ``launches`` count).
KERNEL_WRAPPERS = (flash_cross_attention, nms_mask, roi_align, int8_linear)


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
    for w in KERNEL_WRAPPERS:
        w.recorded.n = 0
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out, flat, spec = step(static_pack)
    recorded = {w: w.recorded.n for w in KERNEL_WRAPPERS if w.recorded.n}
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
