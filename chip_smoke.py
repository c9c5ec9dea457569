#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc; without a CUDA device it exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.

Phases (any failure exits non-zero; nothing is caught and carried on):

1. device: the card's name and power limit (nvidia-smi), and whether PIL
   is installed;
2. build: every kernel of the port from ``vilbert_multitask_tpu_torch/csrc``
   (``flash_attn``, ``int8_linear``, ``nms``, ``roi_align``), one nvcc per
   source, all
   started together; per kernel instantiation, the registers, shared memory
   and spills ptxas reports (any spill fails) and the count of tensor-core
   (``HMMA``), async-copy (``LDGSTS``) and ``ldmatrix`` (``LDSM``)
   instructions in its SASS (a bf16 kernel without the first two fails);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and at the edges of its tiles, widths and masks:
   ``flash_attn`` in f32 (max abs error <= 2e-5, the JAX package's own
   kernel tolerance) and bf16, also at a tp = 2 rank's shapes (4 local
   heads of 128 at the serving buckets); ``nms`` keep masks identical at the RPN
   (5 x 1000) and selection (1600 x 300, one shared box set) shapes, N off
   the 64-box words, ragged groups, identical, disjoint and tied boxes,
   IoUs exactly at the threshold, shared box sets of 1000 (ragged counts,
   the mask staged in shared memory) and 2100 boxes (the mask from L2),
   and the selection shape with exact-zero and tied scores and degenerate
   boxes, each case's launch plan printed and every route of the kernel
   required; ``roi_align`` within atol 1e-5 + rtol 1e-5 (the serving shape
   bit-equal) at 300 proposals over the 1344-canvas P2..P5 maps, boxes on
   level boundaries, off the canvas, of zero area, each level alone, with
   sqrt(area)/224 exactly 1, 2 and 4 and 1 and 8 ulps either side (the
   kernel chooses the level), and on map views of 255 channels and of a
   base 4 bytes off (the scalar instance); ``int8_linear`` in
   bf16 (atol 1e-2 + rtol 1e-2) and f32 (2e-5 x max(1, |ref|)) at every
   (N, K) of the full-width forward at M = 38·{1, 32} and 101·{1, 32}, at
   the shapes of a bucket-1 and a bucket-32 forward, at the edges (M = 1,
   15, 17; N = 1, 3, 4, 3129; K = 5 and 37, the element-wise x path; K off
   the 64-deep tiles) and on strided x, the trunk's and the head slabs'
   scale paths in turns, each launch's plan (kernel, tile, splits, blocks)
   printed and two launches on the same inputs bit-identical; per serving
   shape,
   the kernel's device time (calls captured in a CUDA graph, replays timed
   by CUDA events, median), the plain version's, the yardstick library
   call's where one exists (``scaled_dot_product_attention``; ``F.linear``
   on the pre-dequantized bf16 weight for ``int8_linear``, and
   ``aten._weight_int8pack_mm`` where this PyTorch runs it on CUDA; never
   called by the port; none computes NMS or this ROIAlign), the same as eager
   back-to-back calls (host launch cost included), the least time the
   card could take (``bound_ms``), and for ``int8_linear`` at the shapes
   of the two forwards the kernel's and ``F.linear``'s time with the
   weights cold in L2 (a pass over copies larger than the L2);
detect. the detector at full width (``LiveFeatureExtractor(DetectorConfig())``,
   X-152-32x8d-FPN, canvas 1344, seeded weights) on four seeded images
   (160x120 upscaled, 640x480, 1333x800, 2000x1500 downscaled): 2 ``nms``
   and 1 ``roi_align`` launches per ``extract_array``, finite regions, RPN
   and class scores spread (not saturated, not tied); the same images
   through the plain kernel versions on the same convolutions: identical
   proposals and kept indices, fc6 within the ``roi_align`` tolerance;
   device time per image (CUDA events, p50 of 12 warm runs), the
   extraction's wall time, a ``torch.profiler`` split by stage (backbone,
   FPN, RPN + nms, roi_align, box head, selection, preprocessing, host
   copy), and TF32 convolutions against f32 in turns;
4. main path: ``InferenceEngine(device="cuda")`` at the full serving config
   (``ViLBertConfig()`` + ``EngineConfig()``: bf16 compute, fused heads) on
   seeded random weights answers one request per decode family through
   ``predict`` from seeded ``.npy`` feature files; the kernel launch counter
   must rise by exactly 18 per forward; the same requests through a card-f32
   engine and a CPU-f32 engine (plain versions) on the same weights must
   agree with it; ``run(collect_attention=True)`` returns the bridge maps
   (bridges dense, 6 kernel launches); then the p50 of ``run`` at bucket 1;
5. graphs: ``warmup()`` captures one CUDA graph per row bucket (1, 2, 4,
   8, 10, 16, 32) on the same engine; per bucket, the decode bundle of a
   graph replay against the eager forward on the same packed rows (expected
   bit-equal; fails beyond rtol 0.1 / atol 0.05), and a ``torch.profiler``
   trace of one bucket-1 replay must hold exactly 18
   ``flash_attn_bf16_kernel`` launches; capture time and graph-pool memory;
6. batched: ``run_many`` over a mixed backlog of 40 requests (VQA, GQA,
   SNLI-VE, NLVR2 pairs, retrieval over 4 images, grounding) packed by
   ``chunk_plan``, chunk by chunk against ``run()`` of each request on the
   same engine (bundles within rtol 0.1 / atol 0.05, identical top-1
   labels), input-cache hits on the repeated images; rows/s of 32-row
   chunks; the p50 of ``run()`` at bucket 1 through the graph and eagerly;
int8. the int8 storage mode's main path at full width: seed-0 weights
   saved with ``checkpoint.save_params`` and restored with
   ``restore_params(dtype="int8")``, an ``InferenceEngine(device="cuda")``
   with ``EngineConfig(param_dtype="int8")``; one request per decode family
   through ``predict`` with exactly 189 (bucket 1; 191 at even buckets)
   ``int8_linear`` and 18 ``flash_attn`` launches per forward; bundles
   within rtol 0.1 / atol 0.05 of a CPU-f32 int8 engine on the same
   quantized tree and within 0.15 / 0.15 of phase 4's bf16 engine; the
   weights' device memory against a bf16 engine's; 7 bucket graphs, each
   replay against eager; ``run()`` p50 (graph, eager) and ``run_many``
   rows/s of the int8 and bf16 engines in turns (bf16, int8, int8, bf16);
   how many seeded top-1 answers int8 changes; a ``rolling_swap`` of the
   f32 checkpoint re-quantizes it to the same tensors and answers; the
   roofline lines of the bf16 and int8 engines: at bucket 1 and 32 rows,
   ``serving_forward_flops``, the device time of a forward (its bucket
   graph replayed between CUDA events on the engine stream), the stream's
   wall around ``run()`` and a 32-row ``run_many`` chunk, the achieved
   TFLOP/s and its share of the card's peak (``mfu``), beside
   ``serving_roofline``'s ``achievable_mfu`` and reason and ``knee_rows``
   for this card's name (engine/flops.py);
cli. ``python -m vilbert_multitask_tpu_torch.evals.harness --task vqa``
   on seeded data over phase 4's feature files prints the in-process
   Evaluator's scores on phase 4's engine, and ``python -m
   vilbert_multitask_tpu_torch.checkpoint.onboard`` on a seeded
   upstream-layout ``.bin`` exits 0 holding that score, each in its own
   process on the card;
boot. the kernel-library cache (engine/aotcache.py): ``python -m
   vilbert_multitask_tpu_torch.engine.prewarm`` for the bf16, int8 and
   live-extract variants, one after another, into an empty directory
   under ``vilbert_multitask_tpu_torch/_build/`` (each library's cold nvcc
   seconds; each kernel launched once and held against its plain
   version), then the three again at once (0 misses); two ``ServeApp``
   boots sharing one fresh directory, the first cold, the second warm
   (it must build nothing), each with its ``boot_phases`` and wall;
7. served: ``ServeApp(live_extract=True)`` on the same engine
   (``http_port=0``; a full-width seeded detector): the six decode families
   and 8 VQA submits posted over HTTP one at a time (each its own forward:
   every answer equal to ``predict()`` on the same engine, the same labels,
   numbers within rtol 0.1 / atol 0.05), then 4 images with no feature
   file uploaded over ``/upload_image/`` and submitted one at a time (the
   detector runs once each: +2 ``nms`` and +1 ``roi_align`` launches;
   answers held like the other one-at-a-time submits to ``predict()`` on
   the features the extractor returned) and resubmitted with other
   questions (no detector run), with the served latency of each beside the
   feature-file submits'; then a burst of 32 VQA submits over 8 images from 8 clients at once (batched
   by the scheduler: against ``predict()``, the same top-1 and the k-th
   confidence within rtol 0.1 / atol 1e-3); then scale-out under load: two
   clients keep posting VQA submits while ``ReplicaPool.add_replica``
   builds a second full-width replica and captures its 7 graphs, and the
   first replica must serve batches during those captures, with no
   failure, no failover and every answer held as the burst's, while a third
   client submits 2 more novel uploads (at least one extracted during the
   scale-out); exactly one
   terminal push frame and one ``ResultStore`` row per submit; every batch
   the scheduler dispatched, replayed through ``run_many`` on the replica
   that served it, must give results identical to the served ones; a clean
   stop within 30 s;
8. entry point: ``python -m vilbert_multitask_tpu_torch.serve.app
   --features <dir> --http-port 0 --ws-port 0 --live-extract`` (ports the
   system picks, read from its ``http://`` line) in its own process boots
   on the card, captures its graphs, warms the detector, reports ready on
   ``/healthz``, stores an answer to a feature-file submit and to an image
   uploaded over ``/upload_image/``, and exits 0 on SIGTERM (the process
   is killed if anything fails);
   Then ``python -m vilbert_multitask_tpu_torch.serve.remote --url ...
   --features <dir> --checkpoint <phase 4's weights>`` in its own process
   drains an in-process web host with no engine (``ApiServer`` over
   ``DurableQueue`` + ``ResultStore`` + ``PushHub``): four submits one at
   a time, each one terminal frame and one stored row, answers equal to
   ``predict()`` of phase 4's engine; a wrong worker token is refused;
   exit 0 on SIGTERM;
train. training (no kernel: the trainer's model runs dense attention, and
   ``flash_cross_attention`` refuses a tensor that requires grad on the
   card): 3 f32 steps of a full-width model cut to 2 text layers, 1 visual
   and 1 bridge (dropout and TF32 off) on the card and on the CPU from the
   same weights and batch, held as ``TRAIN_PARITY_*`` says (the first
   step's gradients compared leaf by leaf in f64, and a TF32-on control
   run recorded); then
   ``ViLBertConfig()`` under bf16 autocast over f32 parameters, seeded
   weights, batch 8, through ``Trainer`` and ``MultiTaskSampler`` over
   synthetic vqa, tri, grounding, binary, retrieval and pretrain data for
   30 steps: 0 ``flash_attn`` launches, every loss finite, the step time
   (p50 of the synchronized wall per step) and rows/s, the peak of
   ``max_memory_allocated``, two snapshots kept; the newest restored into
   a fresh Trainer bit-equal to the saved state, and the next 3 steps'
   losses within ``TRAIN_RESUME_RTOL`` of the uninterrupted run's; the save
   and restore seconds; ``EvalHook``, its bf16 graph engine built on the
   initial weights and given the trained ones (18 ``flash_attn`` launches
   for its one forward), scoring and answering as a freshly built engine
   on the trained parameters; ``python -m
   vilbert_multitask_tpu_torch.train.loop --steps 4 --batch 2 --out <dir>``
   exits 0 in its own process; and each head's loss falls on a fixed
   batch of its own repeated about 10 times;
parallel. the process mesh (parallel/): world 1 on NCCL in this process
   (``initialize(backend="nccl")``, ``build_mesh(MeshConfig())``): the
   mesh engine's bundles for the six decode families against the eager
   single-device engine's (expected bit-equal; held within BUNDLE_F32);
   then two ranks sharing the card over gloo, their collectives on CUDA
   tensors staged through host memory (counted per run), through
   ``parallel.launch.spawn_ranks``: tp = 2 at full width in f32 (bundles
   within BUNDLE_F32 of the card's f32 engine, the same answers) and in
   bf16 (``run()`` p50, 18 ``flash_attn`` launches per forward on each
   rank, bundles within BUNDLE_BF16 of the card's bf16 engine); tp = 2
   int8 (every product shape either rank's sliced layers give
   ``int8_linear`` held against ``int8_linear_plain`` at phase 3's bf16
   tolerance and timed beside ``F.linear`` on the dequantized bf16 shard
   and the bound; bundles within BUNDLE_BF16 of the card's int8
   engine, answers a bf16 tie reorders counted); sp = 2 over 1024
   regions (``ring_min_regions=512``): the 6 visual self-attentions take
   the ring, bundles within BUNDLE_F32 of the dense engine; dp = 2
   ``run_many`` in f32 over phase 6's backlog, the same answers as one
   f32 engine's, numbers within BUNDLE_F32; training: 3 f32 steps (depth
   2/1/1, dropout off) at tp = 2 and at dp = 2 against the single-device
   step, held as ``TRAIN_PARITY_*`` says, and a tp = 2 ``Trainer``
   snapshot restored on a fresh launch bit-equal, its next loss within
   ``TRAIN_RESUME_RTOL``;
   NCCL across cards runs the serving runs again where there are two
   cards or more, and is reported as not run otherwise; tp = 3 in bf16
   on three gloo ranks (text self-attentions sharded, 12 heads / 3; the
   visual and bridge attentions whole on each rank, 8 % 3): bundles
   within BUNDLE_BF16 of the card's bf16 engine (answers a bf16 tie
   reorders counted), 18 ``flash_attn`` launches a forward on each rank,
   each rank's heads and weight MiB; ``rolling_swap`` on a tp = 2
   ``ServeApp`` (rank 1 following) to seed-1 weights: its seconds, and
   the bundles after it within BUNDLE_BF16 of a one-device engine on
   those weights;
9. a ``{"kernels": [...]}`` line, the card's nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Kernel launch counts are read per path: each is zeroed just before the
path runs and read just after (the detect phase's ``extract_array`` per
image, phase 4's ``predict``, phase 6's ``run_many``, the int8 phase's
``predict``, phase 7's served submits, which the kernels line reports); a
path that launched a kernel of
its own no time fails. Graph replays count the launches their capture recorded
(engine/graphs.py).

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
F32_TOL = 2e-5  # tests/test_pallas_coattention.py's kernel tolerance
# bf16 kernel output against the f32 plain version on the same (bf16-rounded)
# inputs: the output is rounded to bf16 once (half an ulp is 2^-9 relative),
# and its magnitudes stay below ~4 for N(0, 1) values.
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2
# Decode bundles: the repo's bf16 tolerance (tests/test_engine.py:438) for
# the bf16 card engine against the CPU-f32 engine; the card-f32 engine only
# differs from the CPU-f32 engine in summation order.
BUNDLE_BF16 = dict(rtol=0.1, atol=0.05)
BUNDLE_F32 = dict(rtol=2e-3, atol=2e-3)
# A served row batched with other requests against predict() of the same
# request (bucket 1): the k-th confidence, scaled to the ~0.005-0.01 top
# probabilities of the random-weight label heads.
BATCHED_ROW = dict(rtol=0.1, atol=1e-3)
# Upper bound on the VQA submits posted during phase 7's scale-out.
SCALE_OUT_MAX_SUBMITS = 600
LAUNCHES_PER_FORWARD = 18  # 12 bridge directions + 6 visual self-attentions
# ROIAlign kernel against its plain version (f32, the same formula; only
# the order of operations the compiler keeps differs): |d| <= atol + rtol|p|.
ROI_ATOL = ROI_RTOL = 1e-5
NMS_IOU_OPS = 13  # f32 operations of one IoU test (csrc/nms.cu)
# SASS instructions counted per kernel: mma.sync, cp.async, ldmatrix, wgmma,
# TMA loads.
SASS_COUNTED = ("HMMA", "LDGSTS", "LDSM", "HGMMA", "UTMALDG")
# Cold-L2 timing: each shape's weights rotate through copies that add up to
# more than the H100's 50 MB L2 (at most INT8_COLD_MAX_COPIES copies).
INT8_COLD_BYTES = 64 << 20
INT8_COLD_MAX_COPIES = 256
# Per extracted image: one NMS call for the 5 RPN levels, one for the
# per-class selection, one ROIAlign call.
NMS_PER_IMAGE, ROI_PER_IMAGE = 2, 1
# Seeded RGB images for the detector (name, height, width): upscaled,
# unscaled-ish, the reference's 800/1333 contract, downscaled.
DETECT_IMAGES = (("small 160x120", 120, 160), ("640x480", 480, 640),
                 ("1333x800", 800, 1333), ("2000x1500", 1500, 2000))
DETECT_TIMED_RUNS = 12  # warm extractions for the p50 (the 4 images x 3)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def call_ms(fn, *, reps: int = 15, inner: int = 10) -> float:
    """Eager back-to-back calls, host launch cost included: median over
    ``reps`` of the mean time of ``inner`` calls, by CUDA events, after a
    warm-up. At small shapes this is the host's enqueue rate."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_ms(fn, *, reps: int = 15, inner: int = 10) -> float:
    """Device time of one call: ``inner`` calls captured in one CUDA graph,
    the replay timed by CUDA events (no host launch cost between them);
    median over ``reps`` replays of the mean per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    del graph
    return statistics.median(times)


def attention_bound_ms(B, Nq, Nk, H, D, itemsize) -> tuple:
    """Least time for one attention call: each input read once, the output
    written once, against 4·B·H·Nq·Nk·D FLOP at the bf16 tensor-core peak."""
    n_bytes = itemsize * (2 * B * Nq * H * D + 2 * B * Nk * H * D + B * Nk)
    flops = 4 * B * H * Nq * Nk * D
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 2
def kernel_build_notes(_build, name: str) -> list:
    """Per kernel instantiation of ``csrc/<name>.cu``: what ptxas reported
    (from the build's log) and SASS instruction counts (cuobjdump)."""
    lib = _build.library_path(name)
    with open(lib + ".log") as f:
        log_text = f.read()
    notes, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = notes.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_static_bytes"] = int(m.group(1)) if m else 0
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = notes.setdefault(m.group(1), {})
            cur["sass"] = dict.fromkeys(SASS_COUNTED, 0)
        elif cur is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
            if m and m.group(1) in cur["sass"]:
                cur["sass"][m.group(1)] += 1
    out = []
    for mangled, rec in sorted(notes.items()):
        m = re.search(r"(flash_attn_(?:bf16|f32)_kernel|nms_[a-z_]+_kernel|"
                      r"roi_align_kernel|"
                      r"int8_linear_(?:bf16_stream|bf16_wgmma|f32)_kernel)"
                      r"(?:I((?:L[ib]\d+E)+)E)?", mangled)
        args = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m else []
        rec["kernel"] = (m.group(1) + (f"<{','.join(args)}>" if args
                                       else "")) if m else mangled
        out.append(rec)
    return out


def check_build_notes(notes: list) -> None:
    """No spills anywhere; the bf16 kernels' SASS holds their tensor-core
    and copy instructions: mma.sync (HMMA) and cp.async (LDGSTS), and for
    the int8 wgmma kernel wgmma (HGMMA) and TMA (UTMALDG)."""
    for rec in notes:
        if rec.get("spill_store_bytes", 0) or rec.get("spill_load_bytes", 0):
            raise AssertionError(f"{rec['kernel']} spills: {rec}")
        sass = rec.get("sass", {})
        if "bf16" not in rec["kernel"]:
            continue
        need = (("HGMMA", "UTMALDG") if "wgmma" in rec["kernel"]
                else ("HMMA", "LDGSTS"))
        if not all(sass.get(op) for op in need):
            raise AssertionError(f"{rec['kernel']} lacks one of {need} in "
                                 f"its SASS: {sass}")


# ---------------------------------------------------------------- phase 3
# (B, Nq, Nk, H, D, share of keys kept, q scale, what the shape exercises).
# The serving shapes come first and draw their inputs in the same order as
# every earlier run of this script.
SERVING = [(b, nq, nk, 8, 128, 0.9, 1.0, "serving")
           for b in (1, 2, 4, 8, 32)
           for nq, nk in ((38, 101), (101, 38), (101, 101))]
EDGES = [
    (2, 45, 300, 4, 96, 0.9, 1.0, "five key tiles, ragged edges"),
    (1, 38, 64, 8, 128, 0.9, 1.0, "one full 64-key tile"),
    (1, 38, 65, 8, 128, 0.9, 1.0, "one tile and one key"),
    (4, 101, 128, 8, 128, 0.9, 1.0, "two full tiles"),
    (4, 101, 129, 8, 128, 0.9, 1.0, "two tiles and one key"),
    (2, 38, 101, 8, 64, 0.9, 1.0, "D = 64"),
    (2, 38, 101, 8, 16, 0.9, 1.0, "D = 16 (the tiny config)"),
    (1, 101, 101, 8, 128, 0.9, 8.0, "q x 8: peaky rows"),
    (1, 38, 101, 8, 128, 0.1, 1.0, "90% of the keys masked"),
]
# What each rank of a tp = 2 mesh launches at the serving buckets: its 4
# local heads of 128 (the parallel phase's tp = 2 forwards).
TP2_SHARDS = [(b, nq, nk, 4, 128, 0.9, 1.0, "tp=2 shard")
              for b in (1, 2, 4, 8, 32)
              for nq, nk in ((38, 101), (101, 38), (101, 101))]


def bf16_check(out, ref) -> tuple:
    """(max abs error, share of the tolerance used: the largest
    |out - ref| / (BF16_ATOL + BF16_RTOL |ref|), which must stay <= 1)."""
    err = (out - ref).abs()
    return (err.max().item(),
            (err / (BF16_ATOL + BF16_RTOL * ref.abs())).max().item())


def check_flash_attention(torch, report: dict) -> dict:
    import torch.nn.functional as F

    from vilbert_multitask_tpu_torch.ops import coattention as co
    from vilbert_multitask_tpu_torch.ops.attention import mask_to_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for B, Nq, Nk, H, D, keep, q_scale, what in (SERVING + EDGES
                                                 + TP2_SHARDS):
        q32, k32, v32 = (torch.randn(B, n, H, D, generator=gen).to(dev)
                         for n in (Nq, Nk, Nk))
        q32 = q32 * q_scale
        mask = torch.rand(B, Nk, generator=gen) < keep
        mask[:, 0] = True
        mask = mask.to(dev)
        b32 = mask_to_bias(mask, torch.float32)
        out = co.flash_cross_attention(q32, k32, v32, b32)
        ref = co.flash_cross_attention_plain(q32, k32, v32, b32)
        err32 = (out - ref).abs().max().item()
        # bf16: the kernel on bf16 inputs against the f32 plain version on
        # the same bf16-rounded values.
        q16, k16, v16 = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        b16 = mask_to_bias(mask, torch.bfloat16)
        ref16 = co.flash_cross_attention_plain(
            q16.float(), k16.float(), v16.float(), b32)
        err16, used16 = bf16_check(
            co.flash_cross_attention(q16, k16, v16, b16).float(), ref16)
        torch.cuda.synchronize()
        qt, kt, vt = (t.transpose(1, 2) for t in (q16, k16, v16))
        fns = dict(
            kernel=lambda: co.flash_cross_attention(q16, k16, v16, b16),
            plain=lambda: co.flash_cross_attention_plain(q16, k16, v16, b16),
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=b16))
        row = dict(B=B, Nq=Nq, Nk=Nk, H=H, D=D, keep=keep, q_scale=q_scale,
                   what=what, max_abs_err_f32=err32, max_abs_err_bf16=err16,
                   tol_used_bf16=used16)
        for name, fn in fns.items():
            row[f"{name}_ms"] = device_ms(fn)
            row[f"{name}_call_ms"] = call_ms(fn)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            B, Nq, Nk, H, D, 2)
        rows.append(row)
        log("flash_attn B=%d Nq=%d Nk=%d H=%d D=%d (%s) kernel_ms=%.5f "
            "plain_ms=%.5f library_ms=%.5f bound_ms=%.6f (%s) | eager "
            "calls: kernel %.5f plain %.5f library %.5f | err_f32=%.3e "
            "err_bf16=%.3e (%.2f of tol)" % (
                B, Nq, Nk, H, D, what, row["kernel_ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"], row["bound_by"],
                row["kernel_call_ms"], row["plain_call_ms"],
                row["library_call_ms"], err32, err16, used16))
        if not err32 <= F32_TOL:
            raise AssertionError(f"f32 kernel error {err32:.3e} > {F32_TOL} "
                                 f"at {(B, Nq, Nk, H, D)} ({what})")
        if not used16 <= 1.0:
            raise AssertionError(
                f"bf16 kernel error {err16:.3e} beyond atol {BF16_ATOL} + "
                f"rtol {BF16_RTOL} at {(B, Nq, Nk, H, D)} ({what})")
    report["flash_attn_shapes"] = rows

    # Strided inputs: q, k, v as views into fused (B, N, 3, H, D) buffers
    # (the layout a fused QKV projection gives), read in place, in f32 and
    # in bf16 (the 16-byte copies through the strides).
    B, Nq, Nk, H, D = 2, 38, 101, 8, 128
    qb = torch.randn(B, Nq, 3, H, D, generator=gen).to(dev)
    kvb = torch.randn(B, Nk, 3, H, D, generator=gen).to(dev)
    mask = torch.ones(B, Nk, dtype=torch.bool)
    mask[1, 60:] = False
    mask = mask.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        qbd, kvbd = qb.to(dtype), kvb.to(dtype)
        q, k, v = qbd[:, :, 0], kvbd[:, :, 1], kvbd[:, :, 2]
        assert not q.is_contiguous() and k.stride(1) == 3 * H * D
        ref = co.flash_cross_attention_plain(
            q.float().contiguous(), k.float().contiguous(),
            v.float().contiguous(), mask_to_bias(mask, torch.float32))
        got = co.flash_cross_attention(q, k, v,
                                       mask_to_bias(mask, dtype)).float()
        if dtype == torch.float32:
            err = (got - ref).abs().max().item()
            ok = err <= F32_TOL
        else:
            err, used = bf16_check(got, ref)
            ok = used <= 1.0
        log(f"flash_attn strided views (B={B} Nq={Nq} Nk={Nk}, {dtype}): "
            f"max abs err {err:.3e}")
        if not ok:
            raise AssertionError(f"strided {dtype} kernel error {err:.3e}")
        report[f"flash_attn_strided_err_{str(dtype)[6:]}"] = err
    return {(r["B"], r["Nq"], r["Nk"]): r for r in rows
            if r["what"] == "serving"}


def _boxes_in(torch, gen, shape, w=1333.0, h=800.0, lo=8.0, hi=400.0):
    """Seeded xyxy f32 boxes of sides lo..hi inside a w x h image."""
    size = torch.tensor([w, h])
    xy = torch.rand(*shape, 2, generator=gen) * size
    wh = lo + torch.rand(*shape, 2, generator=gen) * (hi - lo)
    return torch.cat([xy, torch.minimum(xy + wh, size)], dim=-1)


def _exact_threshold_boxes(torch, clusters: int):
    """Clusters of 5 boxes whose IoUs with the first are exactly 0.5 (two),
    above 0.5 (one) and 0 (one), built from binary fractions, 20 px
    apart."""
    base = torch.tensor([[0.0, 0.0, 4.0, 2.0], [0.0, 0.0, 4.0, 1.0],
                         [0.0, 0.0, 2.0, 2.0], [0.0, 0.0, 4.0, 1.0625],
                         [10.0, 10.0, 11.0, 11.0]])
    shift = 20.0 * torch.arange(clusters, dtype=torch.float32)
    off = torch.stack([shift, torch.zeros_like(shift)] * 2, dim=1)
    return (base[None] + off[:, None]).reshape(-1, 4)


def _selection_ties(torch, gen, dev):
    """The selection's shape (300 shared boxes, the (1600, 300) class-score
    view of a (300, 1601) softmax) with exact ties and exact zeros: every
    third box's logits are flat (its 1600 class scores tie, and tie with
    the other flat boxes in each class), every seventh box's first 400
    classes underflow to 0.0, and every fifth box has zero width."""
    boxes = _boxes_in(torch, gen, (300,))
    boxes[::5, 2] = boxes[::5, 0]
    logits = 2.0 * torch.randn(300, 1601, generator=gen)
    logits[::3] = 0.0
    logits[1::7, 1:401] = -1e4
    scores = torch.softmax(logits.to(dev), dim=1)[:, 1:].t()
    return boxes.to(dev).expand(1600, 300, 4), scores


def nms_cases(torch, dev):
    """(what, boxes, scores, thresh, valid, expected keep count or None)
    on the card: the two serving shapes first, then the edges."""
    gen = torch.Generator().manual_seed(3)
    cases = []
    rpn_boxes = _boxes_in(torch, gen, (5, 1000))
    rpn_scores = torch.sort(torch.rand(5, 1000, generator=gen), dim=1,
                            descending=True).values
    cases.append(("rpn serving: 5 levels x 1000, own boxes", rpn_boxes,
                  rpn_scores, 0.7, [1000] * 5, None))
    # Made on the card as the detector makes them: Tensor.to() would copy a
    # stride-0 box set into 1600 sets and the score view into a dense one.
    sel_boxes = _boxes_in(torch, gen, (300,)).to(dev)
    logits = 2.0 * torch.randn(300, 1601, generator=gen)
    sel_scores = torch.softmax(logits.to(dev), dim=1)[:, 1:].t()  # a view
    cases.append(("selection serving: 1600 classes x 300 shared boxes",
                  sel_boxes.expand(1600, 300, 4), sel_scores, 0.5, None,
                  None))
    for n in (63, 65, 299):
        cases.append((f"G=1 N={n}", _boxes_in(torch, gen, (1, n)),
                      torch.rand(1, n, generator=gen), 0.5, None, None))
    cases.append(("ragged groups (1000, 517, 64, 3, 0)",
                  _boxes_in(torch, gen, (5, 1000)),
                  torch.rand(5, 1000, generator=gen), 0.7,
                  [1000, 517, 64, 3, 0], None))
    same = torch.tensor([[5.0, 6.0, 80.0, 90.0]]).expand(1, 300, 4)
    cases.append(("300 identical boxes", same.contiguous(),
                  torch.rand(1, 300, generator=gen), 0.5, None, 1))
    grid = torch.tensor([[4.0 * (i % 20), 4.0 * (i // 20),
                          4.0 * (i % 20) + 3.0, 4.0 * (i // 20) + 3.0]
                         for i in range(300)])
    cases.append(("300 disjoint boxes", grid[None],
                  torch.rand(1, 300, generator=gen), 0.5, None, 300))
    cases.append(("score ties (fifths), 1000 boxes",
                  _boxes_in(torch, gen, (1, 1000)),
                  torch.round(5 * torch.rand(1, 1000, generator=gen)) / 5,
                  0.7, None, None))
    exact = _exact_threshold_boxes(torch, 26)
    exact_scores = torch.linspace(1.0, 0.01, exact.shape[0])[None]
    cases.append(("IoU exactly at the threshold 0.5 (130 boxes)",
                  exact[None], exact_scores, 0.5, None, 104))
    cases.append(("IoU exactly at the threshold 0.25 (130 boxes)",
                  exact[None], exact_scores, 0.25, None, None))
    cases.append(("3 groups x 2100 (4 mask words a lane)",
                  _boxes_in(torch, gen, (3, 2100)),
                  torch.rand(3, 2100, generator=gen), 0.5, None, None))
    # Shared box sets: the mask staged in shared memory (N = 1000, ragged
    # counts, so the shared walk meets the padding) and read from L2
    # (N = 2100, 33 mask words: four a lane).
    shared = _boxes_in(torch, gen, (1000,)).to(dev)
    counts = torch.randint(0, 1001, (64,), generator=gen)
    counts[:8] = torch.tensor([1000, 999, 517, 65, 64, 63, 1, 0])
    cases.append(("shared 1000 boxes, 64 groups, ragged valid",
                  shared.expand(64, 1000, 4),
                  torch.rand(64, 1000, generator=gen), 0.7, counts.tolist(),
                  None))
    cases.append(("shared 2100 boxes, 40 groups (mask from L2)",
                  _boxes_in(torch, gen, (2100,)).to(dev).expand(40, 2100,
                                                                4),
                  torch.rand(40, 2100, generator=gen), 0.5, None, None))
    cases.append(("selection shape, exact-zero and tied scores, degenerate "
                  "boxes", *_selection_ties(torch, gen, dev), 0.5, None,
                  None))
    out = []
    for what, boxes, scores, thresh, valid, want in cases:
        v = None if valid is None else torch.tensor(valid).to(dev)
        out.append((what, boxes.to(dev), scores.to(dev), thresh, v, want))
    for what, boxes, scores, *_ in out:
        if (boxes.stride(0) == 0) != what.startswith(("selection", "shared")):
            raise AssertionError(f"nms case {what}: boxes strides "
                                 f"{boxes.stride()}")
    return out


def nms_iou_count(torch, boxes, scores, keep, valid) -> int:
    """IoU tests the greedy walk needs for these keep masks: each valid box
    against each box kept before it in its group's order. For a box set
    shared by every group (group stride 0) one IoU serves every group, so
    each distinct pair the groups need counts once (at most N(N-1)/2)."""
    G, N = scores.shape
    dev = scores.device
    n_valid = (torch.full((G,), N, device=dev) if valid is None
               else torch.as_tensor(valid, device=dev))
    pad = torch.arange(N, device=dev)[None] >= n_valid[:, None]
    order = torch.sort(scores.masked_fill(pad, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    if boxes.stride(0) != 0:
        ks = keep.gather(1, order).to(torch.int64)
        return int((torch.cumsum(ks, dim=1) - ks).masked_fill(pad, 0)
                   .sum().item())
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(N, device=dev).expand(G, N))
    need = torch.zeros((N, N), dtype=torch.bool, device=dev)
    chunk = max(1, (1 << 26) // (N * N))
    for g0 in range(0, G, chunk):
        r, k, p = (t[g0:g0 + chunk] for t in (rank, keep, pad))
        # box i valid, box j kept, j before i in the group's order
        need |= ((~p)[:, :, None] & k[:, None, :]
                 & (r[:, None, :] < r[:, :, None])).any(dim=0)
    return int((need | need.t()).triu(1).sum().item())


def nms_bound_ms(torch, boxes, scores, keep, valid) -> tuple:
    """Least time for one NMS call: boxes (once, shared or not) and scores
    read once, the keep mask written once, against 13 f32 operations per
    IoU the greedy walk needs (:func:`nms_iou_count`: this run's count)."""
    G, N = scores.shape
    unique_boxes = N if boxes.stride(0) == 0 else G * N
    n_bytes = unique_boxes * 16 + G * N * 4 + G * N
    flops = NMS_IOU_OPS * nms_iou_count(torch, boxes, scores, keep, valid)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_nms(torch, report: dict) -> dict:
    """K1 against its plain version on the card: keep masks identical at
    every case; per serving shape the kernel's, the plain version's and
    the bound's time. Returns the serving rows by name."""
    from vilbert_multitask_tpu_torch.ops import nms as nm

    dev = torch.device("cuda")
    rows = []
    routes = set()
    for what, boxes, scores, thresh, valid, want in nms_cases(torch, dev):
        got = nm.nms_mask(boxes, scores, thresh, valid=valid)
        ref = nm.nms_mask_plain(boxes, scores, thresh, valid=valid)
        torch.cuda.synchronize()
        wrong = int((got != ref).sum().item())
        kept = int(got.sum().item())
        plan = nm.plan_launch(*scores.shape, boxes.stride(0) == 0)
        routes.add((plan.shared, plan.segments, plan.staged,
                    plan.words > 32))
        row = dict(what=what, G=scores.shape[0], N=scores.shape[1],
                   thresh=thresh, kept=kept, mismatches=wrong,
                   plan=dataclasses.asdict(plan))
        if what.endswith("serving") or "serving:" in what:
            row["kernel_ms"] = device_ms(
                lambda: nm.nms_mask(boxes, scores, thresh, valid=valid))
            row["plain_ms"] = device_ms(
                lambda: nm.nms_mask_plain(boxes, scores, thresh, valid=valid),
                reps=5, inner=1)
            row["kernel_call_ms"] = call_ms(
                lambda: nm.nms_mask(boxes, scores, thresh, valid=valid))
            row["bound_ms"], row["bound_by"] = nms_bound_ms(
                torch, boxes, scores, got, valid)
        rows.append(row)
        log("nms %s: G=%d N=%d thresh %.2f kept %d, %d mismatches vs plain "
            "(%s, %d groups a block)%s"
            % (what, row["G"], row["N"], thresh, kept, wrong,
               " + ".join(plan.kernels), plan.groups_per_block,
               "" if "kernel_ms" not in row else
               " | kernel_ms=%.5f (eager call %.5f) plain_ms=%.5f "
               "bound_ms=%.6f (%s)" % (row["kernel_ms"],
                                       row["kernel_call_ms"],
                                       row["plain_ms"], row["bound_ms"],
                                       row["bound_by"])))
        if wrong:
            raise AssertionError(f"nms kernel differs from its plain version "
                                 f"in {wrong} places ({what})")
        if want is not None and kept != want:
            raise AssertionError(f"nms {what}: kept {kept}, expected {want}")
    # (shared, 8 lanes a group, staged, more than 32 mask words): every
    # route and walk instance of csrc/nms.cu ran
    missing = {(True, True, True, False), (True, False, True, False),
               (True, False, False, True), (False, False, False, False),
               (False, False, False, True)} - routes
    if missing:
        raise AssertionError(f"nms cases left routes untested: {missing}")
    report["nms_cases"] = rows
    return {r["what"]: r for r in rows if "kernel_ms" in r}


def roi_maps(torch, dev, canvas: int = 1344, channels: int = 256):
    """Seeded P2..P5 maps of the serving canvas as the FPN leaves them
    (channels-last NCHW) and their (H, W, C) views."""
    gen = torch.Generator().manual_seed(4)
    nchw = [torch.randn(1, channels, canvas // s, canvas // s, generator=gen)
            .to(dev).contiguous(memory_format=torch.channels_last)
            for s in (4, 8, 16, 32)]
    return nchw, [t.permute(0, 2, 3, 1)[0] for t in nchw]


def level_boundary_boxes():
    """(boxes (15, 4) float32 numpy, ratios): square boxes whose
    sqrt(area) / 224, in float32 as fpn_level computes it, is exactly 1, 2
    and 4 and 1 and 8 ulps either side, where floor(4 + log2(.)) steps
    from one FPN level to the next (found by stepping the side's last
    bits)."""
    import numpy as np

    f32 = np.float32
    boxes, ratios = [], []
    for q in (1.0, 2.0, 4.0):
        for k in (-8, -1, 0, 1, 8):
            target = (np.array([q], f32).view(np.int32) + k).view(f32)[0]
            start = np.array([224.0 * q], f32).view(np.int32)[0]
            for d in sorted(range(-64, 65), key=abs):
                side = np.array([start + d], np.int32).view(f32)[0]
                x1 = f32(8.0)
                x2 = f32(x1 + side)
                w = f32(x2 - x1)
                ratio = f32(np.sqrt(np.maximum(f32(w * w), f32(1.0)))
                            / f32(224.0))
                if ratio == target:
                    boxes.append([x1, x1, x2, x2])
                    ratios.append(float(ratio))
                    break
            else:
                raise AssertionError(f"no side gives sqrt(area)/224 = "
                                     f"{target!r}")
    return np.array(boxes, f32), ratios


def roi_cases(torch, dev):
    """(what, boxes, maps): the serving shape (300 proposals over every
    level) first, then the edges; ``maps`` names the level-map views
    :func:`check_roi_align` reads them from ("full": the FPN's maps, float4
    loads; the others are views the scalar instance reads)."""
    gen = torch.Generator().manual_seed(5)
    xy = torch.rand(300, 2, generator=gen) * torch.tensor([1333.0, 800.0])
    side = torch.exp(torch.log(torch.tensor(8.0)) + torch.rand(
        300, 2, generator=gen) * math.log(900.0 / 8.0))
    serving = torch.cat([xy, xy + side], dim=1)
    edges = torch.tensor([
        [10.0, 10.0, 122.0, 122.0], [0.0, 0.0, 224.0, 224.0],
        [5.0, 5.0, 453.0, 453.0], [100.0, 50.0, 100.0 + 111.9, 161.9],
        [1300.0, 780.0, 1400.0, 900.0], [-50.0, -40.0, 30.0, 20.0],
        [-500.0, -500.0, -400.0, -400.0], [1340.0, 10.0, 1500.0, 60.0],
        [40.0, 40.0, 40.0, 40.0], [60.0, 70.0, 60.0, 90.0],
        [0.0, 0.0, 1344.0, 1344.0], [3.5, 7.25, 3.75, 900.0]])
    cases = [("serving: 300 proposals over P2..P5", serving, "full"),
             ("level boundaries, off the canvas edge, zero area", edges,
              "full")]
    for level, (lo, hi) in enumerate(((8, 100), (120, 200), (240, 420),
                                      (460, 1300))):
        side = lo + torch.rand(64, 1, generator=gen) * (hi - lo)
        xy = torch.rand(64, 2, generator=gen) * 1000.0
        cases.append((f"P{level + 2} alone (64 boxes)",
                      torch.cat([xy, xy + side], dim=1), "full"))
    cases.append(("sqrt(area)/224 at 1, 2, 4 and 1, 8 ulps either side",
                  torch.from_numpy(level_boundary_boxes()[0]), "full"))
    cases.append(("serving boxes, maps' channels 1..255 (C 255)", serving,
                  "C 255"))
    cases.append(("serving boxes, maps' channels 1..252 (base 4 bytes off)",
                  serving, "offset"))
    return [(what, b.to(dev), maps) for what, b, maps in cases]


def roi_bound_ms(torch, dm, views, boxes, res, sampling) -> tuple:
    """Least time for one ROIAlign call: the output written once, the boxes
    and every map element a sample point of this run's boxes touches read
    once; against ~12 f32 operations per sample and channel."""
    level = dm.fpn_level(boxes)
    C = views[0].shape[-1]
    n = res * sampling
    touched = 0
    for lvl, (v, stride) in enumerate(zip(views, dm.FPN_STRIDES)):
        b = boxes[level == lvl] / stride
        if not len(b):
            continue
        H, W = v.shape[:2]
        steps = torch.arange(n, device=b.device, dtype=b.dtype) + 0.5
        yy = (b[:, 1:2] + steps * (b[:, 3:4] - b[:, 1:2]) / n).clamp(0, H - 1)
        xx = (b[:, 0:1] + steps * (b[:, 2:3] - b[:, 0:1]) / n).clamp(0, W - 1)
        y0 = yy.floor().long().clamp(0, H - 2)
        x0 = xx.floor().long().clamp(0, W - 2)
        grid = torch.zeros(H, W, dtype=torch.bool, device=b.device)
        for dy in (0, 1):
            for dx in (0, 1):
                grid[(y0 + dy)[:, :, None], (x0 + dx)[:, None, :]] = True
        touched += int(grid.sum().item())
    R = boxes.shape[0]
    n_bytes = 4 * (touched * C + R * 4 + R * res * res * C)
    flops = 12 * R * n * n * C
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_roi_align(torch, report: dict) -> dict:
    """K2 against its plain version on the card at the serving shape and
    the edges (|d| <= 1e-5 + 1e-5 |plain|); the serving shape's times.
    Returns the serving row."""
    from vilbert_multitask_tpu_torch.detect import model as dm

    dev = torch.device("cuda")
    _, full = roi_maps(torch, dev)
    maps_by_name = {"full": full, "C 255": [v[..., 1:] for v in full],
                    "offset": [v[..., 1:253] for v in full]}
    strides = dm.FPN_STRIDES[:4]
    res, sampling = 7, 2
    rows = []
    for what, boxes, maps in roi_cases(torch, dev):
        views = maps_by_name[maps]
        vec = dm.roi_vector_width(views)
        if vec != (4 if maps == "full" else 1):
            raise AssertionError(f"roi_align {what}: vector width {vec}")
        got = dm.roi_align(views, boxes, strides, res, sampling)
        ref = dm.roi_align_plain(views, boxes, strides, res, sampling)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        used = (err / (ROI_ATOL + ROI_RTOL * ref.abs())).max().item()
        levels = torch.bincount(dm.fpn_level(boxes), minlength=4).tolist()
        row = dict(what=what, R=boxes.shape[0], C=views[0].shape[-1],
                   vector_width=vec, levels=levels,
                   max_abs_err=err.max().item(),
                   max_rel_err=(err / ref.abs().clamp_min(1e-3)).max().item(),
                   tol_used=used, bit_equal=bool(err.max().item() == 0.0))
        if what.startswith("serving"):
            row["kernel_ms"] = device_ms(
                lambda: dm.roi_align(views, boxes, strides, res, sampling))
            row["plain_ms"] = device_ms(
                lambda: dm.roi_align_plain(views, boxes, strides, res,
                                           sampling), reps=5, inner=2)
            row["kernel_call_ms"] = call_ms(
                lambda: dm.roi_align(views, boxes, strides, res, sampling))
            row["bound_ms"], row["bound_by"] = roi_bound_ms(
                torch, dm, views, boxes, res, sampling)
        rows.append(row)
        log("roi_align %s: R=%d C=%d per level %s, %d channels a thread, "
            "max abs err %.3e (%.3f of atol 1e-5 + rtol 1e-5)%s" % (
                what, row["R"], row["C"], levels, vec, row["max_abs_err"],
                used,
                "" if "kernel_ms" not in row else
                " | kernel_ms=%.5f (eager call %.5f) plain_ms=%.5f "
                "bound_ms=%.6f (%s)" % (row["kernel_ms"],
                                        row["kernel_call_ms"],
                                        row["plain_ms"], row["bound_ms"],
                                        row["bound_by"])))
        if not used <= 1.0:
            raise AssertionError(f"roi_align kernel error {err.max().item():.3e}"
                                 f" beyond atol 1e-5 + rtol 1e-5 ({what})")
        if what.startswith("serving:") and not row["bit_equal"]:
            raise AssertionError(f"roi_align serving shape not bit-equal to "
                                 f"the plain version: {row['max_abs_err']}")
    report["roi_align_cases"] = rows
    return rows[0]


# ------------------------------------------------------- phase 3: int8_linear
def int8_forward_shapes(mcfg, rows: int) -> list:
    """The int8_linear launches of one forward of ``rows`` image rows at
    the model config ``mcfg``: (M, N, K, batch, launches, where). 184 trunk
    Linear calls at serving width, then the fused heads' products: 5 at an
    odd row count, 7 at an even one (the NLVR2 pair head)."""
    nt = 38 * rows  # 37 text tokens + the task token, per row
    nv = 101 * rows  # 100 regions + the global box, per row
    h, vh, bh = mcfg.hidden_size, mcfg.v_hidden_size, mcfg.bi_hidden_size
    ti, vi = mcfg.intermediate_size, mcfg.v_intermediate_size
    lt, lv, lc = (mcfg.num_hidden_layers, mcfg.v_num_hidden_layers,
                  mcfg.num_connection_layers)
    wl = max(mcfg.num_labels, mcfg.gqa_num_labels)
    out = [
        (nt, h, h, 1, 4 * lt, "text q/k/v/attention output"),
        (nt, ti, h, 1, lt + lc, "text intermediate"),
        (nt, h, ti, 1, lt + lc, "text output"),
        (nv, vh, vh, 1, 4 * lv, "visual q/k/v/attention output"),
        (nv, vi, vh, 1, lv + lc, "visual intermediate"),
        (nv, vh, vi, 1, lv + lc, "visual output"),
        (nv, bh, vh, 1, 3 * lc, "bridge visual q/k/v"),
        (nt, bh, h, 1, 3 * lc, "bridge text q/k/v"),
        (nv, vh, bh, 1, lc, "biOutput.dense1"),
        (nt, h, bh, 1, lc, "biOutput.dense2"),
        (nv, vh, mcfg.v_feature_size, 1, 1, "image_embeddings"),
        (nv, vh, 5, 1, 1, "image_location_embeddings"),
        (rows, bh, h, 1, 1, "t_pooler"),
        (rows, bh, vh, 1, 1, "v_pooler"),
        (rows, 2 * 2 * bh, bh, 1, 1, "VQA/GQA dense1 (columns of both)"),
        (rows, wl, 2 * bh, 2, 1, "VQA/GQA dense2 (a batch of two)"),
        (rows, 4, bh, 1, 1, "pooled heads (vil_logit + tri)"),
        (nv, 1, vh, 1, 1, "vision_logit"),
        (nt, 1, h, 1, 1, "linguisic_logit"),
    ]
    if rows % 2 == 0:
        out += [(rows // 2, 2 * bh, 2 * bh, 1, 1, "NLVR2 dense1"),
                (rows // 2, 2, 2 * bh, 1, 1, "NLVR2 dense2")]
    return out


# The fused head products of int8_forward_shapes: their slabs pass the f32
# scale (the kernels' f32-scale path); every trunk Linear, the poolers
# included, passes its scale rounded to bf16.
INT8_HEAD_PRODUCTS = ("VQA/GQA dense1 (columns of both)",
                      "VQA/GQA dense2 (a batch of two)",
                      "pooled heads (vil_logit + tri)", "vision_logit",
                      "linguisic_logit", "NLVR2 dense1", "NLVR2 dense2")


def int8_launches_per_forward(mcfg, rows: int) -> int:
    return sum(s[4] for s in int8_forward_shapes(mcfg, rows))


# Edge shapes (M, N, K, batch, what): M off the 64-row tiles, N = 1, 3, 4
# and 3129, K = 5 (the element-wise x path), K off the 64-deep tiles.
INT8_EDGES = [
    (1, 768, 768, 1, "M = 1"),
    (15, 1024, 1024, 1, "M = 15"),
    (17, 3129, 2048, 2, "M = 17, N = 3129, a batch of two"),
    (17, 3, 1024, 1, "N = 3"),
    (15, 4, 1024, 1, "N = 4"),
    (1, 1, 768, 1, "M = 1, N = 1"),
    (1, 1024, 5, 1, "M = 1, K = 5"),
    (203, 1024, 5, 1, "K = 5, M = 203"),
    (17, 100, 1000, 1, "K = 1000 (ragged tile)"),
    (3, 33, 37, 1, "K = 37 (element-wise x, padded rows)"),
]


def int8_operands(torch, gen, M, N, K, batch, dtype, round_scale: bool):
    """Seeded operands on the card: x ~ N(0, 1), q uniform in [-127, 127]
    with a zero row, scales so that |W| <= ~1.5 / sqrt(K) (outputs of
    order 1), a bias of order 0.02; the scale rounded to bf16 as the trunk
    passes it, or raw as the head slabs do."""
    from vilbert_multitask_tpu_torch.ops.int8_linear import padded_rows

    lead = (batch,) if batch > 1 else ()
    x = torch.randn(*lead, M, K, generator=gen)
    q = torch.randint(-127, 128, (*lead, N, K), generator=gen,
                      dtype=torch.int8)
    q[..., 0, :] = 0
    s = (0.5 + torch.rand(*lead, N, generator=gen)) / (127 * K ** 0.5)
    if round_scale:
        s = s.to(torch.bfloat16).float()
    b = 0.02 * torch.randn(*lead, N, generator=gen)
    dev = torch.device("cuda")
    return (x.to(dev, dtype), padded_rows(q.to(dev)), s.to(dev),
            b.to(dev, dtype))


def int8_bound_parts(M, N, K, batch, itemsize, bias: bool = True) -> tuple:
    """(ms to move the bytes, ms for the operations) of one call: q once
    (int8), the scales (f32) and the bias (where there is one) once, x read
    once and y written once, over the HBM rate; 2·M·N·K operations at the
    bf16 tensor-core peak (itemsize 2) or the f32 CUDA-core peak."""
    n_bytes = batch * (N * K + 4 * N + itemsize * N * bias
                       + itemsize * M * K + itemsize * M * N)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    return (n_bytes / PEAK_BYTES_PER_S * 1e3,
            2 * M * N * K * batch / peak * 1e3)


def rotation_ms(fns: list, *, reps: int = 5) -> float:
    """Device time of one call when consecutive calls each run another of
    ``fns`` (one pass over them captured in a CUDA graph, replays timed by
    CUDA events): the median over ``reps`` replays of the mean per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / len(fns))
    del graph
    return statistics.median(times)


def cold_copies(copy, n_bytes: int) -> list:
    """Copies (made by ``copy()``) of an operand of ``n_bytes`` that together
    exceed the L2, so a pass over them reads each from device memory; at
    most INT8_COLD_MAX_COPIES."""
    n = min(INT8_COLD_MAX_COPIES, -(-INT8_COLD_BYTES // max(n_bytes, 1)))
    return [copy() for _ in range(max(n, 2))]


def plan_text(plan) -> str:
    return (f"{plan.regime} tile {plan.tile_m}x{plan.tile_n} splits "
            f"{plan.splits} blocks {plan.blocks}")


def check_int8_linear(torch, report: dict, mcfg) -> dict:
    """K1 against its plain version on the card: bf16 within atol 1e-2 +
    rtol 1e-2, f32 within 2e-5 x max(1, |ref|), at every (N, K) of the
    full-width forward at M = 38·{1, 32} and 101·{1, 32}, at the shapes of
    a bucket-1 and a bucket-32 forward, and at the edges; in bf16 both scale
    paths at every shape (the trunk's, the scale rounded to bf16, and the
    head slabs', f32), two launches on the same inputs bit-identical; a
    strided x (the poolers' first token, the label pair's head axis). Per
    shape the launch plan. Per timed shape, on the scale path its forward
    launch takes, the kernel's device time, the plain version's,
    ``F.linear`` on the pre-dequantized bf16 weight (cuBLAS reading twice
    the weight bytes: the bf16 engine's own product)
    and ``aten._weight_int8pack_mm`` where this PyTorch runs it on CUDA,
    and the bound; at the shapes of the two forwards also the kernel's and
    ``F.linear``'s time with the weights cold in L2 (rotating through
    copies of them that exceed it). Returns {(M, N, K, batch): row} of the
    timed shapes."""
    import torch.nn.functional as F

    from vilbert_multitask_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_plain,
        padded_rows,
        plan_launch,
    )

    gen = torch.Generator(device="cpu").manual_seed(0)
    timed, forward_shapes, head_nk = {}, set(), set()
    for rows in (1, 2, 32):
        for M, N, K, batch, _, what in int8_forward_shapes(mcfg, rows):
            if what in INT8_HEAD_PRODUCTS:
                head_nk.add((N, K, batch))
            if rows == 2:
                continue
            timed.setdefault((M, N, K, batch), f"{what}, bucket {rows}")
            forward_shapes.add((M, N, K, batch))
    nk = sorted({(N, K, batch) for _, N, K, batch, _, _ in
                 int8_forward_shapes(mcfg, 2)})
    for M in (38, 101, 38 * 32, 101 * 32):
        for N, K, batch in nk:
            timed.setdefault((M, N, K, batch), "table shape")
    cases = [(M, N, K, b, what, True) for (M, N, K, b), what in timed.items()]
    cases += [(M, N, K, b, what, False) for M, N, K, b, what in INT8_EDGES]
    pack_mm = getattr(torch.ops.aten, "_weight_int8pack_mm", None)
    pack_mm_ok = None
    rows_out, by_shape = [], {}
    for M, N, K, batch, what, time_it in cases:
        plan = plan_launch(M, N, K, batch)
        x16, q, s32, b16 = int8_operands(torch, gen, M, N, K, batch,
                                         torch.bfloat16, False)
        s16 = s32.to(torch.bfloat16).float()  # the trunk's scale
        x32, b32 = x16.float(), b16.float()
        paths = {}
        for scale_bf16, s in ((True, s16), (False, s32)):
            ref16 = int8_linear_plain(x16, q, s, b16).float()
            out16 = int8_linear(x16, q, s, b16, scale_bf16=scale_bf16)
            again16 = int8_linear(x16, q, s, b16, scale_bf16=scale_bf16)
            torch.cuda.synchronize()
            paths[scale_bf16] = bf16_check(out16.float(), ref16) + (
                bool(torch.equal(out16.view(torch.int16),
                                 again16.view(torch.int16))),)
        # f32: the kernel dequantizes with __fmul_rn whatever the scale.
        round_scale = (N, K, batch) not in head_nk
        s = s16 if round_scale else s32
        ref32 = int8_linear_plain(x32, q, s, b32)
        out32 = int8_linear(x32, q, s, b32)
        torch.cuda.synchronize()
        err16, used16, same_bits = max(paths.values(), key=lambda p: p[1])
        same_bits = all(p[2] for p in paths.values())
        d32 = (out32 - ref32).abs()
        err32 = d32.max().item()
        used32 = (d32 / (F32_TOL * ref32.abs().clamp_min(1.0))).max().item()
        row = dict(M=M, N=N, K=K, batch=batch, what=what,
                   timed_scale_path="bf16" if round_scale else "f32",
                   plan=dict(regime=plan.regime, tile_m=plan.tile_m,
                             tile_n=plan.tile_n, splits=plan.splits,
                             blocks=plan.blocks),
                   max_abs_err_bf16=err16, tol_used_bf16=used16,
                   max_abs_err_bf16_by_scale_path={
                       "bf16": paths[True][0], "f32": paths[False][0]},
                   bit_equal_bf16=bool(paths[True][0] == 0.0
                                       and paths[False][0] == 0.0),
                   two_launches_bit_identical=same_bits,
                   max_abs_err_f32=err32, tol_used_f32=used32)
        if time_it:
            w16 = (q.float() * s.unsqueeze(-1)).to(torch.bfloat16)

            def library(w, x=x16, b=b16, batch=batch):
                return (torch.baddbmm(b.unsqueeze(-2), x, w.transpose(-1, -2))
                        if batch > 1 else F.linear(x, w, b))

            fns = dict(
                kernel=lambda: int8_linear(x16, q, s, b16,
                                           scale_bf16=round_scale),
                plain=lambda: int8_linear_plain(x16, q, s, b16),
                library=lambda: library(w16))
            if (pack_mm is not None and batch == 1 and K % 32 == 0
                    and N % 8 == 0 and pack_mm_ok is not False):
                s_pack = s.to(torch.bfloat16)
                qc = q.contiguous()
                try:  # a yardstick only: the port never calls it
                    pack_mm(x16, qc, s_pack)
                    torch.cuda.synchronize()
                    pack_mm_ok = True
                except (RuntimeError, NotImplementedError) as e:
                    pack_mm_ok = False
                    report["int8pack_mm_error"] = str(e)[:300]
                if pack_mm_ok:
                    fns["int8pack_mm"] = lambda: pack_mm(x16, qc, s_pack)
            for name, fn in fns.items():
                row[f"{name}_ms"] = device_ms(fn, reps=9, inner=5)
            row["kernel_f32_ms"] = device_ms(
                lambda: int8_linear(x32, q, s, b32), reps=5, inner=2)
            if (M, N, K, batch) in forward_shapes:
                qs = cold_copies(lambda: padded_rows(q), q.numel())
                ws = cold_copies(w16.clone, 2 * w16.numel())
                row["kernel_cold_ms"] = rotation_ms(
                    [lambda qq=qq: int8_linear(x16, qq, s, b16,
                                               scale_bf16=round_scale)
                     for qq in qs])
                row["library_cold_ms"] = rotation_ms(
                    [lambda ww=ww: library(ww) for ww in ws])
                row["cold_copies"] = [len(qs), len(ws)]
                del qs, ws
            row["bound_bytes_ms"], row["bound_ops_ms"] = int8_bound_parts(
                M, N, K, batch, 2)
            row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
            row["bound_by"] = ("bytes" if row["bound_bytes_ms"]
                               >= row["bound_ops_ms"] else "operations")
            by_shape[(M, N, K, batch)] = row
        rows_out.append(row)
        log("int8_linear M=%d N=%d K=%d batch=%d (%s) [%s]: err_bf16=%.3e "
            "(%.2f of tol%s) err_f32=%.3e (%.2f of tol)%s%s" % (
                M, N, K, batch, what, plan_text(plan), err16, used16,
                ", bit-equal" if err16 == 0.0 else "", err32, used32,
                "" if same_bits else " TWO LAUNCHES DIFFER",
                "" if not time_it else
                " | kernel_ms=%.5f plain_ms=%.5f library_ms=%.5f%s%s "
                "f32_kernel_ms=%.5f bound_ms=%.6f (%s)" % (
                    row["kernel_ms"], row["plain_ms"], row["library_ms"],
                    " int8pack_mm_ms=%.5f" % row["int8pack_mm_ms"]
                    if "int8pack_mm_ms" in row else "",
                    " cold: kernel %.5f library %.5f" % (
                        row["kernel_cold_ms"], row["library_cold_ms"])
                    if "kernel_cold_ms" in row else "",
                    row["kernel_f32_ms"], row["bound_ms"], row["bound_by"])))
        if not used16 <= 1.0:
            raise AssertionError(
                f"int8_linear bf16 error {err16:.3e} beyond atol {BF16_ATOL}"
                f" + rtol {BF16_RTOL} at {(M, N, K, batch)} ({what})")
        if not used32 <= 1.0:
            raise AssertionError(
                f"int8_linear f32 error {err32:.3e} beyond {F32_TOL} x "
                f"max(1, |ref|) at {(M, N, K, batch)} ({what})")
        if not same_bits:
            raise AssertionError(f"int8_linear: two launches on the same "
                                 f"inputs differ at {(M, N, K, batch)}")
    # Strided x: the poolers read the first token of each row in place,
    # the label pair's dense2 reads each head's rows through a transpose.
    x16, q, s, b16 = int8_operands(torch, gen, 4, 1024, 768, 1,
                                   torch.bfloat16, True)
    seq = torch.randn(4, 38, 768, generator=gen).to("cuda", torch.bfloat16)
    first = seq[:, 0]
    xq, qq, sq, bq = int8_operands(torch, gen, 5, 3129, 2048, 2,
                                   torch.bfloat16, False)
    h = torch.randn(5, 2, 2048, generator=gen).to("cuda", torch.bfloat16)
    strided = {}
    for what, args in (("pooler first token", (first, q, s, b16)),
                       ("label pair through a transpose",
                        (h.transpose(0, 1), qq, sq, bq))):
        err, used = bf16_check(int8_linear(*args).float(),
                               int8_linear_plain(
                                   args[0].contiguous(), *args[1:]).float())
        log(f"int8_linear strided x ({what}): max abs err {err:.3e} "
            f"({used:.2f} of tol)")
        if not used <= 1.0:
            raise AssertionError(f"int8_linear strided ({what}) error {err}")
        strided[what] = err
    report["int8_linear_shapes"] = rows_out
    report["int8_linear_strided_err"] = strided
    report["int8pack_mm_on_cuda"] = pack_mm_ok
    return by_shape


# ------------------------------------------------------------ phase detect
def seeded_rgb(seed: int, h: int, w: int):
    """A seeded (h, w, 3) uint8 RGB image: smooth colour fields with
    rectangles and noise, so the detector sees edges at several scales."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / rng.uniform(20, 200)
                                       + rng.uniform(0, 6)),
                    127 + 100 * np.cos(yy / rng.uniform(20, 200)),
                    127 + 60 * np.sin((xx + yy) / rng.uniform(30, 300))], -1)
    for _ in range(12):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + rng.integers(h // 20 + 1, h // 3 + 2),
            x0:x0 + rng.integers(w // 20 + 1, w // 3 + 2)] = rng.uniform(
                0, 255, 3)
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


class plain_kernels:
    """Within this block the detector's NMS and ROIAlign calls go to their
    plain versions (module attributes swapped, restored on exit)."""

    def __enter__(self):
        from vilbert_multitask_tpu_torch.detect import model as dm
        from vilbert_multitask_tpu_torch.ops import nms as nm

        self.saved = (dm.nms_mask, nm.nms_mask, dm.roi_align)
        dm.nms_mask = nm.nms_mask = nm.nms_mask_plain
        dm.roi_align = dm.roi_align_plain
        return self

    def __exit__(self, *exc):
        from vilbert_multitask_tpu_torch.detect import model as dm
        from vilbert_multitask_tpu_torch.ops import nms as nm

        dm.nms_mask, nm.nms_mask, dm.roi_align = self.saved
        return False


def detector_pieces(torch, ex, rgb) -> dict:
    """One image through the extractor's pieces on its stream, with the
    wrappers as they are bound now: proposals and their scores, class
    scores, fc6 and the selection."""
    from vilbert_multitask_tpu_torch.features.extract import preprocess_image
    from vilbert_multitask_tpu_torch.ops import nms as nm

    cfg = ex.cfg
    with ex._lock, ex._context():
        bgr, _ = preprocess_image(torch.from_numpy(rgb).to(ex.device),
                                  min_size=800, max_size=min(1333,
                                                             cfg.canvas))
        padded = torch.zeros((cfg.canvas, cfg.canvas, 3), device=ex.device)
        padded[:bgr.shape[0], :bgr.shape[1]] = bgr
        feats = ex.model.features(padded)
        props, pscores = ex.model.propose(feats, (bgr.shape[0],
                                                  bgr.shape[1]))
        cls, fc6 = ex.model.box_head(feats, props)
        sel = nm.select_top_regions(props, cls, num_keep=ex.num_keep)
        ex._stream.synchronize()
    return dict(feats=feats, props=props, pscores=pscores, cls=cls, fc6=fc6,
                keep=sel[0], num_valid=int(sel[1].item()))


def profile_split(torch, ex, rgb) -> dict:
    """torch.profiler over one extraction: device time of the kernels each
    ``detect.*`` range launched (a kernel counts for the innermost range
    around the op that launched it), the device's busy time and the top
    kernels."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ex.extract_array(rgb)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in events
              if e.device_type == cpu and e.name.startswith("detect.")]
    split = defaultdict(float)
    for e in events:
        if e.device_type != cpu or not e.kernels:
            continue
        owners = [r for r in ranges if r.thread == e.thread
                  and r.time_range.start <= e.time_range.start
                  and e.time_range.end <= r.time_range.end]
        owner = (min(owners, key=lambda r: r.time_range.elapsed_us()).name
                 if owners else "other")
        split[owner] += sum(k.duration for k in e.kernels) / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("detect.")):
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    handwritten = {k: v[0] for k, v in by_name.items() if re.search(
        r"nms_[a-z_]+_kernel|roi_align_kernel", k)}
    return {"split_ms": dict(split), "device_busy_ms": busy,
            "profiled_wall_ms": wall_ms,
            "device_ops": sum(v[1] for v in by_name.values()),
            "handwritten_kernels_ms": handwritten,
            "top_kernels": [{"name": k[:120], "ms": v[0], "n": v[1]}
                            for k, v in top]}


def layout_probe(torch, ex, rgb) -> dict:
    """Device time of the backbone and FPN (the detector's convolutions)
    on one image, with the model and its input in channels-last (as the
    extractor runs them) or in contiguous NCHW, and cuDNN's TF32 off or
    on: CUDA events, 6 timed runs of each after a warm-up, the four
    settings in turns. The
    extractor is not changed; an NCHW copy of its model is made here."""
    import copy

    from vilbert_multitask_tpu_torch.features.extract import preprocess_image

    cfg = ex.cfg
    nchw_model = copy.deepcopy(ex.model).to(
        memory_format=torch.contiguous_format)
    times = {}
    with torch.inference_mode():
        bgr, _ = preprocess_image(torch.from_numpy(rgb).to(ex.device))
        padded = torch.zeros((cfg.canvas, cfg.canvas, 3), device=ex.device)
        padded[:bgr.shape[0], :bgr.shape[1]] = bgr
        inputs = {"channels_last": (ex.model, padded.permute(2, 0, 1)[None]),
                  "nchw": (nchw_model,
                           padded.permute(2, 0, 1)[None].contiguous())}
        for rnd in range(4):  # a warm-up round, then 3 timed ones
            for layout in ("channels_last", "nchw", "nchw", "channels_last"):
                model, x = inputs[layout]
                for tf32 in (False, True):
                    with torch.backends.cudnn.flags(
                            enabled=True, benchmark=False,
                            deterministic=False, allow_tf32=tf32):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        model.fpn(model.backbone(x))
                        end.record()
                        end.synchronize()
                    if rnd:
                        times.setdefault(
                            f"{layout}/{'tf32' if tf32 else 'f32'}",
                            []).append(start.elapsed_time(end))
    del nchw_model
    torch.cuda.empty_cache()
    return times


def host_probe(torch, ex, rgb, runs: int = 5) -> dict:
    """Is the eager forward bound by the host's launches? Per run, on the
    extractor's stream: the host time until ``forward`` has enqueued its
    work, and the device time to its end (CUDA events), alone and then
    with one other Python thread spinning (as a serving process's threads
    compete for the interpreter lock); medians."""
    import threading

    from vilbert_multitask_tpu_torch.features.extract import preprocess_image

    def once() -> tuple:
        with ex._lock, ex._context():
            bgr, _ = preprocess_image(torch.from_numpy(rgb).to(ex.device))
            ex._stream.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record(ex._stream)
            ex.forward(bgr, (bgr.shape[0], bgr.shape[1]))
            t1 = time.perf_counter()
            end.record(ex._stream)
            end.synchronize()
        return (t1 - t0) * 1e3, start.elapsed_time(end)

    def spin(stop: threading.Event) -> None:
        while not stop.is_set():
            pass

    out = {}
    for mode in ("alone", "one busy thread"):
        stop = threading.Event()
        spinner = threading.Thread(target=spin, args=(stop,),
                                   name="spinner")
        if mode != "alone":
            spinner.start()
        try:
            runs_ms = [once() for _ in range(runs)]
        finally:
            stop.set()
            if spinner.is_alive():
                spinner.join()
        out[mode] = {
            "enqueue_ms": statistics.median(r[0] for r in runs_ms),
            "device_ms": statistics.median(r[1] for r in runs_ms)}
    return out


def timed_extractions(torch, ex, images: list) -> dict:
    """Warm extractions, the images in turn: per run the device time
    (CUDA events on the extractor's stream around ``extract_array``) and
    the host wall time."""
    dev_ms, wall_ms = [], []
    for k in range(DETECT_TIMED_RUNS):
        rgb = images[k % len(images)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record(ex._stream)
        ex.extract_array(rgb)
        end.record(ex._stream)
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return {"device_ms": dev_ms, "wall_ms": wall_ms,
            "device_p50": statistics.median(dev_ms),
            "wall_p50": statistics.median(wall_ms)}


def check_detect(torch, report: dict) -> dict:
    """The detector at full width (``DetectorConfig()``, canvas 1344, 300
    proposals) on seeded weights and seeded images of four sizes."""
    import numpy as np

    from vilbert_multitask_tpu_torch.config import DetectorConfig
    from vilbert_multitask_tpu_torch.detect import model as dm
    from vilbert_multitask_tpu_torch.detect.extractor import (
        LiveFeatureExtractor,
    )
    from vilbert_multitask_tpu_torch.ops import nms as nm

    cfg = DetectorConfig()
    t0 = time.perf_counter()
    ex = LiveFeatureExtractor(cfg, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in ex.model.parameters())
    t0 = time.perf_counter()
    ex.warmup()
    warm_s = time.perf_counter() - t0
    log(f"detect: DetectorConfig() (X-152-32x8d-FPN, canvas {cfg.canvas}), "
        f"{n_params} parameters, seeded init + upload {init_s:.1f}s, warmup "
        f"{warm_s:.1f}s, f32 (cuDNN TF32 off)")
    images = [seeded_rgb(100 + i, h, w)
              for i, (_, h, w) in enumerate(DETECT_IMAGES)]
    per_image = []
    total = {"nms": 0, "roi_align": 0}
    for (name, h, w), rgb in zip(DETECT_IMAGES, images):
        # The main path: extract_array, counters zeroed just before.
        nm.nms_mask.launches = dm.roi_align.launches = 0
        region = ex.extract_array(rgb)
        torch.cuda.synchronize()
        k1, k2 = nm.nms_mask.launches, dm.roi_align.launches
        total["nms"] += k1
        total["roi_align"] += k2
        if (k1, k2) != (NMS_PER_IMAGE, ROI_PER_IMAGE):
            raise AssertionError(f"detect {name}: {k1} nms and {k2} "
                                 f"roi_align launches, want 2 and 1")
        b = region.boxes
        if (region.features.shape != (region.num_boxes,
                                      cfg.representation_size)
                or not 1 <= region.num_boxes <= ex.num_keep
                or not np.isfinite(region.features).all()
                or not np.isfinite(b).all() or b.min() < 0
                or b[:, 2].max() > w + 1 or b[:, 3].max() > h + 1):
            raise AssertionError(f"detect {name}: {region.num_boxes} boxes, "
                                 f"features {region.features.shape}")
        # Kernels against plain versions on the same convolutions.
        k = detector_pieces(torch, ex, rgb)
        with plain_kernels():
            p = detector_pieces(torch, ex, rgb)
            p_on_k = nm.select_top_regions(k["props"], k["cls"],
                                           num_keep=ex.num_keep)[0]
        fc6_err = (k["fc6"] - p["fc6"]).abs()
        fc6_used = (fc6_err / (ROI_ATOL + ROI_RTOL * p["fc6"].abs())
                    ).max().item()
        same = dict(
            proposals=torch.equal(k["props"], p["props"]),
            proposal_scores=torch.equal(k["pscores"], p["pscores"]),
            kept=torch.equal(k["keep"], p["keep"]),
            selection_on_same_scores=torch.equal(k["keep"], p_on_k))
        ps, cls = k["pscores"], k["cls"]
        live = ps[ps > 0]
        spread = dict(
            proposal_score_min=live.min().item() if len(live) else 0.0,
            proposal_score_max=ps.max().item(),
            distinct_proposal_scores=int(torch.unique(ps).numel()),
            suppressed_or_degenerate=int((ps == 0).sum().item()),
            cls_max=cls.max().item(), cls_min=cls.min().item(),
            distinct_top_class_scores=int(torch.unique(
                cls[:, 1:].amax(dim=1)).numel()),
            num_valid=k["num_valid"])
        row = dict(image=name, h=h, w=w, num_boxes=region.num_boxes,
                   launches={"nms": k1, "roi_align": k2}, same=same,
                   fc6_max_abs_err=fc6_err.max().item(),
                   fc6_tol_used=fc6_used, spread=spread,
                   level_map_sizes=[list(f.shape[2:]) for f in k["feats"]])
        per_image.append(row)
        log(f"detect {name}: {region.num_boxes} regions, launches nms {k1} "
            f"roi_align {k2}; kernels vs plain: {same}, fc6 max abs err "
            f"{row['fc6_max_abs_err']:.3e} ({fc6_used:.3f} of tol); scores "
            f"{spread}")
        if not all(same.values()) or not fc6_used <= 1.0:
            raise AssertionError(f"detect {name}: the kernel extractor "
                                 f"differs from the plain one: {row}")
        if (spread["distinct_proposal_scores"] < cfg.rpn_post_nms_top_n // 2
                or not 0.0 < spread["proposal_score_max"] < 1.0
                or not spread["cls_max"] < 0.99
                or spread["distinct_top_class_scores"]
                < cfg.rpn_post_nms_top_n // 2):
            raise AssertionError(f"detect {name}: saturated or tied scores "
                                 f"{spread}")
        del k, p
    # Device and wall time over warm extractions; the split of one.
    timing = timed_extractions(torch, ex, images)
    split = profile_split(torch, ex, images[2])
    log(f"detect: device time per image p50 {timing['device_p50']:.3f} ms "
        f"(min {min(timing['device_ms']):.3f}, max "
        f"{max(timing['device_ms']):.3f}, n={len(timing['device_ms'])}); "
        f"extract_array wall p50 {timing['wall_p50']:.3f} ms; profiled "
        f"1333x800 image: device busy {split['device_busy_ms']:.3f} ms in "
        f"{split['device_ops']} kernels and copies, "
        f"split {json.dumps({k: round(v, 3) for k, v in split['split_ms'].items()})}"
        f" on {report['device']['nvidia_smi']}")
    log("detect: top kernels " + json.dumps(split["top_kernels"][:6])
        + "; hand-written kernels (profiled) "
        + json.dumps(split["handwritten_kernels_ms"]))
    launch_bound = host_probe(torch, ex, images[2])
    log("detect: forward of the 1333x800 image, host time to enqueue "
        "against device time on the extractor's stream (median of 5): "
        + json.dumps(launch_bound))
    layouts = layout_probe(torch, ex, images[2])
    log("detect: backbone + FPN device ms by memory format and cuDNN "
        "precision (1333x800 image, median of 6, in turns): " + json.dumps(
            {k: round(statistics.median(v), 3) for k, v in layouts.items()}))
    # TF32 against full f32, in one call, in turns: f32, tf32, tf32, f32.
    ex32 = LiveFeatureExtractor(cfg, device="cuda", allow_tf32=True)
    ex32.warmup()
    turns = {"f32": [], "tf32": []}
    for mode in ("f32", "tf32", "tf32", "f32"):
        turns[mode].append(timed_extractions(
            torch, ex if mode == "f32" else ex32, images)["device_p50"])
    overlap = []
    for rgb in images:
        a = ex.extract_array(rgb)
        t = ex32.extract_array(rgb)
        same_boxes = {tuple(r) for r in np.round(a.boxes, 1).tolist()} & {
            tuple(r) for r in np.round(t.boxes, 1).tolist()}
        overlap.append(len(same_boxes) / max(a.num_boxes, 1))
    log(f"detect: TF32 convolutions: device p50 {turns['tf32']} ms against "
        f"f32 {turns['f32']} ms (turns f32, tf32, tf32, f32); kept boxes "
        f"shared with f32 per image {[round(o, 3) for o in overlap]}")
    del ex32
    report["detect"] = {
        "config": "DetectorConfig()", "parameters": n_params,
        "init_s": init_s, "warmup_s": warm_s, "images": per_image,
        "launches": total, "timing": timing, "profile": split,
        "tf32": {"device_p50_ms": turns, "kept_box_overlap": overlap},
        "layout_probe_ms": layouts, "host_probe_ms": launch_bound,
        "precision": "f32 (cuDNN allow_tf32=False)"}
    del ex
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- phase 4
REQUESTS = (  # one per decode family: (task id, question, image keys)
    (1, "what is the man holding", ["img_0"]),
    (15, "is the bowl to the right of the mug", ["img_1"]),
    (11, "the woman in the red coat", ["img_2"]),
    (13, "two dogs are playing in the snow", ["img_3"]),
    (12, "both images contain exactly two wolves", ["img_0", "img_1"]),
    (7, "a man riding a horse on the beach",
     ["img_0", "img_1", "img_2", "img_3"]),
)


def write_features(root: str, dim: int) -> None:
    """img_0..img_3 (phase 4, drawn as in every earlier run of this
    script), then img_4..img_7 (phases 6-7) from a second generator."""
    import numpy as np

    from vilbert_multitask_tpu_torch.features.pipeline import (
        synthetic_regions,
    )
    from vilbert_multitask_tpu_torch.features.store import save_reference_npy

    for first, seed in ((0, 1234), (4, 5678)):
        rng = np.random.default_rng(seed)
        for i in range(first, first + 4):
            region = synthetic_regions(dim, n_boxes=100, rng=rng)
            save_reference_npy(os.path.join(root, f"img_{i}.npy"), region,
                               f"img_{i}")


def check_result(spec, result, n_images: int) -> None:
    if result.task_id != spec.task_id or result.kind != spec.decode:
        raise AssertionError(f"task {spec.task_id}: got {result.to_json()}")
    if spec.decode in ("labels", "binary", "trinary"):
        want = {"binary": 2, "trinary": 3}.get(spec.decode, spec.top_k)
        confs = [a["confidence"] for a in result.answers]
        if (len(confs) != want or confs != sorted(confs, reverse=True)
                or not all(0.0 <= c <= 1.0 for c in confs)):
            raise AssertionError(f"task {spec.task_id}: {result.to_json()}")
    elif spec.decode == "grounding":
        if len(result.boxes) != spec.top_k or not all(
                math.isfinite(b["score"]) and math.isfinite(b["confidence"])
                for b in result.boxes):
            raise AssertionError(f"task {spec.task_id}: {result.to_json()}")
    elif spec.decode == "ranking":
        ranks = [r["rank"] for r in result.ranking]
        if ranks != list(range(1, n_images + 1)) or not all(
                math.isfinite(r["score"]) for r in result.ranking):
            raise AssertionError(f"task {spec.task_id}: {result.to_json()}")


def flat_bundle(bundle: dict) -> dict:
    """Float leaves of a host decode bundle (top-k probabilities, small
    heads), keyed by name; top-k indices are not compared by value."""
    out = {}
    for name, (probs, _idx) in bundle["labels_top"].items():
        out[f"{name}.top_probs"] = probs
    for name in ("vil_logit", "vil_tri_prediction", "vision_logit",
                 "vil_binary_prediction"):
        if name in bundle:
            out[name] = bundle[name]
    return out


def compare_bundles(ref: dict, got: dict, tol: dict, what: str) -> tuple:
    """(max abs error, share of the tolerance used: the largest
    |got - ref| / (atol + rtol |ref|)) over the float leaves."""
    import numpy as np

    worst = used = 0.0
    for name, r in flat_bundle(ref).items():
        g = flat_bundle(got)[name]
        if r.shape != g.shape or not np.isfinite(g).all():
            raise AssertionError(f"{what}: {name} shape {g.shape} vs "
                                 f"{r.shape} or non-finite")
        # Masked grounding rows carry the -10000 bias (-9984 in bf16); the
        # relative tolerance covers that the same way for every leaf.
        np.testing.assert_allclose(g, r, err_msg=f"{what}: {name}", **tol)
        err = np.abs(g.astype(np.float64) - r)
        worst = max(worst, float(err.max()))
        used = max(used, float((err / (tol["atol"] + tol["rtol"] * np.abs(r))
                                ).max()))
    return worst, used


def main_path(torch, report: dict, root: str):
    import dataclasses

    from vilbert_multitask_tpu_torch.config import (
        TASK_REGISTRY,
        EngineConfig,
        FrameworkConfig,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine,
        init_state_dict,
    )
    from vilbert_multitask_tpu_torch.features.store import FeatureStore
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )

    cfg = FrameworkConfig()  # ViLBertConfig() + EngineConfig(): bf16, fused
    t0 = time.perf_counter()
    weights = init_state_dict(cfg.model, seed=0)
    n_params = sum(v.numel() for k, v in weights.items()
                   if k != "cls.predictions.decoder.weight")
    log(f"main path: {n_params} parameters, seeded init "
        f"{time.perf_counter() - t0:.1f}s")
    results = {}
    write_features(root, cfg.model.v_feature_size)
    store = FeatureStore(root)
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params=weights, feature_store=store,
                          device="cuda")
    torch.cuda.synchronize()
    log(f"main path: bf16 engine on {eng.device} in "
        f"{time.perf_counter() - t0:.1f}s")

    # The main path, through predict(): the launch counter is zeroed
    # just before each request and read just after it.
    total = 0
    for task_id, question, keys in REQUESTS:
        spec = TASK_REGISTRY[task_id]
        flash_cross_attention.launches = 0
        result = eng.predict(task_id, question, keys)
        torch.cuda.synchronize()
        n = flash_cross_attention.launches
        total += n
        check_result(spec, result, len(keys))
        log(f"predict task {task_id} ({spec.name}, {len(keys)} image(s)):"
            f" {n} flash_attn launches -> {json.dumps(result.to_json())[:160]}")
        if n != LAUNCHES_PER_FORWARD:
            raise AssertionError(
                f"task {task_id}: {n} kernel launches, expected "
                f"{LAUNCHES_PER_FORWARD} per forward")
        results[task_id] = result.to_json()
    report["main_path_results"] = results
    report["main_path_launches"] = total

    # The same requests and weights: card-f32 and CPU-f32 engines.
    f32 = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, compute_dtype="float32"))
    eng32 = InferenceEngine(f32, params=weights, feature_store=store,
                            device="cuda")
    cpu32 = InferenceEngine(f32, params=weights, feature_store=store,
                            device="cpu")
    worst = {"bf16_card_vs_f32_cpu": (0.0, 0.0),
             "f32_card_vs_f32_cpu": (0.0, 0.0)}
    for task_id, question, keys in REQUESTS:
        ref = cpu32.bundle(cpu32.prepare_from_store(task_id, question,
                                                    keys))[1]
        b16 = eng.bundle(eng.prepare_from_store(task_id, question,
                                                keys))[1]
        b32 = eng32.bundle(eng32.prepare_from_store(task_id, question,
                                                    keys))[1]
        for key, got, tol in (("bf16_card_vs_f32_cpu", b16, BUNDLE_BF16),
                              ("f32_card_vs_f32_cpu", b32, BUNDLE_F32)):
            err, used = compare_bundles(ref, got, tol,
                                        f"task {task_id} {key}")
            worst[key] = (max(worst[key][0], err),
                          max(worst[key][1], used))
    report["bundle_max_abs_err"] = {k: v[0] for k, v in worst.items()}
    report["bundle_tol_used"] = {k: v[1] for k, v in worst.items()}
    (e16, u16), (e32, u32) = worst.values()
    log(f"decode bundles vs CPU f32: bf16 card max abs err {e16:.3e}, "
        f"{u16:.2f} of rtol 0.1 + atol 0.05; f32 card max abs err "
        f"{e32:.3e}, {u32:.2f} of rtol 2e-3 + atol 2e-3")

    # run(collect_attention=True): the bridges take the dense path (it
    # returns the probabilities), so only the 6 visual self-attentions
    # launch the kernel; the maps match the CPU-f32 engine's.
    task_id, question, keys = REQUESTS[0]
    flash_cross_attention.launches = 0
    out = eng.run(eng.prepare_from_store(task_id, question, keys),
                  collect_attention=True)[0]
    torch.cuda.synchronize()
    n_attn = flash_cross_attention.launches
    ref = cpu32.run(cpu32.prepare_from_store(task_id, question, keys),
                    collect_attention=True)[0]
    worst_maps = 0.0
    for got_pair, ref_pair in zip(out.attn_data_list, ref.attn_data_list):
        for g, r in zip(got_pair, ref_pair):
            g = g.float().cpu()
            if not torch.allclose(g.sum(-1), torch.ones(()), atol=2e-2):
                raise AssertionError("attention rows do not sum to 1")
            worst_maps = max(worst_maps, (g - r).abs().max().item())
    log(f"collect_attention: {len(out.attn_data_list)} bridge map pairs, "
        f"{n_attn} flash_attn launches, max abs err vs CPU f32 "
        f"{worst_maps:.3e} (atol 0.05)")
    if (len(out.attn_data_list) != cfg.model.num_connection_layers
            or n_attn != cfg.model.v_num_hidden_layers
            or not worst_maps <= BUNDLE_BF16["atol"]):
        raise AssertionError("collect_attention run is off")
    report["collect_attention"] = {"launches": n_attn,
                                   "max_abs_err": worst_maps}
    del eng32, cpu32

    # p50 of run() at bucket 1 (VQA), warm.
    req = eng.prepare_from_store(1, REQUESTS[0][1], REQUESTS[0][2])
    for _ in range(5):
        eng.run(req)
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        eng.run(req)
        times.append((time.perf_counter() - t0) * 1e3)
    report["run_ms_bucket1"] = {"p50": statistics.median(times),
                                "min": min(times), "max": max(times),
                                "n": len(times)}
    log(f"run() at bucket 1: p50 {statistics.median(times):.3f} ms "
        f"(min {min(times):.3f}, max {max(times):.3f}, n={len(times)}) "
        f"on {report['device']['nvidia_smi']}")
    return eng


# ---------------------------------------------------------------- phase 5
def graph_rows(n: int) -> list:
    """Requests whose rows fill exactly ``n`` rows of one chunk: an NLVR2
    pair first when n >= 2 (even offset), then single-image requests of
    four families over the eight feature files."""
    specs = []
    if n >= 2:
        specs.append((12, "both images contain exactly two wolves",
                      ["img_4", "img_5"]))
    singles = ((1, "what is the man holding"), (15, "is the bowl left"),
               (13, "two dogs are playing"), (11, "the woman in red"))
    for k in range(n - 2 * bool(n >= 2)):
        task_id, question = singles[k % 4]
        specs.append((task_id, f"{question} {k}", [f"img_{k % 8}"]))
    return specs


def check_graphs(torch, report: dict, eng) -> None:
    """Capture every row bucket, then per bucket: graph replay against the
    eager forward on the same packed rows; 18 kernel launches in a
    profiled bucket-1 replay."""
    from torch.profiler import ProfilerActivity, profile

    from vilbert_multitask_tpu_torch.engine import graphs
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )

    buckets = eng.cfg.engine.all_row_buckets()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    if sorted(eng._graphs) != buckets:
        raise AssertionError(f"captured {sorted(eng._graphs)}, want {buckets}")
    pool = graphs.pool_bytes(eng._graph_pool, eng.device)
    log(f"graphs: {len(buckets)} buckets {buckets} captured in "
        f"{capture_s:.2f}s (per bucket: " + ", ".join(
            f"b{b} {eng._graphs[b].capture_s:.2f}s" for b in buckets)
        + f"); graph pool {pool if pool is None else pool / 2**20:.1f} MiB; "
        f"device memory allocated {torch.cuda.memory_allocated() / 2**20:.0f}"
        f" MiB, reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB")
    rows = {}
    for b in buckets:
        reqs = [eng.prepare_from_store(t, q, imgs)
                for t, q, imgs in graph_rows(b)]
        if sum(r.n_images for r in reqs) != b:
            raise AssertionError(f"bucket {b}: rows do not fill it")
        graph_bundle = eng._dispatch_many(reqs).fetch()
        saved, eng._graphs = eng._graphs, {}
        try:
            eager_bundle = eng._dispatch_many(reqs).fetch()
        finally:
            eng._graphs = saved
        diff, _ = compare_bundles(eager_bundle, graph_bundle, BUNDLE_BF16,
                                  f"bucket {b} graph vs eager")
        rows[b] = {"max_abs_diff": diff, "bit_equal": diff == 0.0,
                   "capture_s": eng._graphs[b].capture_s,
                   "launches_per_replay": {
                       w.__name__: n
                       for w, n in eng._graphs[b].launches.items()}}
        log(f"graphs: bucket {b}: replay vs eager max abs diff {diff:.3e}"
            f" ({'bit-equal' if diff == 0.0 else 'within rtol 0.1 / atol 0.05'})")
    # One profiled bucket-1 replay: the kernels the graph launched.
    g = eng._graphs[1]
    torch.cuda.synchronize()
    flash_cross_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(eng._stream):
            g.replay()
        torch.cuda.synchronize()
    counted = flash_cross_attention.launches
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    flash = [e for e in kernels if "flash_attn_bf16_kernel" in e.name]
    log(f"graphs: profiled bucket-1 replay: {len(kernels)} kernels on the "
        f"card, {len(flash)} flash_attn_bf16_kernel, counter +{counted}")
    if len(flash) != LAUNCHES_PER_FORWARD or counted != LAUNCHES_PER_FORWARD:
        raise AssertionError(
            f"bucket-1 replay: {len(flash)} flash_attn_bf16_kernel launches "
            f"in the trace, counter +{counted}; want {LAUNCHES_PER_FORWARD}")
    report["graphs"] = {
        "buckets": rows, "capture_s": capture_s, "pool_bytes": pool,
        "replay_kernels_bucket1": len(kernels),
        "replay_flash_launches_bucket1": len(flash),
        "replay_flash_device_ms_bucket1":
            sum(e.time_range.elapsed_us() for e in flash) / 1e3}


# ---------------------------------------------------------------- phase 6
def backlog() -> list:
    """40 requests over the eight feature files, repeated images
    included: 10 VQA, 6 GQA, 6 SNLI-VE, 6 NLVR2 pairs, 6 retrievals over
    4 images and 6 groundings (Visual7W, RefCOCO, GuessWhat)."""
    specs = []
    for k in range(10):
        specs.append((1, f"what is on the table {k}", [f"img_{k % 8}"]))
    for k in range(6):
        img = f"img_{(3 * k) % 8}"
        specs += [
            (15, f"is the cup left of the plate {k}", [img]),
            (13, f"a person is outside {k}", [img]),
            (12, f"there are two dogs {k}",
             [f"img_{k % 8}", f"img_{(k + 3) % 8}"]),
            (7, f"a red bus on the street {k}",
             [f"img_{(k + j) % 8}" for j in range(4)]),
            ((4, 11, 16)[k % 3], f"the thing on the left {k}", [img]),
        ]
    return specs


def top1(bundle: dict, row: int):
    _, idx = bundle["labels_top"]["vil_prediction"]
    return int(idx[row, 0])


def tied_top1(bundle: dict, row: int) -> set:
    """The labels whose probability equals the first one's exactly: the
    sort orders them, not the model."""
    val, idx = bundle["labels_top"]["vil_prediction"]
    return {int(i) for v, i in zip(val[row], idx[row]) if v == val[row, 0]}


def check_batched(torch, report: dict, eng) -> int:
    """run_many over a mixed backlog against run() of each request on the
    same engine; rows/s at 32-row chunks; run() p50 through the graph and
    eagerly. Returns the kernel launches of the run_many call."""
    import numpy as np

    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )

    specs = backlog()
    reqs = [eng.prepare_from_store(t, q, imgs) for t, q, imgs in specs]
    plan = eng.chunk_plan([r.n_images for r in reqs])
    # The main path of this phase: the backlog through run_many.
    hits0 = eng.input_cache_stats["hits"]
    flash_cross_attention.launches = 0
    streamed = []
    results = eng.run_many(reqs, on_result=lambda pos, res:
                           streamed.append(pos))
    torch.cuda.synchronize()
    launches = flash_cross_attention.launches
    hits = eng.input_cache_stats["hits"] - hits0
    if sorted(streamed) != list(range(len(reqs))) or launches != \
            LAUNCHES_PER_FORWARD * len(plan):
        raise AssertionError(f"run_many: streamed {len(streamed)} of "
                             f"{len(reqs)}, {launches} launches for "
                             f"{len(plan)} chunks")
    # Chunk by chunk, the same packing: each request's rows against its
    # own run().
    worst = used = 0.0
    worst_at = None
    flips = []
    for chunk in plan:
        bundle = eng._dispatch_many([reqs[i] for i in chunk]).fetch()
        row = 0
        for i in chunk:
            r = reqs[i]
            solo = eng.bundle(r)[1]
            got = {"labels_top": {k: tuple(a[row:row + r.n_images]
                                           for a in v)
                                  for k, v in bundle["labels_top"].items()}}
            for name in ("vil_logit", "vil_tri_prediction", "vision_logit"):
                got[name] = bundle[name][row:row + r.n_images]
            want = {k: v for k, v in solo.items()
                    if k != "vil_binary_prediction"}
            want["labels_top"] = {k: tuple(a[:r.n_images] for a in v)
                                  for k, v in solo["labels_top"].items()}
            for name in ("vil_logit", "vil_tri_prediction", "vision_logit"):
                want[name] = solo[name][:r.n_images]
            if r.spec.decode == "binary":
                got["vil_binary_prediction"] = \
                    bundle["vil_binary_prediction"][row // 2:row // 2 + 1]
                want["vil_binary_prediction"] = \
                    solo["vil_binary_prediction"][:1]
            err, u = compare_bundles(want, got, BUNDLE_BF16,
                                     f"run_many request {i} "
                                     f"({r.spec.name})")
            if u > used:
                fw, fg = flat_bundle(want), flat_bundle(got)

                def share(name):
                    return float((np.abs(fg[name] - fw[name]) / (
                        BUNDLE_BF16["atol"]
                        + BUNDLE_BF16["rtol"] * np.abs(fw[name]))).max())

                worst_at = (i, r.spec.name, max(fw, key=share))
            worst, used = max(worst, err), max(used, u)
            if r.spec.decode == "labels" and top1(got, 0) not in \
                    tied_top1(want, 0) and top1(want, 0) not in \
                    tied_top1(got, 0):
                flips.append(i)
            row += r.n_images
        for i, res in zip(chunk, [results[i] for i in chunk]):
            if res.kind != reqs[i].spec.decode:
                raise AssertionError(f"request {i}: {res.to_json()}")
    log(f"batched: {len(reqs)} requests, {sum(r.n_images for r in reqs)} "
        f"rows in {len(plan)} chunks (rows {[sum(reqs[i].n_images for i in c) for c in plan]}), "
        f"{launches} flash_attn launches; vs run(): max abs err {worst:.3e}, "
        f"{used:.2f} of rtol 0.1 + atol 0.05 (request, task, leaf: "
        f"{worst_at}), top-1 label flips {flips}; "
        f"input-cache hits {hits}")
    if flips:
        raise AssertionError(f"run_many top-1 labels differ from run() for "
                             f"requests {flips}")
    if hits <= 0:
        raise AssertionError("no input-cache hits on repeated images")

    # Rows/s at 32-row chunks: 96 single-image VQA requests, 3 chunks.
    vqa = [eng.prepare_from_store(1, f"what colour is it {k}",
                                  [f"img_{k % 8}"]) for k in range(96)]
    eng.run_many(vqa)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.run_many(vqa, chunk_rows=32)
        walls.append(time.perf_counter() - t0)
    rows_per_s = [len(vqa) / w for w in walls]
    # run() p50 at bucket 1, through the graph and eagerly.
    req = eng.prepare_from_store(1, REQUESTS[0][1], REQUESTS[0][2])
    p50 = {}
    for mode in ("graph", "eager"):
        saved = eng._graphs
        if mode == "eager":
            eng._graphs = {}
        try:
            for _ in range(5):
                eng.run(req)
            times = []
            for _ in range(30):
                t0 = time.perf_counter()
                eng.run(req)
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            eng._graphs = saved
        p50[mode] = {"p50": statistics.median(times), "min": min(times),
                     "max": max(times), "n": len(times)}
    log(f"batched: run_many of 96 VQA rows in 32-row chunks: "
        f"{statistics.median(rows_per_s):.1f} rows/s median of 5 "
        f"(min {min(rows_per_s):.1f}, max {max(rows_per_s):.1f}); run() at "
        f"bucket 1: p50 {p50['graph']['p50']:.3f} ms through the graph "
        f"(min {p50['graph']['min']:.3f}), {p50['eager']['p50']:.3f} ms "
        f"eagerly (min {p50['eager']['min']:.3f}) on "
        f"{report['device']['nvidia_smi']}")
    report["batched"] = {
        "requests": len(reqs), "chunks": len(plan), "launches": launches,
        "max_abs_err_vs_run": worst, "tol_used": used,
        "tol_used_at": worst_at,
        "input_cache_hits": hits, "rows_per_s_32": rows_per_s,
        "rows_per_s_32_median": statistics.median(rows_per_s),
        "padded_rows_96": eng.padded_rows([1] * 96, chunk_rows=32),
        "run_ms_bucket1": p50,
        "input_cache": eng.input_cache_stats}
    return launches


# ------------------------------------------------------------- phase int8
INT8_VS_BF16 = dict(rtol=0.15, atol=0.15)  # tests/test_engine.py:484


def engine_tensor_bytes(torch, eng) -> int:
    """Bytes of an engine's weights on the card: every parameter and buffer
    of its model (the int8 rows' padding included) and its head slabs."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in (*eng.model.parameters(), *eng.model.buffers(),
                          *(eng.head_slabs or {}).values())}
    return sum(storages.values())


def serving_numbers(torch, eng, req, vqa) -> dict:
    """``run()`` at bucket 1 through the graph and eagerly (p50 of 30 warm
    runs each) and ``run_many`` rows/s over ``vqa`` in 32-row chunks
    (median of 5), as phase 6 measures them."""
    out = {}
    for mode in ("graph", "eager"):
        saved = eng._graphs
        if mode == "eager":
            eng._graphs = {}
        try:
            for _ in range(5):
                eng.run(req)
            times = []
            for _ in range(30):
                t0 = time.perf_counter()
                eng.run(req)
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            eng._graphs = saved
        out[f"run_ms_{mode}"] = {"p50": statistics.median(times),
                                 "min": min(times)}
    eng.run_many(vqa, chunk_rows=32)
    torch.cuda.synchronize()
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.run_many(vqa, chunk_rows=32)
        rates.append(len(vqa) / (time.perf_counter() - t0))
    out["rows_per_s_32"] = {"median": statistics.median(rates),
                            "min": min(rates), "max": max(rates)}
    return out


def check_int8(torch, report: dict, eng, root: str, state: str):
    """The slice's main path at full width: an int8 engine restored from a
    checkpoint of this package, driven through ``predict`` (launch counts
    per forward), held against a CPU-f32 int8 engine on the same quantized
    tree and against phase 4's bf16 engine, its graphs against eager, its
    weights' device memory, run()/run_many against the bf16 engine in
    turns, and a rolling swap of an f32 checkpoint. Returns the int8
    engine's predict launches."""
    import dataclasses

    from vilbert_multitask_tpu_torch import quant
    from vilbert_multitask_tpu_torch.checkpoint import (
        restore_params,
        save_params,
    )
    from vilbert_multitask_tpu_torch.config import TASK_REGISTRY
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine,
        init_state_dict,
    )
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )
    from vilbert_multitask_tpu_torch.ops.int8_linear import int8_linear
    from vilbert_multitask_tpu_torch.serve.app import ServeApp

    cfg = dataclasses.replace(eng.cfg, engine=dataclasses.replace(
        eng.cfg.engine, param_dtype="int8"))
    weights = init_state_dict(cfg.model, seed=0)  # phase 4's weights
    ckpt = os.path.join(state, "int8_ckpt")
    t0 = time.perf_counter()
    save_params(ckpt, weights)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = restore_params(ckpt, dtype="int8", cfg=cfg.model)
    restore_s = time.perf_counter() - t0
    if not quant.tree_is_quantized(restored):
        raise AssertionError("restore_params(dtype='int8') kept f32 leaves")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng8 = InferenceEngine(cfg, params=restored,
                           feature_store=eng.feature_store, device="cuda")
    torch.cuda.synchronize()
    int8_alloc = torch.cuda.memory_allocated() - before
    before = torch.cuda.memory_allocated()
    bf16_again = InferenceEngine(eng.cfg, params=weights,
                                 feature_store=eng.feature_store,
                                 device="cuda")
    torch.cuda.synchronize()
    bf16_alloc = torch.cuda.memory_allocated() - before
    memory = {"int8_alloc_bytes": int8_alloc, "bf16_alloc_bytes": bf16_alloc,
              "int8_tensor_bytes": engine_tensor_bytes(torch, eng8),
              "bf16_tensor_bytes": engine_tensor_bytes(torch, bf16_again)}
    del bf16_again
    log(f"int8: checkpoint saved in {save_s:.1f}s, restored and quantized "
        f"on the host in {restore_s:.1f}s; weights on the card: int8 "
        f"{int8_alloc / 2**20:.1f} MiB allocated ({memory['int8_tensor_bytes'] / 2**20:.1f} "
        f"MiB of tensors) against bf16 {bf16_alloc / 2**20:.1f} MiB "
        f"({memory['bf16_tensor_bytes'] / 2**20:.1f} MiB)")

    # The main path of this slice: predict() on the int8 engine, the
    # counts zeroed just before each request and read just after.
    launches = {"int8_linear": 0, "flash_attn": 0}
    for task_id, question, keys in REQUESTS:
        spec = TASK_REGISTRY[task_id]
        bucket = cfg.engine.bucket_for(len(keys)) if len(keys) > 1 else 1
        want = int8_launches_per_forward(cfg.model, bucket)
        int8_linear.launches = flash_cross_attention.launches = 0
        result = eng8.predict(task_id, question, keys)
        torch.cuda.synchronize()
        n8, nf = int8_linear.launches, flash_cross_attention.launches
        launches["int8_linear"] += n8
        launches["flash_attn"] += nf
        check_result(spec, result, len(keys))
        log(f"int8 predict task {task_id} ({spec.name}, bucket {bucket}): "
            f"{n8} int8_linear + {nf} flash_attn launches -> "
            f"{json.dumps(result.to_json())[:120]}")
        if n8 != want or nf != LAUNCHES_PER_FORWARD:
            raise AssertionError(
                f"int8 task {task_id}: {n8} int8_linear launches (want "
                f"{want}), {nf} flash_attn (want {LAUNCHES_PER_FORWARD})")

    # Bundles: against a CPU-f32 int8 engine on the same quantized tree,
    # and against phase 4's bf16 engine.
    f32 = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, compute_dtype="float32"))
    cpu8 = InferenceEngine(f32, params=restored,
                           feature_store=eng.feature_store, device="cpu")
    worst = {"int8_card_vs_int8_f32_cpu": (0.0, 0.0),
             "int8_card_vs_bf16_card": (0.0, 0.0)}
    for task_id, question, keys in REQUESTS:
        got = eng8.bundle(eng8.prepare_from_store(task_id, question,
                                                  keys))[1]
        for key, ref_eng, tol in (
                ("int8_card_vs_int8_f32_cpu", cpu8, BUNDLE_BF16),
                ("int8_card_vs_bf16_card", eng, INT8_VS_BF16)):
            ref = ref_eng.bundle(ref_eng.prepare_from_store(
                task_id, question, keys))[1]
            err, used = compare_bundles(ref, got, tol,
                                        f"int8 task {task_id} {key}")
            worst[key] = (max(worst[key][0], err), max(worst[key][1], used))
    del cpu8
    log("int8 bundles: " + "; ".join(
        f"{k} max abs err {e:.3e} ({u:.2f} of tol)"
        for k, (e, u) in worst.items()))

    # Graphs: capture every bucket, replay against eager.
    t0 = time.perf_counter()
    eng8.warmup()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay = {}
    for b in cfg.engine.all_row_buckets():
        reqs = [eng8.prepare_from_store(t, q, imgs)
                for t, q, imgs in graph_rows(b)]
        graph_bundle = eng8._dispatch_many(reqs).fetch()
        saved, eng8._graphs = eng8._graphs, {}
        try:
            eager_bundle = eng8._dispatch_many(reqs).fetch()
        finally:
            eng8._graphs = saved
        diff, _ = compare_bundles(eager_bundle, graph_bundle, BUNDLE_BF16,
                                  f"int8 bucket {b} graph vs eager")
        per_replay = {w.__name__: n
                      for w, n in eng8._graphs[b].launches.items()}
        replay[b] = {"max_abs_diff": diff, "launches_per_replay": per_replay}
        if per_replay.get("int8_linear") != int8_launches_per_forward(
                cfg.model, b):
            raise AssertionError(f"int8 bucket {b} graph records "
                                 f"{per_replay} launches")
    log(f"int8 graphs: {len(replay)} buckets captured in {capture_s:.2f}s; "
        "replay vs eager max abs diff " + ", ".join(
            f"b{b} {r['max_abs_diff']:.3e}" for b, r in replay.items())
        + f"; launches per bucket-1 replay {replay[1]['launches_per_replay']}")

    # run() and run_many, int8 and bf16 in turns (host-bound walls move
    # between calls): bf16, int8, int8, bf16.
    req = {e: e.prepare_from_store(1, REQUESTS[0][1], REQUESTS[0][2])
           for e in (eng, eng8)}
    vqa = {e: [e.prepare_from_store(1, f"what colour is it {k}",
                                    [f"img_{k % 8}"]) for k in range(96)]
           for e in (eng, eng8)}
    turns = []
    for name, e in (("bf16", eng), ("int8", eng8), ("int8", eng8),
                    ("bf16", eng)):
        nums = serving_numbers(torch, e, req[e], vqa[e])
        turns.append({"engine": name, **nums})
        log(f"int8 vs bf16, turn {len(turns)} ({name}): run() p50 "
            f"{nums['run_ms_graph']['p50']:.3f} ms through the graph, "
            f"{nums['run_ms_eager']['p50']:.3f} ms eagerly; run_many "
            f"{nums['rows_per_s_32']['median']:.1f} rows/s at 32-row chunks"
            f" on {report['device']['nvidia_smi']}")

    # The serving roofline of the two engines, graphs captured on both.
    check_roofline(torch, report, {"bf16": eng, "int8": eng8})

    # Top-1 answers int8 changes against bf16 on the seeded set.
    res16 = eng.run_many(vqa[eng])
    res8 = eng8.run_many(vqa[eng8])
    changed = sum(a.answers[0]["answer"] != b.answers[0]["answer"]
                  for a, b in zip(res16, res8))
    log(f"int8: {changed} of {len(res8)} seeded VQA top-1 answers differ "
        f"from the bf16 engine's (random weights: a count, not a claim)")

    # A rolling swap of an f32 checkpoint re-quantizes it: the same
    # tensors, the same answers.
    served = {k: quant.leaf_to(v, "cpu") for k, v in
              eng8.state_dict().items()}
    answers = [eng8.predict(t, q, k).to_json() for t, q, k in REQUESTS]
    swap_cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, queue_db_path=os.path.join(state, "int8_q.sqlite3"),
        results_db_path=os.path.join(state, "int8_r.sqlite3"),
        media_root=os.path.join(state, "int8_media"), http_port=0,
        ws_port=0))
    app = ServeApp(swap_cfg, engine=eng8, device="cuda")
    try:
        swap = app.rolling_swap(checkpoint_path=ckpt)
    finally:
        app.stop()
    after = eng8.state_dict()
    for key, v in served.items():
        now = quant.leaf_to(after[key], "cpu")
        same = (all(torch.equal(now[p], v[p]) for p in v)
                if quant.is_quantized_leaf(v) else torch.equal(now, v))
        if not same:
            raise AssertionError(f"rolling swap changed {key}")
    if [eng8.predict(t, q, k).to_json() for t, q, k in REQUESTS] != answers:
        raise AssertionError("int8 answers changed across the swap")
    log(f"int8: rolling_swap of the f32 checkpoint re-quantized it in "
        f"{swap['total_s']:.2f}s; the same int8 tensors and answers")
    report["int8"] = {
        "launches": launches, "save_s": save_s, "restore_s": restore_s,
        "memory": memory,
        "bundle_max_abs_err": {k: v[0] for k, v in worst.items()},
        "bundle_tol_used": {k: v[1] for k, v in worst.items()},
        "graphs": {"capture_s": capture_s, "buckets": replay},
        "turns": turns, "top1_changed_vs_bf16": changed,
        "top1_compared": len(res8), "swap_s": swap["total_s"]}
    del eng8
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- roofline
ROOFLINE_REPLAYS = 20  # graph replays per timed window


def roofline_numbers(torch, eng, kind: str) -> dict:
    """One engine's serving roofline on this card: per row bucket 1 and 32,
    the analytic FLOPs of a forward (engine/flops.py), the device time of
    one forward (the bucket's graph replayed ROOFLINE_REPLAYS times on the
    engine stream between CUDA events: no host work between them), the
    stream's wall around a bucket-1 ``run()`` and a 32-row ``run_many``
    chunk (host packing included), the achieved TFLOP/s over the device
    time and its share of the card's peak (``mfu``), beside
    ``serving_roofline``'s cap and reason and ``knee_rows`` for this card's
    name and the engine's weight bytes."""
    from vilbert_multitask_tpu_torch.engine import flops

    mcfg, ecfg = eng.cfg.model, eng.cfg.engine
    weight_bytes = engine_tensor_bytes(torch, eng)
    peak = flops.peak_flops_for(kind)
    req = eng.prepare_from_store(1, REQUESTS[0][1], REQUESTS[0][2])
    chunk = [eng.prepare_from_store(1, f"what is in image {k}",
                                    [f"img_{k % 8}"]) for k in range(32)]
    if [len(c) for c in eng.chunk_plan([1] * 32)] != [32]:
        raise AssertionError("the 32 requests do not pack into one chunk")

    def stream_ms(fn, reps: int) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(eng._stream)
            fn()
            stop.record(eng._stream)
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    out = {"weight_bytes": weight_bytes,
           "knee_rows": flops.knee_rows(mcfg, ecfg, kind, weight_bytes)}
    for rows, call in ((1, lambda: eng.run(req)),
                       (32, lambda: eng.run_many(chunk))):
        graph = eng._graphs[rows]

        def replays(g=graph):
            with torch.cuda.stream(eng._stream):
                for _ in range(ROOFLINE_REPLAYS):
                    g.graph.replay()  # not .replay(): no launches counted

        device = stream_ms(replays, 5) / ROOFLINE_REPLAYS
        n = flops.serving_forward_flops(mcfg, ecfg, rows)
        cap = flops.serving_roofline(mcfg, ecfg, rows, kind, weight_bytes)
        achieved = n / (device * 1e-3)
        out[rows] = {"flops": n, "device_ms": device,
                     "stream_ms": stream_ms(call, 10),
                     "tflops": achieved / 1e12,
                     "mfu": None if peak is None else achieved / peak,
                     "achievable_mfu": cap["achievable_mfu"],
                     "reason": cap["reason"]}
    return out


def check_roofline(torch, report: dict, engines: dict) -> None:
    """The roofline lines for each engine (``roofline_numbers``), bf16 and
    int8, on this card."""
    kind = report["device"]["kind"]
    rep = report.setdefault("roofline", {})
    for name, eng in engines.items():
        rep[name] = r = roofline_numbers(torch, eng, kind)
        for rows in (1, 32):
            x = r[rows]
            log(f"roofline {name} bucket {rows}: {x['flops'] / 1e9:.2f} "
                f"GFLOP a forward, device {x['device_ms']:.3f} ms (the "
                f"graph's replay), {x['stream_ms']:.3f} ms of stream wall "
                f"around {'run()' if rows == 1 else 'a run_many chunk'}; "
                f"{x['tflops']:.1f} TFLOP/s, mfu {x['mfu']:.4f} of the "
                f"card's peak; serving_roofline achievable_mfu "
                f"{x['achievable_mfu']} ({x['reason']}) on "
                f"{report['device']['nvidia_smi']}")
        log(f"roofline {name}: knee_rows {r['knee_rows']} at "
            f"{r['weight_bytes'] / 2**20:.1f} MiB of weights on the card")


# ------------------------------------------------------------------ boot
BOOT_VARIANTS = (("bf16", ()), ("int8", ("--dtype", "int8")),
                 ("live_extract", ("--live-extract",)))


def run_prewarm(cache_dir: str, variants) -> dict:
    """``python -m vilbert_multitask_tpu_torch.engine.prewarm`` for each
    (name, args) of ``variants``, one process each, all started together;
    each one's JSON report and wall seconds."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "vilbert_multitask_tpu_torch.engine.prewarm",
         "--cache-dir", cache_dir, *args], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in variants}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"prewarm {name} exit {proc.returncode}: "
                                 f"{stdout[-2000:]} {stderr[-3000:]}")
        out[name] = {"wall_s": time.perf_counter() - t0,
                     **json.loads(stdout)}
    return out


def check_boot(torch, report: dict, root: str, state: str) -> None:
    """The kernel-library cache: the prewarm CLI for the bf16, int8 and
    live-extract variants into an empty directory (each library's cold nvcc
    seconds), then the same again (no miss); two ``ServeApp`` boots sharing
    one fresh directory, the first cold, the second warm (it must build
    nothing), each with its boot phases and wall."""
    import shutil

    from vilbert_multitask_tpu_torch import _build
    from vilbert_multitask_tpu_torch.config import FrameworkConfig
    from vilbert_multitask_tpu_torch.serve.app import ServeApp

    rep = report["boot"] = {"prewarm": {}, "serveapp": []}
    cache = os.path.join(_build.BUILD_DIR, f"prewarm-{os.getpid()}")
    # Cold: one variant after another (each builds what the earlier ones
    # left missing); warm: the three at once, every library a hit.
    runs = [run_prewarm(cache, [v]) for v in BOOT_VARIANTS]
    runs.append(run_prewarm(cache, BOOT_VARIANTS))
    for rnd, outs in (("cold", {k: v for r in runs[:3] for k, v in
                                r.items()}), ("warm", runs[3])):
        for name, out in outs.items():
            libs = out["libraries"]
            rep["prewarm"][f"{name}_{rnd}"] = out
            if rnd == "warm" and out["misses"]:
                raise AssertionError(f"second prewarm of {name} missed: "
                                     f"{libs}")
            if not all(r["ok"] for r in libs.values()):
                raise AssertionError(f"prewarm {name}: {libs}")
            log(f"boot: prewarm {name} ({rnd}) in {out['wall_s']:.1f}s: "
                + ", ".join(f"{n} {r['status']} nvcc {r['seconds']:.2f}s "
                            f"(err {r['max_err']:.1e})"
                            for n, r in libs.items())
                + f"; {out['misses']} misses")
    shutil.rmtree(cache)
    cfg = FrameworkConfig()
    boot_dir = os.path.join(_build.BUILD_DIR, f"boot-{os.getpid()}")
    cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, aot_cache_dir=boot_dir),
        serving=dataclasses.replace(
            cfg.serving, queue_db_path=os.path.join(state, "boot_q.sqlite3"),
            results_db_path=os.path.join(state, "boot_r.sqlite3"),
            media_root=os.path.join(state, "boot_media"), http_port=0,
            ws_port=0))
    for rnd in ("cold", "warm"):
        t0 = time.perf_counter()
        app = ServeApp(cfg, feature_root=root, device="cuda")
        try:
            app.warm()
            wall = time.perf_counter() - t0
            info = {"wall_s": wall, "aot_cache": app.boot_info["aot_cache"],
                    "boot_phases": app.boot_info["boot_phases"]}
        finally:
            app.stop()
            del app
            torch.cuda.empty_cache()
        rep["serveapp"].append(info)
        misses = info["aot_cache"]["misses"]
        log(f"boot: ServeApp ({rnd}, {boot_dir}) booted and warmed in "
            f"{wall:.1f}s; libraries {info['aot_cache']['libraries']}; "
            f"boot_phases {info['boot_phases']}")
        if rnd == "warm" and (misses or info["boot_phases"]["nvcc_s"]):
            raise AssertionError(f"the warm boot built libraries: {info}")
        if rnd == "cold" and not misses:
            raise AssertionError(f"the cold boot found a built cache: {info}")
    shutil.rmtree(boot_dir)


# -------------------------------------------------------------- phase cli
def check_cli_entry_points(torch, report: dict, eng, root: str,
                           state: str) -> None:
    """The eval harness and the onboarding CLI, each in a process of its
    own on the card: the harness on seeded VQA data over phase 4's feature
    files prints the scores the in-process Evaluator gives on phase 4's
    bf16 engine (the same seed-0 weights); onboarding converts a seeded
    upstream-layout .bin, boots, smokes and holds that score."""
    from vilbert_multitask_tpu_torch import assets
    from vilbert_multitask_tpu_torch.engine.runtime import init_state_dict
    from vilbert_multitask_tpu_torch.evals import Evaluator

    # Seeded VQA data: every other example's answers are the engine's own
    # top-1 (full credit), the rest a string it never answers.
    examples = []
    for k in range(16):
        image = f"img_{k % 8}"
        question = f"what is shown in picture {k}"
        pred = eng.predict(1, question, [image]).answers[0]["answer"]
        examples.append({"question": question, "image": image,
                         "answers": [pred if k % 2 == 0 else "nothing"] * 10})
    data = os.path.join(state, "vqa_seeded.jsonl")
    with open(data, "w") as f:
        f.writelines(json.dumps(e) + "\n" for e in examples)
    want = Evaluator(eng, batch=8).run("vqa", examples)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))

    def run(args, what):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=state,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{what} exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1]), wall

    got, eval_s = run(["vilbert_multitask_tpu_torch.evals.harness",
                       "--task", "vqa", "--data", data, "--features", root],
                      "evals.harness")
    if {k: v for k, v in got.items() if k != "wall_s"} != {
            k: v for k, v in want.items() if k != "wall_s"}:
        raise AssertionError(f"evals.harness printed {got}, the in-process "
                             f"Evaluator gave {want}")
    log(f"cli: python -m vilbert_multitask_tpu_torch.evals.harness --task "
        f"vqa: {got} in {eval_s:.1f}s, equal to the in-process Evaluator")

    bin_path = os.path.join(state, "pytorch_model_9.bin")
    torch.save({f"module.{k}": v for k, v in
                init_state_dict(eng.cfg.model, seed=0).items()}, bin_path)
    expect = os.path.join(state, "expected.json")
    with open(expect, "w") as f:
        json.dump({"vqa": {"accuracy": want["accuracy"]}}, f)
    onboard, onboard_s = run(
        ["vilbert_multitask_tpu_torch.checkpoint.onboard", "--torch-bin",
         bin_path, "--vocab", assets.default_vocab_path(), "--labels",
         assets.default_labels_root(), "--out",
         os.path.join(state, "onboarded"), "--eval", f"vqa={data}",
         "--features", root, "--expect", expect], "checkpoint.onboard")
    if not onboard["ok"]:
        raise AssertionError(f"checkpoint.onboard: {onboard}")
    log(f"cli: python -m vilbert_multitask_tpu_torch.checkpoint.onboard: ok "
        f"in {onboard_s:.1f}s (steps "
        f"{ {k: v.get('wall_s') for k, v in onboard['steps'].items()} }, "
        f"parity {onboard['steps']['parity']['scores']['vqa']['accuracy']})")
    report["cli"] = {"evals_harness": got, "evals_harness_s": eval_s,
                     "onboard_steps": onboard["steps"],
                     "onboard_s": onboard_s}


# -------------------------------------------------------------- phase train
# Card against CPU, 3 f32 steps of a full-width, reduced-depth model: the
# two sides differ in summation order only (TF32 off). Gradients and
# moments agree to f32 rounding carried through the backward (~2e-6 of
# each leaf's norm); Adam normalises each element's gradient, so an element
# whose gradient is near its rounding (and the parameters a softmax is
# invariant to: the attention key biases, vil_logit.bias under the
# contrastive loss) moves by up to the rate per step on one side and not
# the other. The schedule's first rate is 0, so steps 1 and 2 start from
# equal parameters: their grad norms (accumulated in f64, rounded to f32;
# 7.8e-8 apart in f64 at the first step on an H100) are held within
# TRAIN_PARITY_RTOL, step 3's, from parameters one update apart, within
# TRAIN_PARITY_RTOL_UPDATED. Each head's loss is a short sum of terms that
# carry the forward's f32 rounding (~1e-6 relative): held within
# TRAIN_PARITY_LOSS_RTOL at every step. Every parameter within 0.1 x the
# rate per step (those invariant ones within the rate per step), and at
# most 0.1% of the elements beyond 1e-6. The first step's gradients of the
# two sides are compared leaf by leaf in f64, and a control run on the card
# with TF32 on reads how far a lower-precision product moves the grad norm
# and the losses.
TRAIN_PARITY_LR = 1e-4
TRAIN_PARITY_STEPS = 3
TRAIN_PARITY_RTOL = 1e-6
TRAIN_PARITY_RTOL_UPDATED = 1e-4
TRAIN_PARITY_LOSS_RTOL = 1e-5
TRAIN_HEADS = ("vqa", "tri", "grounding", "binary", "retrieval", "pretrain")
TRAIN_BATCH = 8
TRAIN_STEPS = 30
TRAIN_FIXED_REPEATS = 10
TRAIN_CONTINUE_STEPS = 3
# Losses of the steps after a restore against the uninterrupted run: the
# states are bit-equal, the batches and dropout masks the same, and only
# the card's nondeterministic reductions (atomics) differ.
TRAIN_RESUME_RTOL = 1e-3
# EvalHook's engine after ``load_params`` against a fresh engine on the same
# parameters: the same graphs on the same inputs (equal so far); the
# steps must move its bundle by more than 10x this.
EVAL_RELOAD_ATOL = 1e-3


def _zero_gradient(name: str) -> bool:
    return name.endswith(("key.bias", "key1.bias", "key2.bias",
                          "vil_logit.bias"))


def _all_heads_batch(cfg, batch: int) -> dict:
    """One synthetic batch carrying every head's targets (the pretraining
    batch's masked inputs and the other heads' labels)."""
    from vilbert_multitask_tpu_torch.train.data import SyntheticTaskData

    out = SyntheticTaskData("pretrain", cfg, seed=11).batch(batch)
    for head in ("vqa", "gqa", "tri", "binary", "grounding"):
        b = SyntheticTaskData(head, cfg, seed=11).batch(batch)
        out.update({k: v for k, v in b.items() if k not in out})
    return out


class _FirstGrads:
    """An optimizer that keeps a host copy of the first step's raw
    gradients and then applies the wrapped update."""

    def __init__(self, tx):
        self.tx = tx
        self.grads: dict = {}

    def update(self, state, grads):
        if not self.grads:
            self.grads = {k: g.detach().to("cpu", copy=True)
                          for k, g in grads.items()}
        return self.tx.update(state, grads)


def _leaf_gap(torch, card: dict, cpu: dict, top: int = 6) -> dict:
    """Where two sides' first-step gradients differ, in f64 on the host:
    the global norms, each leaf's share of ``|g_card|^2 - |g_cpu|^2``, and
    for the leading leaves their norms, ``|g_card - g_cpu| / |g_cpu|``, the
    scale that best maps the CPU's gradient onto the card's (``<g_card,
    g_cpu> / |g_cpu|^2``) and what that scale leaves over."""
    rows = {}
    for k, b in cpu.items():
        a, b = card[k].double(), b.double()
        nb = float(torch.linalg.vector_norm(b))
        na = float(torch.linalg.vector_norm(a))
        dot = float((a * b).sum())
        scale = dot / nb ** 2 if nb else 0.0
        rows[k] = {"leaf": k, "norm_cpu": nb, "norm_card": na,
                   "delta_sq": na ** 2 - nb ** 2,
                   "diff_rel": (float(torch.linalg.vector_norm(a - b)) / nb
                                if nb else 0.0),
                   "scale_minus_1": scale - 1.0,
                   "residual_rel": (float(torch.linalg.vector_norm(
                       a - scale * b)) / nb if nb else 0.0)}
    total = sum(r["delta_sq"] for r in rows.values())
    for r in rows.values():
        r["share"] = r["delta_sq"] / total if total else 0.0
    big = [r for r in rows.values() if r["norm_cpu"] > 1e-3]
    return {
        "norm_card_f64": sum(r["norm_card"] ** 2
                             for r in rows.values()) ** 0.5,
        "norm_cpu_f64": sum(r["norm_cpu"] ** 2 for r in rows.values()) ** 0.5,
        "delta_sq_norm": total,
        "by_share": sorted(rows.values(),
                           key=lambda r: -abs(r["delta_sq"]))[:top],
        "by_diff": sorted(big, key=lambda r: -r["diff_rel"])[:top]}


def check_train_parity(torch, report: dict) -> None:
    """3 steps of the full-width model at depth 2 text / 1 visual / 1
    bridge, f32, dropout off, TF32 off, on the card and on the CPU in this
    process from the same weights and batch: parameters and grad norm held
    as TRAIN_PARITY_* says. Each leaf's gradient norm at the first step is
    recorded on both sides, and a control run on the card with TF32 on."""
    import dataclasses

    from vilbert_multitask_tpu_torch.config import (
        FrameworkConfig,
        ViLBertConfig,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import init_state_dict
    from vilbert_multitask_tpu_torch.models.vilbert import ViLBertForVLTasks
    from vilbert_multitask_tpu_torch.train import losses, step

    mcfg = ViLBertConfig(num_hidden_layers=2, v_num_hidden_layers=1,
                         t_biattention_id=(1,), v_biattention_id=(0,))
    cfg = dataclasses.replace(FrameworkConfig(), model=mcfg)
    weights = init_state_dict(mcfg, seed=3)
    batch = _all_heads_batch(cfg, 4)
    heads = ("vqa", "gqa", "binary", "tri", "grounding", "retrieval", "mlm",
             "mrm")
    runs = {}
    for side, dev, tf32 in (("cuda", "cuda", False), ("cpu", "cpu", False),
                            ("cuda_tf32", "cuda", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        model = ViLBertForVLTasks(mcfg)
        model.load_state_dict(weights, strict=True)
        model.to(dev).eval()
        tx = step.default_optimizer(learning_rate=TRAIN_PARITY_LR,
                                    warmup_steps=1, total_steps=50)
        state = step.create_train_state(model, tx)
        first = _FirstGrads(tx)
        fn = step.make_train_step(model, first,
                                  losses.LossConfig(heads=heads))
        t0 = time.perf_counter()
        metrics = []
        for _ in range(TRAIN_PARITY_STEPS):
            state, m = fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[side] = (state, metrics, time.perf_counter() - t0,
                      first.grads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (gs, gm, g_s, g_leaf), (cs, cm, c_s, c_leaf) = runs["cuda"], runs["cpu"]
    tm = runs.pop("cuda_tf32")[1]

    def gaps(ms):  # per step, each metric's relative gap to the CPU's
        return [{k: abs(a[k] - b[k]) / max(abs(a[k]), abs(b[k]), 1e-30)
                 for k in b} for a, b in zip(ms, cm)]

    gap, gap_tf32 = gaps(gm), gaps(tm)
    log(f"train parity: relative gaps card / TF32 card against CPU, per "
        f"step: " + "; ".join(
            ", ".join(f"{k} {g[k]:.3g}/{t[k]:.3g}" for k in sorted(g))
            for g, t in zip(gap, gap_tf32)))
    for i, g in enumerate(gap):
        for k, v in g.items():
            rtol = (TRAIN_PARITY_LOSS_RTOL if k != "grad_norm"
                    else TRAIN_PARITY_RTOL if i < 2
                    else TRAIN_PARITY_RTOL_UPDATED)
            if v > rtol:
                raise AssertionError(
                    f"train parity step {i + 1} {k}: card {gm[i][k]} CPU "
                    f"{cm[i][k]} ({v:.3g} > rtol {rtol})")
    far = total = 0
    worst = 0.0
    lr_steps = TRAIN_PARITY_LR * TRAIN_PARITY_STEPS
    for k, p in cs.params.items():
        d = (gs.params[k].detach().cpu() - p.detach()).abs()
        limit = lr_steps if _zero_gradient(k) else 0.1 * lr_steps
        if float(d.max()) > limit:
            raise AssertionError(f"train parity {k}: max |card - CPU| "
                                 f"{float(d.max())} > {limit}")
        if not _zero_gradient(k):
            far += int((d > 1e-6).sum())
            total += d.numel()
            worst = max(worst, float(d.max()))
    if far > 1e-3 * total:
        raise AssertionError(f"train parity: {far} of {total} parameter "
                             f"elements beyond 1e-6")
    n_params = sum(p.numel() for p in cs.params.values())

    leaf_gap = _leaf_gap(torch, g_leaf, c_leaf)
    log(f"train parity: {n_params} parameters (depth 2/1/1, full widths), "
        f"{TRAIN_PARITY_STEPS} f32 steps card {g_s:.2f}s CPU {c_s:.2f}s; "
        f"grad norms card {[m['grad_norm'] for m in gm]} CPU "
        f"{[m['grad_norm'] for m in cm]}; max |d param| {worst:.3g}, "
        f"{far} of {total} elements beyond 1e-6")
    log(f"train parity: first step in f64, grad norms card "
        f"{leaf_gap['norm_card_f64']:.10g} CPU {leaf_gap['norm_cpu_f64']:.10g};"
        f" leaves by share of |g_card|^2 - |g_cpu|^2: "
        + ", ".join(f"{e['leaf']} {e['share']:.3f} (|d|/|g| "
                    f"{e['diff_rel']:.3g}, scale-1 {e['scale_minus_1']:.3g}, "
                    f"residual {e['residual_rel']:.3g})"
                    for e in leaf_gap["by_share"][:4]))
    report["train_parity"] = {
        "params": n_params, "grad_norm_card": [m["grad_norm"] for m in gm],
        "grad_norm_cpu": [m["grad_norm"] for m in cm],
        "grad_norm_card_tf32": [m["grad_norm"] for m in tm],
        "rel_gap": gap, "rel_gap_tf32": gap_tf32,
        "loss_card": [m["loss/total"] for m in gm],
        "loss_cpu": [m["loss/total"] for m in cm],
        "loss_card_tf32": [m["loss/total"] for m in tm],
        "first_step_leaves": leaf_gap,
        "max_abs_param_diff": worst, "elements_beyond_1e-6": far,
        "elements": total}


def _eval_bundle(eng, examples: list) -> list:
    """The float leaves of ``eng``'s decode bundle for the VQA
    ``examples`` packed as the eval harness packs them (one chunk)."""
    import numpy as np

    reqs = [eng.prepare_from_store(1, e["question"], [e["image"]])
            for e in examples]
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif np.issubdtype(np.asarray(node).dtype, np.floating):
            leaves.append(np.asarray(node))

    walk(eng._dispatch_many(reqs).fetch())
    return leaves


def _timed_steps(torch, trainer, times: list) -> None:
    """Time each of ``trainer``'s steps on the synchronized wall clock."""
    make = trainer._step_for

    def step_for(head):
        fn = make(head)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        return run

    trainer._step_for = step_for


def _train_states_equal(torch, a, b) -> bool:
    return (a.step == b.step
            and all(torch.equal(getattr(a, w)[k], getattr(b, w)[k])
                    for w in ("params", "mu", "nu")
                    for k in getattr(a, w))
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


def check_train(torch, report: dict, root: str, state: str) -> dict:
    """The training path at full width (``ViLBertConfig()``, bf16 autocast
    over f32 parameters, seeded weights, batch 8) through ``Trainer`` and
    ``MultiTaskSampler`` over synthetic vqa, tri, grounding, binary,
    retrieval and pretrain data: no ``flash_attn`` launch, finite losses,
    each head's loss falling on a fixed batch, the step time, a snapshot
    restored bit-equal into a fresh Trainer and going on like the
    uninterrupted run, ``EvalHook`` on the served engine (built on the
    initial weights; after the steps, 18 launches a forward, scores and
    bundle like a fresh engine's on the trained parameters), and the CLI in
    its own process."""
    import dataclasses
    import shutil

    import numpy as np

    from vilbert_multitask_tpu_torch.checkpoint.store import (
        restore_train_state,
    )
    from vilbert_multitask_tpu_torch.config import FrameworkConfig
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine,
        init_state_dict,
    )
    from vilbert_multitask_tpu_torch.evals import Evaluator
    from vilbert_multitask_tpu_torch.features.store import FeatureStore
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )
    from vilbert_multitask_tpu_torch.train.loop import (
        EvalHook,
        LoopConfig,
        MultiTaskSampler,
        SyntheticTaskData,
        Trainer,
        latest_checkpoint,
    )
    from vilbert_multitask_tpu_torch.train.step import TrainState

    out: dict = {}
    # The kernel has no backward: on the card it refuses a gradient.
    q = torch.zeros(1, 38, 8, 128, device="cuda", requires_grad=True)
    kv = torch.zeros(1, 101, 8, 128, device="cuda")
    bias = torch.zeros(1, 1, 1, 101, device="cuda")
    try:
        flash_cross_attention(q, kv, kv, bias)
    except RuntimeError as e:
        out["flash_refuses_gradient"] = str(e)
    else:
        raise AssertionError("flash_cross_attention launched with q "
                             "requiring grad")

    cfg = FrameworkConfig()
    t0 = time.perf_counter()
    weights = init_state_dict(cfg.model, seed=0)
    init_s = time.perf_counter() - t0
    # EvalHook's engine is built (bf16 graphs) on the initial weights; after
    # the steps the hook copies the trained parameters into it.
    store = FeatureStore(root)
    tasks = {"vqa": [{"question": f"what is in picture {k}",
                      "image": f"img_{k}", "answers": ["yes"] * 10}
                     for k in range(8)]}
    hook = EvalHook(cfg, store, tasks, device="cuda")
    t0 = time.perf_counter()
    hook(0, TrainState(step=0, params={
        k: torch.as_tensor(v) for k, v in weights.items()}, mu={}, nu={}))
    hook_build_s = time.perf_counter() - t0
    before = _eval_bundle(hook._engine, tasks["vqa"])
    ckpt_dir = os.path.join(state, "train_ckpts")
    sampler = MultiTaskSampler(
        {h: SyntheticTaskData(h, cfg) for h in TRAIN_HEADS})
    logs: list = []
    # The schedule spans the steps after the restore too (the optimizer is
    # made from the loop config); the first run stops at TRAIN_STEPS.
    loop = LoopConfig(total_steps=TRAIN_STEPS + TRAIN_CONTINUE_STEPS,
                      batch_size=TRAIN_BATCH, learning_rate=1e-4,
                      warmup_steps=3, log_every=1,
                      ckpt_every=TRAIN_STEPS // 2, keep_ckpts=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, sampler, loop, out_dir=ckpt_dir,
                      init_params=weights, device="cuda",
                      log_fn=lambda s: logs.append(json.loads(s)))
    trainer.loop = dataclasses.replace(loop, total_steps=TRAIN_STEPS)
    times: list = []
    _timed_steps(torch, trainer, times)
    saves: list = []
    save = trainer._save

    def timed_save(step):
        t = time.perf_counter()
        save(step)
        saves.append(time.perf_counter() - t)

    trainer._save = timed_save
    flash_cross_attention.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    flash_train = flash_cross_attention.launches
    if flash_train != 0:
        raise AssertionError(f"training launched flash_attn {flash_train} "
                             f"times")
    peak = torch.cuda.max_memory_allocated() - base
    if len(logs) != TRAIN_STEPS or not all(
            math.isfinite(v) for m in logs for k, v in m.items()
            if k.startswith("loss/") or k == "grad_norm"):
        raise AssertionError(f"train: non-finite or missing logs {logs}")
    warm = times[len(TRAIN_HEADS):]  # past each head's first step
    p50 = statistics.median(warm)
    out.update(steps=TRAIN_STEPS, batch=TRAIN_BATCH, init_s=init_s,
               step_ms_p50=1e3 * p50, step_ms=[1e3 * t for t in times],
               rows_per_s=TRAIN_BATCH / p50, peak_bytes=peak,
               heads_seen=sorted({m["head"] for m in logs}),
               flash_launches_train=flash_train, save_s=saves)
    log(f"train: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} (heads "
        f"{out['heads_seen']}), step p50 {1e3 * p50:.2f} ms "
        f"({TRAIN_BATCH / p50:.1f} rows/s), first steps "
        f"{[round(1e3 * t, 1) for t in times[:3]]} ms, peak "
        f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB already "
        f"held, flash_attn launches {flash_train}, snapshots "
        f"{[round(s, 2) for s in saves]} s")

    # A snapshot restored into a fresh Trainer is the saved state, bit for
    # bit, and goes on as the uninterrupted run does.
    path, at = latest_checkpoint(ckpt_dir)
    snaps = sorted(os.listdir(ckpt_dir))
    if at != TRAIN_STEPS or len(snaps) != 2:
        raise AssertionError(f"train: snapshots {snaps}")
    t0 = time.perf_counter()
    fresh = Trainer(cfg, sampler, loop, out_dir=ckpt_dir,
                    init_params=weights, device="cuda",
                    log_fn=lambda s: None)
    resume_s = time.perf_counter() - t0
    if not _train_states_equal(torch, fresh.state, trainer.state):
        raise AssertionError("train: the restored state differs from the "
                             "saved one")
    t0 = time.perf_counter()
    restore_train_state(path, fresh.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    both = []
    for t in (trainer, fresh):
        t.out_dir = None  # no more snapshots
        t.loop = loop
        got = []
        t.log = lambda s, got=got: got.append(json.loads(s))
        t.train()
        both.append([m["loss/total"] for m in got])
    if not np.allclose(both[1], both[0], rtol=TRAIN_RESUME_RTOL, atol=0):
        raise AssertionError(f"train: resumed losses {both[1]} against the "
                             f"uninterrupted {both[0]}")
    del fresh
    shutil.rmtree(ckpt_dir)
    out.update(restore_s=restore_s, resume_trainer_s=resume_s,
               losses_after_resume=both[1], losses_uninterrupted=both[0])
    log(f"train: snapshot at step {at} ({len(snaps)} kept) restored "
        f"bit-equal in a fresh Trainer (restore {restore_s:.2f}s, Trainer "
        f"with resume {resume_s:.1f}s); the next {TRAIN_CONTINUE_STEPS} "
        f"losses {both[1]} against {both[0]} uninterrupted")

    # EvalHook on the trained parameters: the served engine (bf16 graphs,
    # 18 flash_attn launches a forward), its parameters copied in, answers
    # as a fresh engine on those parameters does, and no longer as on the
    # initial ones.
    flash_cross_attention.launches = 0
    t0 = time.perf_counter()
    scores = hook(trainer.state.step, trainer.state)
    torch.cuda.synchronize()
    hook_s = time.perf_counter() - t0
    flash_eval = flash_cross_attention.launches
    if flash_eval != LAUNCHES_PER_FORWARD:  # 8 rows: one bucket-8 forward
        raise AssertionError(f"EvalHook: {flash_eval} flash_attn launches "
                             f"for one forward")
    after = _eval_bundle(hook._engine, tasks["vqa"])
    eng = InferenceEngine(cfg, params={
        k: v.detach() for k, v in trainer.state.state_dict().items()},
        feature_store=store, device="cuda")
    eng.warmup()
    want = {f"eval/vqa/{k}": round(float(v), 5)
            for k, v in Evaluator(eng).run("vqa", tasks["vqa"]).items()
            if k not in EvalHook._META_KEYS and isinstance(v, (int, float))}
    fresh = _eval_bundle(eng, tasks["vqa"])
    if scores != want:
        raise AssertionError(f"EvalHook scored {scores}, a fresh engine "
                             f"{want}")
    d_fresh = max(float(np.abs(a - b).max()) for a, b in zip(after, fresh))
    d_moved = max(float(np.abs(a - b).max()) for a, b in zip(after, before))
    if d_fresh > EVAL_RELOAD_ATOL:
        raise AssertionError(f"EvalHook's engine after load_params differs "
                             f"from a fresh engine by {d_fresh}")
    if d_moved <= 10 * EVAL_RELOAD_ATOL:
        raise AssertionError(f"EvalHook's engine answers as on the initial "
                             f"weights (moved {d_moved})")
    del eng, hook
    out.update(eval_scores=scores, eval_flash_launches=flash_eval,
               eval_hook_build_s=hook_build_s, eval_hook_s=hook_s,
               eval_bundle_vs_fresh=d_fresh, eval_bundle_moved=d_moved)
    log(f"train: EvalHook {scores} (engine built and captured on the "
        f"initial weights in {hook_build_s:.1f}s; after the steps "
        f"{hook_s:.2f}s, {flash_eval} flash_attn launches for its one "
        f"forward); its bundle {d_fresh:.3g} from a fresh engine's on the "
        f"trained parameters, {d_moved:.3g} from its own before the steps")
    del trainer
    torch.cuda.empty_cache()

    # The CLI, in a process of its own on the card.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    cli_out = os.path.join(state, "train_cli")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vilbert_multitask_tpu_torch.train.loop",
         "--steps", "4", "--batch", "2", "--log-every", "1", "--out",
         cli_out], cwd=state, env=env, capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train.loop exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    final = json.loads(proc.stdout.strip().splitlines()[-1])["final"]
    if final["step"] != 4 or not math.isfinite(final["loss/total"]) or \
            latest_checkpoint(cli_out)[1] != 4:
        raise AssertionError(f"train.loop: {proc.stdout[-2000:]}")
    shutil.rmtree(cli_out)
    out.update(cli_s=cli_s, cli_final=final)
    log(f"train: python -m vilbert_multitask_tpu_torch.train.loop --steps 4 "
        f"--batch 2: exit 0 in {cli_s:.1f}s, final {final}")
    report["train"] = out
    return out


def _dropout_free_loss(torch, trainer, head: str, batch: dict) -> float:
    """``head``'s loss on ``batch`` with dropout off, in the trainer's
    compute dtype, without a gradient."""
    from vilbert_multitask_tpu_torch.train.data import HEAD_LOSS_GROUPS
    from vilbert_multitask_tpu_torch.train.losses import (
        LossConfig,
        multitask_loss,
    )
    from vilbert_multitask_tpu_torch.train.step import (
        MODEL_INPUTS,
        batch_tensors,
    )

    model = trainer.model
    b = batch_tensors(batch, trainer.device)
    model.eval()
    try:
        with torch.no_grad(), torch.autocast(
                trainer.device.type, dtype=trainer.autocast_dtype,
                enabled=trainer.autocast_dtype is not None):
            out = model(*(b[k] for k in MODEL_INPUTS), None, b["task_ids"])
        loss, _ = multitask_loss(LossConfig(
            heads=HEAD_LOSS_GROUPS.get(head, (head,)),
            retrieval_group_size=trainer.loop.retrieval_group_size), out, b)
    finally:
        model.train()
    return float(loss)


def check_fixed_batch_training(torch, report: dict) -> None:
    """Per head, a Trainer of that head alone from the same seeded weights
    (full width, bf16 autocast, dropout on) takes TRAIN_FIXED_REPEATS steps
    on one batch repeated, and its loss on that batch, dropout off, falls
    (the steps' own losses carry each step's dropout draw). Then where a step's
    time goes: three more steps of the vqa head under ``torch.profiler``
    (kernels a step, device busy share, the top kernels and host ops)."""
    from torch.profiler import ProfilerActivity, profile

    from vilbert_multitask_tpu_torch.config import FrameworkConfig
    from vilbert_multitask_tpu_torch.engine.profile_run import _union_us
    from vilbert_multitask_tpu_torch.engine.runtime import init_state_dict
    from vilbert_multitask_tpu_torch.train.loop import (
        LoopConfig,
        MultiTaskSampler,
        SyntheticTaskData,
        Trainer,
    )

    class Fixed(SyntheticTaskData):
        def batch(self, batch_size, *, step=0):
            return super().batch(batch_size, step=0)

    cfg = FrameworkConfig()
    weights = init_state_dict(cfg.model, seed=1)
    falls = {}
    for head in TRAIN_HEADS:
        logs: list = []
        trainer = Trainer(cfg, MultiTaskSampler({head: Fixed(head, cfg)}),
                          LoopConfig(total_steps=TRAIN_FIXED_REPEATS,
                                     batch_size=TRAIN_BATCH,
                                     learning_rate=1e-4, warmup_steps=2,
                                     log_every=1),
                          init_params=weights, device="cuda",
                          log_fn=lambda s, logs=logs: logs.append(
                              json.loads(s)))
        batch = trainer.sampler.next(TRAIN_BATCH, 0)[1]
        before = _dropout_free_loss(torch, trainer, head, batch)
        trainer.train()
        after = _dropout_free_loss(torch, trainer, head, batch)
        if not after < before:
            raise AssertionError(
                f"train: {head}'s loss on its fixed batch did not fall: "
                f"{before} -> {after} (steps, dropout on: "
                f"{[m['loss/total'] for m in logs]})")
        falls[head] = {"before": before, "after": after,
                       "steps": [m["loss/total"] for m in logs]}
        if head == "vqa":
            fn = trainer._step_for(head)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn(trainer.state, batch)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = _union_us([(e.time_range.start, e.time_range.end)
                              for e in kernels]) / 1e6 / 3
            by_name: dict = {}
            for e in kernels:
                c, t = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
            host = sorted((e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CPU),
                          key=lambda e: -e.self_cpu_time_total)[:8]
            step_profile = {
                "kernels_per_step": len(kernels) / 3,
                "device_busy_ms": 1e3 * busy, "wall_ms_profiled": 1e3 * wall,
                "idle_share": max(0.0, 1.0 - busy / wall),
                "top_kernels": [{"name": k[:100], "per_step": c / 3,
                                 "ms_per_step": t / 3e3}
                                for k, (c, t) in sorted(
                                    by_name.items(),
                                    key=lambda kv: -kv[1][1])[:8]],
                "host_top": [{"name": e.key[:100],
                              "calls_per_step": e.count / 3,
                              "self_cpu_ms_per_step":
                                  e.self_cpu_time_total / 3e3}
                             for e in host]}
        del trainer
        torch.cuda.empty_cache()
    report.setdefault("train", {}).update(fixed_batch=falls,
                                          step_profile=step_profile)
    log("train: each head alone on a fixed batch, loss first -> last over "
        f"{TRAIN_FIXED_REPEATS} steps: "
        + ", ".join(f"{h} {v['before']:.4f} -> {v['after']:.4f}"
                    for h, v in falls.items()))
    log(f"train: a profiled vqa step: {step_profile['kernels_per_step']:.0f} "
        f"kernels, device busy {step_profile['device_busy_ms']:.2f} ms of "
        f"{step_profile['wall_ms_profiled']:.2f} ms (idle "
        f"{step_profile['idle_share']:.3f}); top kernels "
        + ", ".join(f"{k['name'][:40]} {k['ms_per_step']:.2f} ms"
                    for k in step_profile["top_kernels"][:4]))


# ---------------------------------------------------------------- phase 7
SERVED_FAMILIES = (  # (task id, question, images): the six decode families
    (1, "what is the man holding", ["img_0"]),
    (15, "is the bowl to the right of the mug", ["img_1"]),
    (11, "the woman in the red coat", ["img_2"]),
    (13, "two dogs are playing in the snow", ["img_3"]),
    (12, "both images contain exactly two wolves", ["img_4", "img_5"]),
    (7, "a man riding a horse on the beach",
     ["img_4", "img_5", "img_6", "img_7"]),
)


def is_terminal(frame: dict) -> bool:
    """scripts/serve_soak.py's rule: a result, an error, a deadline or a
    dead-letter push ends a submit."""
    return bool("result" in frame or "error" in frame
                or frame.get("deadline_exceeded") or frame.get("dead_letter"))


def same_answer(got: dict, want: dict, what: str) -> None:
    """Decoded results: identical labels, images and boxes; numbers within
    the bf16 bundle tolerance."""
    import numpy as np

    if isinstance(want, dict):
        for k, v in want.items():
            same_answer(got[k], v, f"{what}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {got} vs {want}")
        for i, (g, w) in enumerate(zip(got, want)):
            same_answer(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, err_msg=what, **BUNDLE_BF16)
    elif got != want:
        raise AssertionError(f"{what}: {got!r} vs {want!r}")


def batched_order(got: dict, want: dict, what: str) -> str:
    """A row decoded from another bucket than ``want``'s against ``want``
    (``predict()``, bucket 1): the k-th confidence and score within
    ``BATCHED_ROW``. The order is not held: the bf16 GEMMs round a row by
    the bucket's shapes, and one bf16 step of a logit reorders the near-tied
    labels of a random-weight head (``same_bucket_rows`` holds the row
    exactly instead). Returns ("", False) when the whole order is
    identical, else both orders with their confidences and whether the
    first entry differs."""
    import numpy as np

    items = {"labels": "answers", "binary": "answers", "trinary": "answers",
             "grounding": "boxes", "ranking": "ranking"}[want["kind"]]
    key = {"answers": "answer", "boxes": "region_index",
           "ranking": "image"}[items]
    g, w = got[items], want[items]
    if len(g) != len(w):
        raise AssertionError(f"{what}: served {g}, predict() {w}")
    for field in ("confidence", "score"):
        if field in w[0]:
            np.testing.assert_allclose(
                [x[field] for x in g], [x[field] for x in w],
                err_msg=f"{what}: {field} by rank", **BATCHED_ROW)
    if [x[key] for x in g] == [x[key] for x in w]:
        return "", False
    pairs = lambda xs: [(x[key], x.get("confidence")) for x in xs]  # noqa
    return (f"{what}: served {pairs(g)} vs predict() {pairs(w)}",
            g[0][key] != w[0][key])


def request_key(req) -> tuple:
    """What a prepared request computes on: its task, its token ids and the
    bits of its image rows."""
    import hashlib

    import torch

    rows = hashlib.sha1()
    for a in (req.features.contiguous().view(torch.uint8).numpy(),
              req.spatials, req.image_mask):
        rows.update(a.tobytes())
    return (req.spec.task_id, req.n_images, req.text.input_ids.tobytes(),
            req.text.input_mask.tobytes(), req.text.segment_ids.tobytes(),
            rows.hexdigest())


def same_bucket_rows(calls: list) -> dict:
    """Every served row of every recorded ``run_many`` call against its own
    request run again on the same engine in a chunk of copies of itself:
    the same bucket, the same offset, other neighbours. A row's numbers
    depend on its request and on the bucket's shapes, never on the rows
    beside it, so the two must be identical. Returns the served results'
    JSON by ``request_key``."""
    served: dict = {}
    for c in calls:
        eng, reqs, kw = c["engine"], c["reqs"], c["kw"]
        plan = eng.chunk_plan([r.n_images for r in reqs],
                              chunk_rows=kw.get("chunk_rows"))
        for chunk in plan:
            for offset, pos in enumerate(chunk):
                req = reqs[pos]
                if any(reqs[p].n_images != req.n_images for p in chunk):
                    raise AssertionError(
                        f"a served chunk mixes image counts "
                        f"{[reqs[p].n_images for p in chunk]}: no chunk of "
                        f"copies has its layout")
                alone = eng.run_many([req] * len(chunk), **kw)[offset]
                got = c["got"][pos].to_json()
                if alone.to_json() != got:
                    raise AssertionError(
                        f"served row {offset} of a {len(chunk)}-request "
                        f"chunk differs from its request at the same offset "
                        f"in a chunk of its own copies: {got} vs "
                        f"{alone.to_json()}")
                served.setdefault(request_key(req), []).append(got)
    return served


def record_run_many(eng, calls: list) -> None:
    """Shadow ``eng.run_many`` with a wrapper that keeps every call: the
    engine, the requests, the results by position and the wall window. The
    scheduler dispatches each packed batch through it. ``del
    eng.run_many`` restores the method."""
    real = eng.run_many

    def run_many(reqs, **kw):
        got, user = {}, kw.pop("on_result", None)

        def on_result(pos, result):
            got[pos] = result
            if user is not None:
                user(pos, result)

        t0 = time.perf_counter()
        out = real(reqs, on_result=on_result, **kw)
        calls.append({"engine": eng, "reqs": list(reqs), "kw": kw,
                      "got": got, "t": (t0, time.perf_counter())})
        return out

    eng.run_many = run_many


def replay_calls(calls: list) -> int:
    """Every recorded ``run_many`` call again, on the engine that served it,
    with the same requests in the same order: each result must be
    identical to the served one (the same bucket graphs over the same rows
    are deterministic). Returns the results compared."""
    n = 0
    for c in calls:
        again = c["engine"].run_many(c["reqs"], **c["kw"])
        if sorted(c["got"]) != list(range(len(c["reqs"]))):
            raise AssertionError(f"run_many streamed {sorted(c['got'])} of "
                                 f"{len(c['reqs'])} results")
        for pos, result in c["got"].items():
            if again[pos].to_json() != result.to_json():
                raise AssertionError(
                    f"served row {pos} of a {len(c['reqs'])}-request batch "
                    f"differs from run_many of the same batch: "
                    f"{result.to_json()} vs {again[pos].to_json()}")
            n += 1
    return n


# Images with no feature file, uploaded during phase 7 (seed, height,
# width): four submitted one at a time, two during the scale-out.
NOVEL_UPLOADS = ((201, 480, 640), (202, 800, 1333), (203, 120, 160),
                 (204, 1500, 2000), (205, 600, 800), (206, 640, 480))
try:
    import PIL  # noqa: F401 — decides how novel uploads are sent
    from PIL import Image as _PILImage

    PIL_VERSION = PIL.__version__
except ImportError:
    _PILImage, PIL_VERSION = None, None


def multipart(name: str, data: bytes, ctype: str) -> tuple:
    """(body, content type) of a one-file multipart/form-data upload."""
    boundary = "chip-smoke-boundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: {ctype}\r\n\r\n"
            ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def upload_novel_images(port: int, state: str, specs) -> list:
    """POST each seeded image to ``/upload_image/``; returns the stored
    paths the server hands back. With PIL the uploads are PNG files the
    extractor decodes; without it, the images' arrays as ``.npy`` files,
    which :func:`time_extractions` hands the extractor decoded."""
    import http.client
    import io

    import numpy as np

    paths = []
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    for seed, h, w in specs:
        rgb = seeded_rgb(seed, h, w)
        buf = io.BytesIO()
        if _PILImage is not None:
            _PILImage.fromarray(rgb).save(buf, format="PNG")
            name, ctype = f"novel_{seed}.png", "image/png"
        else:
            np.save(buf, rgb)
            name, ctype = f"novel_{seed}.npy", "application/octet-stream"
        body, content_type = multipart(name, buf.getvalue(), ctype)
        conn.request("POST", "/upload_image/", body=body,
                     headers={"Content-Type": content_type})
        resp = conn.getresponse()
        got = json.loads(resp.read())
        if resp.status != 200 or len(got.get("file_paths", [])) != 1:
            raise AssertionError(f"upload {name}: {resp.status} {got}")
        paths.append(got["file_paths"][0])
    conn.close()
    if _PILImage is None:
        log("served: PIL is not installed on this machine: the novel "
            "uploads go as .npy arrays, decoded by chip_smoke.py for the "
            "extractor (the port's preprocessing needs no PIL)")
    return paths


class ExtractionTimes(list):
    """(start, end) host times of the extractions :func:`time_extractions`
    watched, and per extraction the decode ms, ``extract_array``'s wall ms
    and its device ms (CUDA events on the extractor's stream)."""

    def __init__(self):
        super().__init__()
        self.decode_ms, self.wall_ms, self.events = [], [], []

    def device_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.events]


def time_extractions(extractor) -> ExtractionTimes:
    """Wrap ``extractor.extract`` (an instance attribute: the app's one
    extractor) to time each extraction: the decode of the file (PIL, as
    ``extract`` does; a ``.npy`` upload, sent when PIL is missing, is
    loaded as an array) and ``extract_array``, on the host and on the
    card."""
    import numpy as np
    import torch

    times = ExtractionTimes()

    def extract(path):
        t0 = time.perf_counter()
        try:
            if path.endswith(".npy"):
                rgb = np.load(path)
            else:
                rgb = np.array(_PILImage.open(path).convert("RGB"))
            t1 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(extractor._stream)
            region = extractor.extract_array(rgb)
            end.record(extractor._stream)
            times.events.append((start, end))
            times.decode_ms.append((t1 - t0) * 1e3)
            times.wall_ms.append((time.perf_counter() - t1) * 1e3)
            return region
        finally:
            times.append((t0, time.perf_counter()))

    extractor.extract = extract
    return times


def check_served(torch, report: dict, eng, root: str, state: str) -> tuple:
    """ServeApp on the engine: HTTP submits → queue → scheduler → worker
    → engine → result store + push hub. First 14 submits one at a time
    (each its own forward, at predict()'s bucket: answers must equal
    predict()'s), then a burst of 32 from 8 clients at once (the scheduler
    batches it: each frame must be exactly its own request's row at the
    bucket it was served at, ``same_bucket_rows``, with confidences by rank
    within ``BATCHED_ROW`` of predict()'s, ``batched_order``), then scale-out
    under load: 2 clients keep posting VQA submits while a second replica
    is built and captures its graphs beside the first, which goes on
    serving (``check_scale_out``). Every batch the scheduler dispatched is
    replayed through ``run_many`` afterwards and must come out identical,
    and each served row must equal its request alone at the same bucket.

    The app runs with ``live_extract=True`` (a full-width seeded detector):
    after the 14 feature-file submits, 4 images that have no feature file
    are uploaded over ``/upload_image/`` and submitted one at a time (each
    must run the detector once: 2 NMS and 1 ROIAlign launches), then
    resubmitted with other questions (no detector run); 2 more uploads are
    submitted during the scale-out. Every novel answer is held to
    ``predict()`` of the same engine on the features the extractor
    returned, by the same rule as the other submits.
    Returns the kernel launches of the solo and burst submits and the
    detector kernels' launches of the whole phase."""
    import dataclasses
    import http.client
    import queue as queue_mod
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from vilbert_multitask_tpu_torch.detect import model as dm
    from vilbert_multitask_tpu_torch.ops import nms as nm
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )
    from vilbert_multitask_tpu_torch.serve.app import ServeApp

    serving = dataclasses.replace(
        eng.cfg.serving, queue_db_path=os.path.join(state, "q.sqlite3"),
        results_db_path=os.path.join(state, "r.sqlite3"),
        media_root=os.path.join(state, "media"), http_port=0, ws_port=0)
    cfg = dataclasses.replace(eng.cfg, serving=serving)
    def named(specs):  # feature-file keys → the names a client submits
        return [(t, q, [f"{n}.jpg" for n in imgs]) for t, q, imgs in specs]

    solo = named(list(SERVED_FAMILIES) + [
        (1, f"what is on the left {k}", [f"img_{k}"]) for k in range(8)])
    burst = named([(1, f"what is in this picture {k}", [f"img_{k % 8}"])
                   for k in range(32)])
    load = named([(1, f"what is happening here {k}", [f"img_{k % 8}"])
                  for k in range(SCALE_OUT_MAX_SUBMITS)])
    calls: list = []
    record_run_many(eng, calls)
    base_store = eng.feature_store
    t0 = time.perf_counter()
    app = ServeApp(cfg, engine=eng, feature_root=root, live_extract=True)
    app.warm()  # graphs captured already; the detector's first forward
    boot_s = time.perf_counter() - t0
    extractions = time_extractions(app.extractor)
    app.start()
    uploads = upload_novel_images(app.http_port, state, NOVEL_UPLOADS)
    novel_solo = [(1, f"what is in the uploaded picture {k}", [p])
                  for k, p in enumerate(uploads[:4])]
    novel_again = [(1, f"what colour is the uploaded picture {k}", [p])
                   for k, p in enumerate(uploads[:4])]
    novel_scale = [(1, f"what is in the new upload {k}", [p])
                   for k, p in enumerate(uploads[4:])]
    jobs, ids = [], {}  # ids: the job ids of each group
    for name, group in (("solo", solo), ("novel_solo", novel_solo),
                        ("novel_again", novel_again), ("burst", burst),
                        ("load", load), ("novel_scale", novel_scale)):
        ids[name] = list(range(len(jobs), len(jobs) + len(group)))
        jobs += group
    subs = {i: app.hub.subscribe(f"sock{i}") for i in range(len(jobs))}
    frames = {i: [] for i in range(len(jobs))}

    def post(conn, i) -> None:
        task_id, question, images = jobs[i]
        conn.request("POST", "/", body=json.dumps({
            "task_id": task_id, "socket_id": f"sock{i}",
            "question": question, "image_list": images}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise AssertionError(f"submit {i}: {resp.status} {body!r}")

    def submit(indices) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=30)
        for i in indices:
            post(conn, i)
        conn.close()

    def drain(until, timeout_s: float, grace_s: float = 0.0) -> None:
        """Collect terminal frames until ``until()`` holds, then
        ``grace_s`` more (a duplicate would show there)."""
        end, done_at = time.perf_counter() + timeout_s, None
        while time.perf_counter() < (done_at or end):
            idle = True
            for i, sub in subs.items():
                try:
                    frame = sub.get_nowait()
                except queue_mod.Empty:
                    continue
                idle = False
                if is_terminal(frame):
                    frames[i].append(frame)
            if done_at is None and until():
                done_at = time.perf_counter() + grace_s
            if idle:
                time.sleep(0.002)

    def one_at_a_time(group) -> dict:
        """Submit each job of ``group`` alone; seconds to its terminal
        frame, by id."""
        latency = {}
        for i in group:
            t = time.perf_counter()
            submit([i])
            drain(lambda i=i: bool(frames[i]), 120.0)
            latency[i] = time.perf_counter() - t
        return latency

    flash_cross_attention.launches = 0
    nm.nms_mask.launches = dm.roi_align.launches = 0
    try:
        t_solo = time.perf_counter()
        solo_latency = one_at_a_time(ids["solo"])
        solo_s = time.perf_counter() - t_solo
        solo_launches = flash_cross_attention.launches
        # Novel uploads, one at a time: the detector runs once for each...
        torch.cuda.synchronize()
        det0 = (nm.nms_mask.launches, dm.roi_align.launches)
        novel_latency = one_at_a_time(ids["novel_solo"])
        torch.cuda.synchronize()
        det1 = (nm.nms_mask.launches, dm.roi_align.launches)
        # ... and not again for the same upload with another question.
        again_latency = one_at_a_time(ids["novel_again"])
        torch.cuda.synchronize()
        det2 = (nm.nms_mask.launches, dm.roi_align.launches)
        novel_launches = flash_cross_attention.launches - solo_launches
        t_burst = time.perf_counter()
        burst_ids = ids["burst"]
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(submit, [burst_ids[k::8] for k in range(8)]))
        drain(lambda: all(frames[i] for i in burst_ids), 120.0)
        makespan = time.perf_counter() - t_burst
        drain(lambda: True, 1.0, grace_s=0.5)  # any duplicate, any submit
        torch.cuda.synchronize()
        launches = flash_cross_attention.launches
        posted = check_scale_out(report, app, eng, calls, post, drain,
                                 frames, ids["load"], ids["novel_scale"],
                                 extractions)
        torch.cuda.synchronize()
        detector_launches = {"nms": nm.nms_mask.launches,
                             "roi_align": dm.roi_align.launches}
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        rows = app.store.recent(len(jobs) + 10)
    finally:
        t_stop = time.perf_counter()
        app.stop()
        stop_s = time.perf_counter() - t_stop
        for c in {id(c["engine"]): c["engine"] for c in calls}.values():
            c.__dict__.pop("run_many", None)
        eng.__dict__.pop("run_many", None)
    n_novel = len(novel_solo)
    if (det1[0] - det0[0], det1[1] - det0[1]) != (
            NMS_PER_IMAGE * n_novel, ROI_PER_IMAGE * n_novel) \
            or det2 != det1:
        raise AssertionError(
            f"novel uploads: detector launches {det0} -> {det1} for "
            f"{n_novel} uploads, then {det2} after their resubmits")
    if detector_launches != {"nms": NMS_PER_IMAGE * len(extractions),
                             "roi_align": ROI_PER_IMAGE * len(extractions)}:
        raise AssertionError(f"served: detector launches {detector_launches}"
                             f" for {len(extractions)} extractions")
    if len(extractions) != len(uploads) or novel_launches != \
            LAUNCHES_PER_FORWARD * 2 * n_novel:
        raise AssertionError(f"served: {len(extractions)} extractions for "
                             f"{len(uploads)} uploads, {novel_launches} "
                             f"flash_attn launches for {2 * n_novel} "
                             f"novel submits")
    one_by_one = ids["solo"] + ids["novel_solo"] + ids["novel_again"]
    sent = one_by_one + burst_ids + posted
    counts = {i: len(frames[i]) for i in sent}
    if any(n != 1 for n in counts.values()) or any(
            frames[i] for i in set(range(len(jobs))) - set(sent)):
        raise AssertionError(f"terminal frames per submit: {counts}")
    if len(rows) != len(sent):
        raise AssertionError(f"{len(rows)} ResultStore rows for "
                             f"{len(sent)} submits")
    served_rows = same_bucket_rows(calls)
    swaps, top1_moved, drift, gap = [], 0, 0.0, math.inf
    for i in sent:
        task_id, question, images = jobs[i]
        frame = frames[i][0]
        if "result" not in frame:
            raise AssertionError(f"submit {i}: {frame}")
        want = eng.predict(task_id, question, images).to_json()
        got = {k: v for k, v in frame["result"].items() if k in want}
        what = f"submit {i} (task {task_id})"
        if i in one_by_one:
            same_answer(got, want, what)
        else:
            own = [{k: v for k, v in row.items() if k in want}
                   for row in served_rows.get(request_key(
                       eng.prepare_from_store(task_id, question, images)),
                       [])]
            if got not in own:
                raise AssertionError(
                    f"{what}: the frame {got} is no served row of its own "
                    f"request ({own})")
            swap, moved = batched_order(got, want, what)
            top1_moved += moved
            if want["kind"] == "labels":
                # How far batching moves a probability, against how close
                # predict()'s ranked labels sit: a swap needs drift > gap.
                g = [x["confidence"] for x in got["answers"]]
                w = [x["confidence"] for x in want["answers"]]
                drift = max([drift] + [abs(a - b) for a, b in zip(g, w)])
                gap = min([gap] + [a - b for a, b in zip(w, w[1:])])
            if swap:
                swaps.append(swap)
                log(f"served: order differs from predict(): {swap}")
    eng.feature_store = base_store
    replayed = replay_calls(calls)
    if replayed != len(sent):
        raise AssertionError(f"{replayed} served results replayed for "
                             f"{len(sent)} submits")
    solo_forwards = solo_launches // LAUNCHES_PER_FORWARD
    burst_forwards = ((launches - solo_launches - novel_launches)
                      // LAUNCHES_PER_FORWARD)
    if launches % LAUNCHES_PER_FORWARD or solo_forwards != len(solo) \
            or burst_forwards < 1:
        raise AssertionError(f"served path: {launches} kernel launches "
                             f"({solo_launches} for {len(solo)} solo "
                             f"submits)")
    if stop_s > 30.0 or any(t.name == "serve-worker"
                            for t in threading.enumerate()):
        raise AssertionError(f"ServeApp.stop took {stop_s:.1f}s or left "
                             f"its worker running")
    batched = len(sent) - len(one_by_one)
    feature_p50 = statistics.median(solo_latency.values()) * 1e3
    log(f"served novel uploads: {n_novel} images with no feature file "
        f"uploaded over /upload_image/ and submitted one at a time: served "
        f"latency {[round(v * 1e3, 1) for v in novel_latency.values()]} ms "
        f"(the detector ran once each: +{det1[0] - det0[0]} nms, "
        f"+{det1[1] - det0[1]} roi_align launches), resubmitted with other "
        f"questions {[round(v * 1e3, 1) for v in again_latency.values()]} "
        f"ms (no detector run), against feature-file submits p50 "
        f"{feature_p50:.1f} ms (min {min(solo_latency.values()) * 1e3:.1f})"
        f"; per extraction in the worker: decode "
        f"{[round(v, 1) for v in extractions.decode_ms]} ms, extract_array "
        f"wall {[round(v, 1) for v in extractions.wall_ms]} ms, device "
        f"{[round(v, 1) for v in extractions.device_ms()]} ms; answers "
        f"equal to predict() on the extracted features; "
        f"{len(extractions)} extractions in all, detector launches "
        f"{detector_launches} on {report['device']['nvidia_smi']}")
    log(f"served: {len(sent)} submits over HTTP, one terminal frame and one "
        f"ResultStore row each; {len(one_by_one)} one at a time "
        f"({len(solo)} in {solo_s:.3f}s, {solo_forwards} forwards), answers "
        f"equal to predict(); a burst "
        f"of {len(burst)} from 8 clients in {makespan:.3f}s "
        f"({burst_forwards} forwards); {batched} batched submits (burst "
        f"and scale-out), each exactly its request's row at its bucket "
        f"(against a chunk of its own copies) with confidences within rtol "
        f"{BATCHED_ROW['rtol']} / atol {BATCHED_ROW['atol']} of predict()'s, "
        f"{batched - len(swaps)} in predict()'s order, {top1_moved} with "
        f"another first label (largest confidence "
        f"drift from predict() {drift:.3e}, smallest gap between adjacent "
        f"ranks in predict() {gap:.3e}); all {replayed} served "
        f"results identical to run_many of their batch replayed "
        f"({len(calls)} batches); {launches} flash_attn launches (solo and "
        f"burst); boot {boot_s:.2f}s, stop {stop_s:.2f}s; healthz "
        f"ok={health.get('ok')}")
    report["served"] = {
        "submits": len(sent), "launches": launches,
        "solo": {"submits": len(solo), "forwards": solo_forwards,
                 "seconds": solo_s},
        "burst": {"submits": len(burst), "forwards": burst_forwards,
                  "makespan_s": makespan},
        "batched_same_order": batched - len(swaps), "order_swaps": swaps,
        "batched_top1_moved": top1_moved,
        "batched_same_bucket_identical": batched,
        "confidence_drift_max": drift, "adjacent_rank_gap_min": gap,
        "replayed_identical": replayed, "batches": len(calls),
        "stop_s": stop_s, "healthz_ok": health.get("ok"),
        "novel": {
            "uploads": len(uploads), "pil": PIL_VERSION,
            "extractions": len(extractions),
            "latency_ms": [v * 1e3 for v in novel_latency.values()],
            "resubmit_latency_ms": [v * 1e3 for v in again_latency.values()],
            "feature_file_latency_ms_p50": feature_p50,
            "feature_file_latency_ms": [v * 1e3
                                        for v in solo_latency.values()],
            "detector_launches": detector_launches,
            "extract_ms": [(b - a) * 1e3 for a, b in extractions],
            "decode_ms": extractions.decode_ms,
            "extract_array_wall_ms": extractions.wall_ms,
            "extract_array_device_ms": extractions.device_ms()}}
    return launches, detector_launches


def check_scale_out(report: dict, app, eng, calls: list, post, drain,
                    frames: dict, ids, novel_ids, extractions: list) -> list:
    """Scale-out under load: two clients post VQA submits (one every
    ~8 ms each) from ``ids`` while the pool gains a second replica — a
    full-width engine on the same weights, built, then warmed by
    ``ReplicaPool.add_replica(warm=True)`` (the autoscaler's actuator),
    which captures its 7 bucket graphs — and the first replica goes on
    serving meanwhile. The first replica must dispatch during the
    captures, the new one must come up ready and serve, no dispatch may
    fail, and every submit gets its answer. A third client posts the
    ``novel_ids`` (uploads no one has extracted yet) 0.3 s apart from the
    start of the scale-out: at least one extraction (``extractions``, host
    windows) must run while the new replica is built and warmed. Returns
    the posted ids."""
    import http.client
    import threading

    from vilbert_multitask_tpu_torch.engine import graphs as graphs_mod
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    pool = app.engine
    todo, posted, lock = iter(ids), [], threading.Lock()
    stop, errors = threading.Event(), []

    def client() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=30)
        try:
            while not stop.is_set():
                with lock:
                    i = next(todo, None)
                    if i is None:
                        return
                    posted.append(i)
                post(conn, i)
                time.sleep(0.008)
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)
        finally:
            conn.close()

    windows: list = []
    real_capture = graphs_mod.capture

    def timed_capture(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_capture(*a, **kw)
        finally:
            windows.append((t0, time.perf_counter()))

    def novel_client() -> None:
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=30)
        try:
            for i in novel_ids:
                with lock:
                    posted.append(i)
                post(conn, i)
                time.sleep(0.3)
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)
        finally:
            conn.close()

    clients = [threading.Thread(target=client, name=f"load-{k}")
               for k in range(2)]
    graphs_mod.capture = timed_capture
    try:
        for t in clients:
            t.start()
        drain(lambda: sum(bool(frames[i]) for i in list(posted)) >= 8, 60.0)
        t0 = time.perf_counter()
        clients.append(threading.Thread(target=novel_client, name="novel"))
        clients[-1].start()
        eng2 = InferenceEngine(eng.cfg, params=eng.model.state_dict(),
                               feature_store=eng.feature_store,
                               replica_id="r1", device=str(eng.device))
        record_run_many(eng2, calls)
        build_s = time.perf_counter() - t0
        rep = pool.add_replica(eng2, warm=True)
        add_s = time.perf_counter() - t0
        t_ready = time.perf_counter()
        # Load on, until the new replica has served a batch of its own.
        drain(lambda: any(c["engine"] is eng2 for c in list(calls)), 30.0)
    finally:
        stop.set()
        graphs_mod.capture = real_capture
        for t in clients:
            t.join(timeout=30)
    if errors or any(t.is_alive() for t in clients):
        raise AssertionError(f"scale-out load clients: {errors}")
    drain(lambda: all(frames[i] for i in posted), 120.0)
    drain(lambda: True, 1.0, grace_s=0.5)
    info = pool.replicas_info()
    during = sum(1 for c in calls if c["engine"] is eng and any(
        c["t"][0] < w1 and c["t"][1] > w0 for w0, w1 in windows))
    after = sum(1 for c in calls
                if c["engine"] is eng2 and c["t"][0] >= t_ready)
    if rep.state != "ready" or rep.last_error or len(windows) != len(
            eng2.cfg.engine.all_row_buckets()):
        raise AssertionError(f"scale-out: replica {rep.snapshot()}, "
                             f"{len(windows)} captures")
    if any(r["failures"] or r["failovers"] or r["breaker"] != "closed"
           or r["state"] != "ready" for r in info):
        raise AssertionError(f"scale-out under load: replicas {info}")
    if during < 1 or after < 1:
        raise AssertionError(
            f"scale-out under load: {during} dispatches of r0 overlapped "
            f"the captures, {after} batches served by r1 once ready")
    novel_during = [(a, b) for a, b in list(extractions)
                    if a < t_ready and b > t0]
    novel_capture = [(a, b) for a, b in novel_during if any(
        a < w1 and b > w0 for w0, w1 in windows)]
    if not novel_during:
        raise AssertionError(f"scale-out: no novel upload was extracted "
                             f"while r1 was built and warmed "
                             f"({len(extractions)} extractions)")
    capture_s = sum(w1 - w0 for w0, w1 in windows)
    log(f"scale-out under load: {len(posted)} VQA submits from 2 clients; "
        f"replica r1 built in {build_s:.2f}s and warmed by add_replica in "
        f"{add_s - build_s:.2f}s ({len(windows)} graph captures, "
        f"{capture_s:.3f}s in "
        f"all), while r0 served {during} batches that overlapped a "
        f"capture; r1 then served {after} batches; {len(novel_during)} "
        f"novel-upload extractions ran during the scale-out "
        f"({len(novel_capture)} overlapping a capture); no failure, no "
        f"failover, breakers closed ({[r['name'] for r in info]})")
    report["scale_out"] = {
        "submits": len(posted), "build_s": build_s,
        "warm_s": add_s - build_s, "capture_s": capture_s,
        "r0_batches_during_capture": during, "r1_batches": after,
        "novel_extractions_during": len(novel_during),
        "novel_extractions_during_capture": len(novel_capture),
        "replicas": info}
    return posted


# ---------------------------------------------------------------- phase 8
def check_entry_point(report: dict, root: str, state: str) -> None:
    """``python -m vilbert_multitask_tpu_torch.serve.app --features <dir>
    --live-extract`` in a process of its own: boots on the card (the trunk
    and the full-width detector), captures its graphs and warms the
    detector, reports ready on /healthz, answers a feature-file submit and
    an image uploaded over /upload_image/ into its result store, and
    drains on SIGTERM with exit code 0."""
    import http.client
    import queue as queue_mod
    import signal
    import threading

    cwd = os.path.join(state, "entry")
    os.makedirs(cwd)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vilbert_multitask_tpu_torch.serve.app",
         "--features", root, "--http-port", "0", "--ws-port", "0",
         "--live-extract"], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue_mod.Queue" = queue_mod.Queue()
    reader = threading.Thread(target=lambda: [lines.put(line)
                                              for line in proc.stdout],
                              daemon=True)
    reader.start()
    out = []

    def wait_for(prefix: str, timeout_s: float) -> str:
        end = time.perf_counter() + timeout_s
        while time.perf_counter() < end:
            try:
                line = lines.get(timeout=0.5)
            except queue_mod.Empty:
                if proc.poll() is not None:
                    break
                continue
            out.append(line)
            if line.startswith(prefix):
                return line
        raise AssertionError(f"serve.app never printed {prefix!r}: "
                             f"{''.join(out)[-3000:]}")

    try:
        url = wait_for("http://", 300.0).split()[0]
        port = int(url.rsplit(":", 1)[1])
        boot_s = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        buckets = health["boot"].get("buckets")
        boot = health["boot"]
        if not health["ok"] or buckets != [1, 2, 4, 8, 10, 16, 32] or not \
                boot["boot_phases"].get("compile_s") or not (
                    boot.get("live_extract") and boot.get("detector_warm")):
            raise AssertionError(f"serve.app not ready: {health}")
        if _PILImage is None:
            raise AssertionError("phase 8 uploads a PNG: PIL is needed")
        (upload,) = upload_novel_images(port, state, NOVEL_UPLOADS[:1])
        answers = {}
        for question, image in (("what is the entry point serving",
                                 "img_0.jpg"),
                                ("what is in the uploaded image", upload)):
            t_submit = time.perf_counter()
            conn.request("POST", "/", body=json.dumps({
                "task_id": 1, "socket_id": "entry", "question": question,
                "image_list": [image]}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                raise AssertionError(f"serve.app submit: {resp.status} "
                                     f"{resp.read()!r}")
            resp.read()
            answer, end = None, time.perf_counter() + 120.0
            while answer is None and time.perf_counter() < end:
                conn.request("GET", "/admin/questionanswer?limit=5")
                for row in json.loads(conn.getresponse().read())["rows"]:
                    if row.get("input_text") == question and row.get(
                            "answer_text"):
                        answer = row["answer_text"]
                time.sleep(0.05)
            if answer is None or len(answer.get("answers", [])) != 3:
                raise AssertionError(f"serve.app answered {answer} to "
                                     f"{question!r}")
            answers[question] = (answer, time.perf_counter() - t_submit)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"serve.app exited {rc} after SIGTERM: "
                                 f"{''.join(out)[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"entry point: python -m vilbert_multitask_tpu_torch.serve.app "
        f"--live-extract ready in {boot_s:.1f}s (boot phases "
        f"{health['boot']['boot_phases']}, detector warm), answered " +
        ", ".join(f"{q!r} ({a['answers'][0]['answer']}, {t:.2f}s)"
                  for q, (a, t) in answers.items())
        + ", exit 0 on SIGTERM")
    report["entry_point"] = {
        "boot_s": boot_s, "boot_phases": health["boot"]["boot_phases"],
        "answer_s": {q: t for q, (_, t) in answers.items()}}


# ------------------------------------------------- phase 8: remote worker
REMOTE_SUBMITS = (  # (task id, question, image keys), one at a time
    (1, "what is the remote worker answering", ["img_0"]),
    (15, "is the cup left of the plate", ["img_1"]),
    (13, "a cat sleeps on the sofa", ["img_2"]),
    (12, "both images show a bridge", ["img_0", "img_3"]),
)
REMOTE_TOKEN = "chip-smoke-worker"


def check_remote_worker(torch, report: dict, eng, root: str,
                        state: str) -> None:
    """``python -m vilbert_multitask_tpu_torch.serve.remote`` in a process
    of its own on the card, draining an in-process web host with no engine
    (``ApiServer`` over ``DurableQueue`` + ``ResultStore`` + ``PushHub``)
    with phase 4's feature files and weights (the int8 phase's seed-0 f32
    checkpoint): four submits, one at a time, each get one terminal frame
    and one stored row whose answer equals ``predict()`` of phase 4's
    engine; a wrong worker token is refused; SIGTERM exits 0."""
    import dataclasses
    import queue as queue_mod
    import signal
    import threading
    import urllib.error
    import urllib.request

    from vilbert_multitask_tpu_torch.serve import (
        DurableQueue,
        PushHub,
        ResultStore,
    )
    from vilbert_multitask_tpu_torch.serve.http_api import ApiServer
    from vilbert_multitask_tpu_torch.serve.remote import WorkerApiClient

    web = os.path.join(state, "remote_web")
    os.makedirs(web)
    s = dataclasses.replace(
        eng.cfg.serving, queue_db_path=os.path.join(web, "q.sqlite3"),
        results_db_path=os.path.join(web, "r.sqlite3"),
        media_root=os.path.join(web, "media"), worker_token=REMOTE_TOKEN)
    hub = PushHub()
    q = DurableQueue(s.queue_db_path,
                     max_delivery_attempts=s.max_delivery_attempts)
    store = ResultStore(s.results_db_path)
    api = ApiServer(q, store, hub, s)
    url = f"http://127.0.0.1:{api.start()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vilbert_multitask_tpu_torch.serve.remote",
         "--url", url, "--features", root, "--checkpoint",
         os.path.join(state, "int8_ckpt"), "--token", REMOTE_TOKEN,
         "--poll", "0.05"], cwd=web, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out: list = []
    reader = threading.Thread(
        target=lambda: [out.append(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    try:
        try:
            WorkerApiClient(url, token="wrong").post("/worker/claim", {})
        except urllib.error.HTTPError as e:
            if e.code != 401:
                raise
        else:
            raise AssertionError("the web host took a wrong worker token")
        answered = []
        for i, (task_id, question, keys) in enumerate(REMOTE_SUBMITS):
            sock = f"remote-{i}"
            sub = hub.subscribe(sock)
            req = urllib.request.Request(
                url + "/", data=json.dumps({
                    "task_id": task_id, "socket_id": sock,
                    "question": question, "image_list": keys}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            t_submit = time.perf_counter()
            with urllib.request.urlopen(req, timeout=30) as r:
                json.loads(r.read())
            frames, end = [], time.perf_counter() + 600.0
            while not any(is_terminal(f) for f in frames):
                if time.perf_counter() > end or proc.poll() is not None:
                    raise AssertionError(
                        f"remote worker: no answer to submit {i} "
                        f"({frames}): {''.join(out)[-3000:]}")
                try:
                    frames.append(sub.get(timeout=0.05))
                except queue_mod.Empty:
                    pass
            latency = time.perf_counter() - t_submit
            time.sleep(0.2)  # a second terminal frame would land by now
            while not sub.empty():
                frames.append(sub.get_nowait())
            terminals = [f for f in frames if is_terminal(f)]
            if len(terminals) != 1 or "result" not in terminals[0]:
                raise AssertionError(f"remote worker submit {i}: {frames}")
            want = eng.predict(task_id, question, keys).to_json()
            same_answer({k: v for k, v in terminals[0]["result"].items()
                         if k in want}, want, f"remote submit {i}")
            answered.append(latency)
        rows = store.recent()
        if len(rows) != len(REMOTE_SUBMITS) or q.counts() != {}:
            raise AssertionError(f"remote worker: {len(rows)} rows, queue "
                                 f"{q.counts()}")
        for row in rows:
            task_id, question, keys = next(
                r for r in REMOTE_SUBMITS if r[1] == row["input_text"])
            want = eng.predict(task_id, question, keys).to_json()
            same_answer({k: v for k, v in row["answer_text"].items()
                         if k in want}, want, f"remote row {question!r}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"serve.remote exited {rc} after SIGTERM: "
                                 f"{''.join(out)[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        api.stop()
    wall = time.perf_counter() - t0
    log(f"remote worker: python -m vilbert_multitask_tpu_torch.serve.remote "
        f"answered {len(REMOTE_SUBMITS)} submits over HTTP as predict() "
        f"(first {answered[0]:.1f}s with boot, then "
        f"{[round(t, 3) for t in answered[1:]]} s), one terminal and one "
        f"row each, a wrong token refused, exit 0 on SIGTERM ({wall:.1f}s)")
    report["remote_worker"] = {"answer_s": answered, "wall_s": wall}


# ---------------------------------------------------------------- parallel
# The parallel phase. The card is one H100: NCCL refuses two ranks on one
# device, so the world-1 run is NCCL and the 2-rank runs are two processes
# sharing the card over gloo, whose collectives on CUDA tensors the port
# stages through host memory (parallel/comm.py). NCCL across cards runs
# only where there are two or more.
PARALLEL_LONG_REGIONS = 1024  # the sp run's bucket: 1023 boxes + global
PARALLEL_RING_MIN = 512
PARALLEL_TIMED_RUNS = 10
PARALLEL_TRAIN_STEPS = 3


def _parallel_cfg(model, **engine):
    from vilbert_multitask_tpu_torch.config import EngineConfig, FrameworkConfig

    return FrameworkConfig(model=model, engine=EngineConfig(**engine))


def _serve_session(eng, rank: int, fn):
    """``fn()`` on rank 0 of a mesh engine while the other ranks follow
    its dispatches; the launches each rank's kernels counted meanwhile."""
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )
    from vilbert_multitask_tpu_torch.ops.int8_linear import int8_linear
    from vilbert_multitask_tpu_torch.parallel.ring import ring_self_attention

    flash_cross_attention.launches = int8_linear.launches = 0
    ring_self_attention.calls = 0
    out = None
    if rank == 0:
        try:
            out = fn()
        finally:
            eng.stop_followers()
    else:
        eng.follow()
    return out, {"flash_attn": flash_cross_attention.launches,
                 "int8_linear": int8_linear.launches,
                 "ring_calls": ring_self_attention.calls}


def _bundles(eng, requests) -> dict:
    """Rank 0: the host decode bundle and the answer of each request."""
    out = {}
    for task_id, question, keys in requests:
        req = eng.prepare_from_store(task_id, question, keys)
        _, bundle = eng.bundle(req)
        out[task_id] = (bundle, eng.decode(req, bundle).to_json())
    return out


def parallel_serve_rank(rank: int, job: dict) -> dict:
    """The serving runs of the parallel phase on one rank of a 2-rank
    world: tp = 2 in f32 and bf16, tp = 2 int8, sp = 2 over a long region
    set, dp = 2 run_many. Rank 0 returns the results; every rank its
    launch counts and staging."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from vilbert_multitask_tpu_torch.checkpoint.store import restore_params
    from vilbert_multitask_tpu_torch.config import MeshConfig
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
    from vilbert_multitask_tpu_torch.features.store import FeatureStore
    from vilbert_multitask_tpu_torch.models.int8 import QuantLinear
    from vilbert_multitask_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_plain,
    )
    from vilbert_multitask_tpu_torch.parallel import (
        build_mesh,
        comm,
        distributed,
    )
    from vilbert_multitask_tpu_torch.parallel.tp import (
        QuantRowParallelLinear,
    )

    dev = distributed.device()
    model = job["model"]
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(dev), "runs": {}}

    def engine(cfg, mesh, dtype, root):
        params = restore_params(job["ckpt"], dtype=dtype, cfg=cfg.model,
                                mesh=mesh)
        return InferenceEngine(cfg, params=params,
                               feature_store=FeatureStore(root), mesh=mesh,
                               device=dev)

    def run(name, cfg, mesh_cfg, dtype, root, fn):
        comm.reset_staged()
        t0 = time.perf_counter()
        mesh = build_mesh(mesh_cfg)
        eng = engine(cfg, mesh, dtype, root)
        got, counts = _serve_session(eng, rank, lambda: fn(eng))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["runs"][name] = {"result": got, "counts": counts,
                             "staged": dict(comm.STAGED),
                             "mesh": dict(zip(mesh.mesh_dim_names,
                                              list(mesh.mesh.shape))),
                             "wall_s": time.perf_counter() - t0}
        return eng

    f32 = _parallel_cfg(model, compute_dtype="float32")
    bf16 = _parallel_cfg(model)
    requests = job["requests"]
    run("tp2_f32", f32, MeshConfig(dp=1, tp=2), "float32", job["root"],
        lambda eng: _bundles(eng, requests))

    def timed(eng):
        req = eng.prepare_from_store(*requests[0][:2], requests[0][2])
        for _ in range(3):
            eng.run(req)
        times = []
        for _ in range(PARALLEL_TIMED_RUNS):
            t0 = time.perf_counter()
            eng.run(req)
            times.append((time.perf_counter() - t0) * 1e3)
        return {"bundles": _bundles(eng, requests[:1]),
                "run_ms": statistics.median(times),
                "forwards": 3 + PARALLEL_TIMED_RUNS + 1}

    run("tp2_bf16", bf16, MeshConfig(dp=1, tp=2), None, job["root"], timed)

    # int8: each rank records its products' shapes during the requests.
    int8_cfg = dataclasses.replace(bf16, engine=dataclasses.replace(
        bf16.engine, param_dtype="int8"))
    seen: dict = {}
    calls: list = []

    comm.reset_staged()
    mesh = build_mesh(MeshConfig(dp=1, tp=2))
    eng = engine(int8_cfg, mesh, "int8", job["root"])

    def record(mod, args):
        x = args[0]
        shape = (x.numel() // x.shape[-1], mod.out_features, mod.in_features)
        seen.setdefault(shape, mod)
        calls.append(shape)

    def first_then_rest():
        """The first request (bucket 1) alone, then the rest; the trunk
        products of that first forward are ``calls[:first]``."""
        got = _bundles(eng, requests[:1])
        out["int8_first_forward"] = len(calls)
        got.update(_bundles(eng, requests[1:]))
        return got

    hooks = [m.register_forward_pre_hook(record)
             for m in eng.model.modules() if isinstance(m, QuantLinear)]
    got, counts = _serve_session(eng, rank, first_then_rest)
    for h in hooks:
        h.remove()
    out["runs"]["tp2_int8"] = {"result": got, "counts": counts,
                               "staged": dict(comm.STAGED)}
    # Every rank holds its own shards against the plain version; then
    # rank 0 alone times them (the card is shared: no timing overlaps the
    # other rank's work).
    shapes, operands = [], []
    gen = torch.Generator().manual_seed(7 + rank)
    for (M, N, K), mod in sorted(seen.items(), key=lambda kv: kv[0]):
        x = torch.randn(M, K, generator=gen).to(dev, torch.bfloat16)
        q, s = mod.qweight, mod.kernel_scale
        # a row shard adds its bias after the tp sum, not in the product
        b = (None if isinstance(mod, QuantRowParallelLinear)
             else mod.kernel_bias)
        ref = int8_linear_plain(x, q, s, b).float()
        got = int8_linear(x, q, s, b, scale_bf16=True).float()
        err, used = (bf16_check(got, ref) if dev.type == "cuda"
                     else (0.0, 0.0))
        shapes.append({"M": M, "N": N, "K": K, "max_abs_err_bf16": err,
                       "tol_used_bf16": used, "module": type(mod).__name__})
        operands.append((x, q, s, b))
    dist.barrier()
    if rank == 0 and dev.type == "cuda":
        for row, (x, q, s, b) in zip(shapes, operands):
            # the library call: F.linear on the dequantized bf16 shard
            w16 = (q.float() * s.float().unsqueeze(-1)).to(torch.bfloat16)
            row["kernel_ms"] = device_ms(
                lambda: int8_linear(x, q, s, b, scale_bf16=True),
                reps=5, inner=5)
            row["plain_ms"] = device_ms(
                lambda: int8_linear_plain(x, q, s, b), reps=5, inner=5)
            row["library_ms"] = device_ms(
                lambda: torch.nn.functional.linear(x, w16, b),
                reps=5, inner=5)
            t_bytes, t_ops = int8_bound_parts(row["M"], row["N"], row["K"],
                                              1, 2, bias=b is not None)
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        by_shape = {(r["M"], r["N"], r["K"]): r for r in shapes}
        first = calls[:out["int8_first_forward"]]
        out["int8_forward_ms"] = {"products": len(first), **{
            key: sum(by_shape[c][key] for c in first)
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}}
    dist.barrier()
    out["int8_shapes"] = shapes
    del eng, operands

    long_cfg = _parallel_cfg(
        model, compute_dtype="float32", max_regions=PARALLEL_LONG_REGIONS,
        num_features=PARALLEL_LONG_REGIONS - 1,
        ring_min_regions=PARALLEL_RING_MIN, image_buckets=(1, 2))
    run("sp2_f32_long", long_cfg, MeshConfig(dp=1, tp=1, sp=2), "float32",
        job["long_root"], lambda eng: _bundles(eng, job["long_requests"]))

    def many(eng):
        reqs = [eng.prepare_from_store(t, q, k) for t, q, k in job["backlog"]]
        return {"results": [r.to_json() for r in eng.run_many(reqs)],
                "rows": sum(r.n_images for r in reqs)}

    run("dp2_run_many", f32, MeshConfig(dp=2, tp=1), "float32",
        job["root"], many)
    return out


def parallel_tp3_rank(rank: int, job: dict) -> dict:
    """tp = 3 at full width in bf16 on one rank of a 3-rank world sharing
    the card: the text self-attentions sharded (12 heads / 3), the visual
    and bridge attentions whole on every rank (8 % 3). Rank 0 returns the
    six families' bundles; every rank its launches, heads and weight
    bytes."""
    import torch

    from vilbert_multitask_tpu_torch.checkpoint.store import restore_params
    from vilbert_multitask_tpu_torch.config import MeshConfig
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
    from vilbert_multitask_tpu_torch.features.store import FeatureStore
    from vilbert_multitask_tpu_torch.models.layers import BiAttention
    from vilbert_multitask_tpu_torch.ops.attention import FusedSelfAttention
    from vilbert_multitask_tpu_torch.parallel import (
        build_mesh,
        comm,
        distributed,
    )

    dev = distributed.device()
    cfg = _parallel_cfg(job["model"])
    comm.reset_staged()
    t0 = time.perf_counter()
    mesh = build_mesh(MeshConfig(dp=1, tp=3))
    eng = InferenceEngine(cfg, params=restore_params(
        job["ckpt"], cfg=cfg.model, mesh=mesh),
        feature_store=FeatureStore(job["root"]), mesh=mesh, device=dev)
    heads = {}
    for name, mod in eng.model.named_modules():
        if isinstance(mod, (FusedSelfAttention, BiAttention)):
            heads.setdefault(name.split(".")[2], set()).add(mod.num_heads)
    weight_bytes = engine_tensor_bytes(torch, eng)
    got, counts = _serve_session(eng, rank,
                                 lambda: _bundles(eng, job["requests"]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"result": got, "counts": counts,
            "forwards": len(job["requests"]),
            "heads": {k: sorted(v) for k, v in heads.items()},
            "weight_mib": weight_bytes / 2**20, "staged": dict(comm.STAGED),
            "wall_s": time.perf_counter() - t0}


def parallel_swap_rank(rank: int, job: dict) -> dict:
    """``ServeApp`` at tp = 2 on one rank of a 2-rank world sharing the
    card (rank 0; rank 1 follows), booted from the old checkpoint: a
    ``rolling_swap`` to the new one, then the six families' bundles."""
    from vilbert_multitask_tpu_torch.parallel import distributed
    from vilbert_multitask_tpu_torch.serve.app import ServeApp, follow_rank

    dev = str(distributed.device())
    if rank != 0:
        follow_rank(job["cfg"], checkpoint_path=job["old"], device=dev)
        return {}
    t0 = time.perf_counter()
    app = ServeApp(job["cfg"], feature_root=job["root"],
                   checkpoint_path=job["old"], device=dev)
    try:
        boot_s = time.perf_counter() - t0
        eng = app.engine.replicas[0].engine
        app.engine.mark_ready()
        before = _bundles(eng, job["requests"][:1])
        t1 = time.perf_counter()
        swap = app.rolling_swap(checkpoint_path=job["new"])
        swap_s = time.perf_counter() - t1
        return {"before": before, "after": _bundles(eng, job["requests"]),
                "swap": swap, "swap_s": swap_s, "boot_s": boot_s,
                "boot_phases": app.boot_info.get("boot_phases"),
                "last_swap": app.boot_info.get("last_swap")}
    finally:
        app.stop()


def parallel_train_rank(rank: int, job: dict) -> dict:
    """The training runs of the parallel phase on one rank of a 2-rank
    world: 3 f32 steps (dropout off) at tp = 2 and at dp = 2 against the
    single-device step on rank 0's device, then a ``Trainer`` at tp = 2
    writing a snapshot (``job["out"]``), or, with ``job["resume"]``,
    resuming one on a fresh launch."""
    import torch

    from vilbert_multitask_tpu_torch.checkpoint.store import (
        TRAIN_STATE_FILE,
        _gathered,
    )
    from vilbert_multitask_tpu_torch.config import MeshConfig
    from vilbert_multitask_tpu_torch.engine.runtime import init_state_dict
    from vilbert_multitask_tpu_torch.models.vilbert import ViLBertForVLTasks
    from vilbert_multitask_tpu_torch.parallel import build_mesh, distributed
    from vilbert_multitask_tpu_torch.parallel.sharding import (
        shard_state_dict,
    )
    from vilbert_multitask_tpu_torch.parallel.tp import parallelize
    from vilbert_multitask_tpu_torch.train import losses, step
    from vilbert_multitask_tpu_torch.train.loop import (
        LoopConfig,
        MultiTaskSampler,
        SyntheticTaskData,
        Trainer,
    )

    dev = distributed.device()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mcfg = job["train_model"]
    cfg = _parallel_cfg(mcfg, compute_dtype="float32")
    out: dict = {}
    heads = ("vqa", "gqa", "binary", "tri", "grounding", "retrieval", "mlm",
             "mrm")

    def loop_cfg(steps):
        return LoopConfig(total_steps=steps, batch_size=4, log_every=1,
                          ckpt_every=2, warmup_steps=1,
                          learning_rate=TRAIN_PARITY_LR)

    def sampler():
        return MultiTaskSampler({h: SyntheticTaskData(h, cfg)
                                 for h in ("vqa", "tri")})

    if job.get("resume"):
        logs: list = []
        t = Trainer(cfg, sampler(), loop_cfg(PARALLEL_TRAIN_STEPS),
                    out_dir=job["out"], mesh=build_mesh(MeshConfig(tp=2)),
                    device=dev, log_fn=logs.append)
        saved = torch.load(os.path.join(job["out"], "step_00000002",
                                        TRAIN_STATE_FILE),
                           map_location="cpu", weights_only=True)
        equal = True
        for what in ("params", "mu", "nu"):
            tree = _gathered(getattr(t.state, what), t.state)
            equal = equal and all(torch.equal(tree[k].cpu(), v)
                                  for k, v in saved[what].items())
        out["resumed_step"] = t.state.step
        out["restored_bit_equal"] = bool(equal)
        t.train()
        out["losses"] = [json.loads(x)["loss/total"] for x in logs
                         if x.startswith('{"')]
        return out

    weights = init_state_dict(mcfg, seed=3)
    batch = _all_heads_batch(cfg, 4)

    def steps(mesh):
        with torch.device("meta"):
            model = ViLBertForVLTasks(mcfg)
            if mesh is not None:
                parallelize(model, mesh)
        model.to_empty(device=dev)
        model.tie_weights()
        sd = weights if mesh is None else shard_state_dict(weights, mesh)
        model.load_state_dict(sd, strict=True)
        model.eval()
        tx = step.default_optimizer(learning_rate=TRAIN_PARITY_LR,
                                    warmup_steps=1, total_steps=50)
        state = step.create_train_state(model, tx, mesh=mesh)
        fn = step.make_train_step(model, tx, losses.LossConfig(heads=heads))
        t0 = time.perf_counter()
        metrics = []
        for _ in range(PARALLEL_TRAIN_STEPS):
            state, m = fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        params = (_gathered(state.params, state) if mesh is not None
                  else state.params)
        return metrics, {k: v.detach() for k, v in params.items()}, seconds

    single = steps(None) if rank == 0 else None
    for name, mesh_cfg in (("tp2", MeshConfig(dp=1, tp=2)),
                           ("dp2", MeshConfig(dp=2, tp=1))):
        metrics, params, seconds = steps(build_mesh(mesh_cfg))
        if rank != 0:
            continue
        far = total = 0
        worst = 0.0
        over = []
        lr_steps = TRAIN_PARITY_LR * PARALLEL_TRAIN_STEPS
        for k, p in single[1].items():
            d = (params[k] - p).abs()
            limit = lr_steps if _zero_gradient(k) else 0.1 * lr_steps
            if float(d.max()) > limit:
                over.append((k, float(d.max()), limit))
            if not _zero_gradient(k):
                far += int((d > 1e-6).sum())
                total += d.numel()
                worst = max(worst, float(d.max()))
        out[name] = {"metrics": metrics, "single_metrics": single[0],
                     "seconds": seconds, "single_seconds": single[2],
                     "max_abs_param_diff": worst,
                     "elements_beyond_1e-6": far, "elements": total,
                     "over_limit": over}
    del single
    logs = []
    t = Trainer(cfg, sampler(), loop_cfg(PARALLEL_TRAIN_STEPS),
                out_dir=job["out"], mesh=build_mesh(MeshConfig(tp=2)),
                device=dev, log_fn=logs.append)
    t.train()
    out["losses"] = [json.loads(x)["loss/total"] for x in logs
                     if x.startswith('{"')]
    return out


def _write_long_features(root: str, dim: int) -> list:
    """Two feature files of PARALLEL_LONG_REGIONS - 1 boxes (the sp run's
    bucket: every region real), and the sp run's requests."""
    import numpy as np

    from vilbert_multitask_tpu_torch.features.pipeline import (
        synthetic_regions,
    )
    from vilbert_multitask_tpu_torch.features.store import save_reference_npy

    rng = np.random.default_rng(4321)
    for i in range(2):
        save_reference_npy(os.path.join(root, f"long_{i}.npy"),
                           synthetic_regions(
                               dim, n_boxes=PARALLEL_LONG_REGIONS - 1,
                               rng=rng, image_w=2000, image_h=1500),
                           f"long_{i}")
    return [(1, "what is in the crowd", ["long_0"]),
            (12, "both images show many people", ["long_0", "long_1"])]


def _same_answers(got: dict, want: dict, tol: dict, what: str, *,
                  exact_answers: bool = True) -> tuple:
    """Decode bundles within ``tol`` (compare_bundles) and, with
    ``exact_answers`` (f32), the same answers; returns (max abs error,
    share of tol used, bit-equal, tasks whose answer differs). A bf16
    answer may reorder labels or boxes whose scores tie to a bf16 step
    (phase 7's lesson): those are counted, not failed."""
    import numpy as np

    worst = used = 0.0
    equal = True
    differ = []
    for task_id, (bundle, answer) in want.items():
        g_bundle, g_answer = got[task_id]
        err, u = compare_bundles(bundle, g_bundle, tol,
                                 f"{what} task {task_id}")
        worst, used = max(worst, err), max(used, u)
        equal = equal and all(
            np.array_equal(a, b) for a, b in zip(
                flat_bundle(bundle).values(), flat_bundle(g_bundle).values()))
        if _answer_keys(g_answer) != _answer_keys(answer):
            if exact_answers:
                raise AssertionError(f"{what} task {task_id}: answer "
                                     f"{g_answer} vs {answer}")
            differ.append(task_id)
    return worst, used, equal, differ


def _numbers(result: dict) -> list:
    """A decoded result's confidences and scores, in order."""
    out = []
    for key in ("answers", "ranking", "boxes"):
        for a in result.get(key) or ():
            out += [a[k] for k in ("confidence", "score") if k in a]
    return out


def _answer_keys(result: dict):
    """A decoded result's answers without their numbers."""
    for key in ("answers", "ranking", "boxes"):
        if result.get(key) is not None:
            return [{k: v for k, v in a.items()
                     if k not in ("confidence", "score")}
                    for a in result[key]]
    return result.get("kind")


def check_parallel(torch, report: dict, root: str, state: str, *,
                   model=None, device: str = "cuda") -> dict:
    """The parallel phase (see the module docstring): world 1 on NCCL in
    this process, then the 2-rank serving and training runs through
    ``parallel.launch.spawn_ranks`` on gloo with CUDA tensors, each held
    against the single-device engine or step on this card; NCCL across
    cards where there are two or more. Returns the per-rank launches of
    one tp = 2 forward."""
    import dataclasses
    import shutil

    from vilbert_multitask_tpu_torch import _build
    from vilbert_multitask_tpu_torch.checkpoint.store import (
        restore_params,
        save_params,
    )
    from vilbert_multitask_tpu_torch.config import (
        MeshConfig,
        ViLBertConfig,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine,
        init_state_dict,
    )
    from vilbert_multitask_tpu_torch.features.store import FeatureStore
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )
    from vilbert_multitask_tpu_torch.parallel import (
        build_mesh,
        distributed,
        launch,
    )

    model = model or ViLBertConfig()
    world1_backend = distributed.default_backend(device)  # nccl on the card
    rep: dict = {"device_count": torch.cuda.device_count()
                 if device == "cuda" else 0}
    report["parallel"] = rep
    t_phase = time.perf_counter()
    ckpt = os.path.join(state, "parallel_ckpt")
    weights = init_state_dict(model, seed=0)  # phase 4's weights
    save_params(ckpt, weights)
    store = FeatureStore(root)
    bf16 = _parallel_cfg(model)
    f32 = _parallel_cfg(model, compute_dtype="float32")

    # 1. world 1 on NCCL, in this process: the mesh engine against the
    # single-device engine, both eager, on the same weights.
    distributed.initialize(
        world1_backend, init_method=f"tcp://127.0.0.1:{launch.free_port()}",
        world_size=1, rank=0, device=device)
    try:
        mesh = build_mesh(MeshConfig())
        mesh_eng = InferenceEngine(bf16, params=weights, feature_store=store,
                                   mesh=mesh, device=device)
        eager = InferenceEngine(bf16, params=weights, feature_store=store,
                                device=device)
        flash_cross_attention.launches = 0
        got = _bundles(mesh_eng, REQUESTS)
        n = flash_cross_attention.launches
        want = _bundles(eager, REQUESTS)
        err, used, equal, _ = _same_answers(got, want, BUNDLE_F32,
                                            "world 1")
        rep["world1"] = {"backend": world1_backend,
                         "mesh": dict(zip(mesh.mesh_dim_names,
                                          list(mesh.mesh.shape))),
                         "bit_equal": equal, "max_abs_err": err,
                         "tol_used_f32": used,
                         "flash_launches_per_forward": n / len(REQUESTS)}
        log(f"parallel: world 1 on {world1_backend}, mesh "
            f"{rep['world1']['mesh']}: bundles bit-equal to eager "
            f"predict(): {equal} (max abs err {err:.3e}); "
            f"{n / len(REQUESTS):g} flash_attn launches per forward")
        del mesh_eng, eager
    finally:
        distributed.shutdown()

    # References on this card: eager single-device engines.
    long_root = os.path.join(state, "long_features")
    os.makedirs(long_root, exist_ok=True)
    long_requests = _write_long_features(long_root, model.v_feature_size)
    ref_f32 = InferenceEngine(f32, params=weights, feature_store=store,
                              device=device)
    want_f32 = _bundles(ref_f32, REQUESTS)
    specs = backlog()
    want_many = [r.to_json() for r in ref_f32.run_many(
        [ref_f32.prepare_from_store(t, q, k) for t, q, k in specs])]
    del ref_f32
    ref_int8 = InferenceEngine(
        dataclasses.replace(bf16, engine=dataclasses.replace(
            bf16.engine, param_dtype="int8")),
        params=restore_params(ckpt, dtype="int8", cfg=model),
        feature_store=store, device=device)
    want_int8 = _bundles(ref_int8, REQUESTS)
    del ref_int8
    long_cfg = _parallel_cfg(
        model, compute_dtype="float32", max_regions=PARALLEL_LONG_REGIONS,
        num_features=PARALLEL_LONG_REGIONS - 1,
        ring_min_regions=PARALLEL_RING_MIN, image_buckets=(1, 2))
    ref_long = InferenceEngine(long_cfg, params=weights,
                               feature_store=FeatureStore(long_root),
                               device=device)
    want_long = _bundles(ref_long, long_requests)
    del ref_long
    ref_bf16 = InferenceEngine(bf16, params=weights, feature_store=store,
                               device=device)
    want_bf16_all = _bundles(ref_bf16, REQUESTS)
    want_bf16 = {REQUESTS[0][0]: want_bf16_all[REQUESTS[0][0]]}
    req = ref_bf16.prepare_from_store(*REQUESTS[0][:2], REQUESTS[0][2])
    for _ in range(3):
        ref_bf16.run(req)
    times = []
    for _ in range(PARALLEL_TIMED_RUNS):
        t0 = time.perf_counter()
        ref_bf16.run(req)
        times.append((time.perf_counter() - t0) * 1e3)
    rep["single_bf16_eager_run_ms"] = statistics.median(times)
    del ref_bf16
    if device == "cuda":
        torch.cuda.empty_cache()

    # 2. two ranks on this card (gloo, CUDA tensors staged), and NCCL
    # across cards where there are two.
    job = dict(model=model, ckpt=ckpt, root=root, long_root=long_root,
               requests=REQUESTS, long_requests=long_requests,
               backlog=specs)
    worlds = [("gloo", "two ranks on one card")]
    if device == "cuda" and torch.cuda.device_count() >= 2:
        worlds.append(("nccl", "one card per rank"))
    else:
        rep["nccl_across_cards"] = (
            f"not run: {rep['device_count']} card(s); NCCL takes one card "
            f"per rank")
        log(f"parallel: NCCL across cards {rep['nccl_across_cards']}")
    tp_launches = None
    for backend, how in worlds:
        t0 = time.perf_counter()
        ranks_out = launch.spawn_ranks(parallel_serve_rank, 2,
                                       backend=backend, device=device,
                                       args=(job,), timeout_s=900)
        r0 = ranks_out[0]
        runs = r0["runs"]
        res = {"backend": r0["backend"], "world": r0["world"], "how": how,
               "devices": [r["device"] for r in ranks_out],
               "wall_s": time.perf_counter() - t0,
               "staged": {name: [r["runs"][name]["staged"]
                                 for r in ranks_out] for name in runs}}
        log(f"parallel: {backend}, world {r0['world']} ({how}), devices "
            f"{res['devices']}; staged through host memory per run: "
            + "; ".join(f"{name} {st[0]['ops']} ops / {st[0]['bytes']} B"
                        for name, st in res["staged"].items()))
        err, used, equal, _ = _same_answers(runs["tp2_f32"]["result"],
                                            want_f32, BUNDLE_F32,
                                            "tp=2 f32")
        res["tp2_f32"] = {"max_abs_err": err, "tol_used": used,
                          "bit_equal": equal}
        timed = runs["tp2_bf16"]["result"]
        per_rank = [r["runs"]["tp2_bf16"]["counts"]["flash_attn"]
                    / timed["forwards"] for r in ranks_out]
        err16, used16, _, differ16 = _same_answers(
            timed["bundles"], want_bf16, BUNDLE_BF16, "tp=2 bf16",
            exact_answers=False)
        res["tp2_bf16"] = {"run_ms_p50": timed["run_ms"],
                           "flash_launches_per_forward_by_rank": per_rank,
                           "max_abs_err": err16, "tol_used": used16,
                           "answers_differ": differ16}
        if any(n != LAUNCHES_PER_FORWARD for n in per_rank):
            raise AssertionError(f"tp=2 bf16: flash_attn launches per "
                                 f"forward per rank {per_rank}, expected "
                                 f"{LAUNCHES_PER_FORWARD}")
        err8, used8, _, differ8 = _same_answers(
            runs["tp2_int8"]["result"], want_int8, BUNDLE_BF16, "tp=2 int8",
            exact_answers=False)
        int8_per_rank = [r["runs"]["tp2_int8"]["counts"]["int8_linear"]
                         / len(REQUESTS) for r in ranks_out]
        shapes = r0["int8_shapes"]
        worst_used = max(s["tol_used_bf16"] for r in ranks_out
                         for s in r["int8_shapes"])
        if worst_used > 1.0:
            raise AssertionError(
                f"tp=2 int8_linear beyond the bf16 tolerance: "
                f"{[r['int8_shapes'] for r in ranks_out]}")
        res["tp2_int8"] = {"max_abs_err": err8, "tol_used": used8,
                           "answers_differ": differ8,
                           "bucket1_trunk_forward": r0.get("int8_forward_ms"),
                           "int8_launches_per_request_by_rank":
                               int8_per_rank,
                           "shapes": shapes, "tol_used_bf16": worst_used,
                           "tol_used_bf16_by_rank": [
                               max(s["tol_used_bf16"]
                                   for s in r["int8_shapes"])
                               for r in ranks_out]}
        long_res = runs["sp2_f32_long"]
        errl, usedl, _, _ = _same_answers(long_res["result"], want_long,
                                          BUNDLE_F32, "sp=2 ring")
        ring_calls = [r["runs"]["sp2_f32_long"]["counts"]["ring_calls"]
                      for r in ranks_out]
        res["sp2_ring"] = {"max_abs_err": errl, "tol_used": usedl,
                           "ring_calls_by_rank": ring_calls,
                           "forwards": len(long_requests),
                           "layers": "the visual stream's "
                                     f"{model.v_num_hidden_layers} "
                                     "self-attentions"}
        if any(c != model.v_num_hidden_layers * len(long_requests)
               for c in ring_calls):
            raise AssertionError(f"sp=2: ring calls {ring_calls}, expected "
                                 f"{model.v_num_hidden_layers} per forward")
        many = runs["dp2_run_many"]["result"]
        same = exact = 0
        for got_r, want_r in zip(many["results"], want_many):
            if _answer_keys(got_r) != _answer_keys(want_r) or not all(
                    math.isclose(a, b, rel_tol=BUNDLE_F32["rtol"],
                                 abs_tol=BUNDLE_F32["atol"])
                    for a, b in zip(_numbers(got_r), _numbers(want_r))):
                raise AssertionError(f"dp=2 run_many: {got_r} vs {want_r}")
            same += 1
            exact += got_r == want_r
        res["dp2_run_many"] = {"requests": same, "rows": many["rows"],
                               "identical_results": exact}
        log(f"parallel: tp=2 f32 bundles vs the card's f32 engine max abs "
            f"err {err:.3e} ({used:.2f} of BUNDLE_F32, bit-equal {equal}); "
            f"tp=2 bf16 run() p50 {timed['run_ms']:.1f} ms (one rank "
            f"eager {rep['single_bf16_eager_run_ms']:.1f} ms), bundles vs "
            f"the card's bf16 engine max abs err {err16:.3e} ({used16:.2f} "
            f"of BUNDLE_BF16; answers reordered by bf16 ties in tasks "
            f"{differ16}), flash_attn "
            f"per forward per rank {per_rank}; tp=2 int8 max abs err "
            f"{err8:.3e} ({used8:.2f} of BUNDLE_BF16; answers reordered by "
            f"bf16 ties in tasks {differ8}), int8_linear per "
            f"request per rank {int8_per_rank}, {len(shapes)} sliced shapes "
            f"per rank within {worst_used:.2f} of the bf16 tolerance on both "
            f"ranks; sp=2 ring "
            f"calls {ring_calls} over {len(long_requests)} forwards of "
            f"{PARALLEL_LONG_REGIONS} regions, max abs err {errl:.3e} "
            f"({usedl:.2f} of BUNDLE_F32); dp=2 f32 run_many {same} "
            f"requests ({many['rows']} rows) the same answers within "
            f"BUNDLE_F32, {exact} identical")
        rep[backend] = res
        if backend == "gloo":
            tp_launches = {"flash_attn": per_rank[0],
                           "int8_linear": int8_per_rank[0]}

    # tp = 3 at full width: three ranks on this card, the visual and
    # bridge attentions whole on each (8 heads do not divide by 3).
    t0 = time.perf_counter()
    tp3 = launch.spawn_ranks(parallel_tp3_rank, 3, backend="gloo",
                             device=device, args=(dict(
                                 model=model, ckpt=ckpt, root=root,
                                 requests=REQUESTS),), timeout_s=900)
    err3, used3, _, differ3 = _same_answers(
        tp3[0]["result"], want_bf16_all, BUNDLE_BF16, "tp=3 bf16",
        exact_answers=False)
    per_rank3 = [r["counts"]["flash_attn"] / r["forwards"] for r in tp3]
    rep["tp3_bf16"] = {
        "wall_s": time.perf_counter() - t0, "max_abs_err": err3,
        "tol_used": used3, "answers_differ": differ3,
        "flash_launches_per_forward_by_rank": per_rank3,
        "heads_by_rank": [r["heads"] for r in tp3],
        "weight_mib_by_rank": [r["weight_mib"] for r in tp3],
        "staged": [r["staged"] for r in tp3],
        "rank_wall_s": [r["wall_s"] for r in tp3]}
    # an attention whose heads 3 does not divide keeps them all
    want_heads = {stream: [h if h % 3 else h // 3] for stream, h in (
        ("layer", model.num_attention_heads),
        ("v_layer", model.v_num_attention_heads),
        ("c_layer", model.bi_num_attention_heads))}
    if any(r["heads"] != want_heads for r in tp3):
        raise AssertionError(f"tp=3 heads per rank "
                             f"{[r['heads'] for r in tp3]}, expected "
                             f"{want_heads}")
    if any(n != LAUNCHES_PER_FORWARD for n in per_rank3):
        raise AssertionError(f"tp=3: flash_attn launches per forward per "
                             f"rank {per_rank3}, expected "
                             f"{LAUNCHES_PER_FORWARD}")
    log(f"parallel: tp=3 bf16, 3 gloo ranks on one card, heads per rank "
        f"{tp3[0]['heads']} (an attention whose heads 3 does not divide "
        f"whole): "
        f"bundles vs the card's bf16 engine max abs err {err3:.3e} "
        f"({used3:.2f} of BUNDLE_BF16; answers reordered by bf16 ties in "
        f"tasks {differ3}), flash_attn per forward per rank {per_rank3}, "
        f"weights per rank "
        f"{[round(r['weight_mib'], 1) for r in tp3]} MiB; "
        f"{rep['tp3_bf16']['wall_s']:.1f}s wall")

    # rolling_swap on a tp = 2 ServeApp, to seed-1 weights, against a
    # one-device engine on them.
    new_ckpt = os.path.join(state, "parallel_ckpt_new")
    new_weights = init_state_dict(model, seed=1)
    save_params(new_ckpt, new_weights)
    ref_new = InferenceEngine(bf16, params=new_weights, feature_store=store,
                              device=device)
    want_new = _bundles(ref_new, REQUESTS)
    del ref_new, new_weights
    if device == "cuda":
        torch.cuda.empty_cache()
    swap_cfg = dataclasses.replace(
        bf16, mesh=MeshConfig(dp=1, tp=2),
        engine=dataclasses.replace(bf16.engine,
                                   aot_cache_dir=_build.BUILD_DIR),
        serving=dataclasses.replace(
            bf16.serving, queue_db_path=os.path.join(state, "swap_q.sqlite3"),
            results_db_path=os.path.join(state, "swap_r.sqlite3"),
            media_root=os.path.join(state, "swap_media"), http_port=0,
            ws_port=0))
    t0 = time.perf_counter()
    sw = launch.spawn_ranks(parallel_swap_rank, 2, backend="gloo",
                            device=device, args=(dict(
                                cfg=swap_cfg, old=ckpt, new=new_ckpt,
                                root=root, requests=REQUESTS),),
                            timeout_s=900)[0]
    errs, useds, _, differs = _same_answers(
        sw["after"], want_new, BUNDLE_BF16, "tp=2 swap", exact_answers=False)
    _same_answers(sw["before"], want_bf16, BUNDLE_BF16, "tp=2 before swap",
                  exact_answers=False)
    import numpy as np

    first = REQUESTS[0][0]
    if all(np.array_equal(a, b) for a, b in zip(
            flat_bundle(sw["before"][first][0]).values(),
            flat_bundle(sw["after"][first][0]).values())):
        raise AssertionError("tp=2 swap: the bundle did not change")
    rep["tp2_swap"] = {"wall_s": time.perf_counter() - t0,
                       "swap_s": sw["swap_s"], "boot_s": sw["boot_s"],
                       "boot_phases": sw["boot_phases"],
                       "last_swap": sw["last_swap"], "max_abs_err": errs,
                       "tol_used": useds, "answers_differ": differs}
    log(f"parallel: rolling_swap on a tp=2 ServeApp (2 gloo ranks, one "
        f"card) to seed-1 weights in {sw['swap_s']:.2f}s (boot "
        f"{sw['boot_s']:.1f}s); bundles after it vs a one-device bf16 "
        f"engine on the new weights max abs err {errs:.3e} ({useds:.2f} of "
        f"BUNDLE_BF16; answers reordered by bf16 ties in tasks {differs}); "
        f"last_swap {sw['last_swap']}")

    # 3. training: tp = 2 and dp = 2 against the single-device step, then a
    # snapshot resumed on a fresh launch.
    train_model = dataclasses.replace(
        model, num_hidden_layers=2, v_num_hidden_layers=1,
        t_biattention_id=(1,), v_biattention_id=(0,))
    out1 = os.path.join(state, "parallel_train_a")
    out2 = os.path.join(state, "parallel_train_b")
    t0 = time.perf_counter()
    tr = launch.spawn_ranks(parallel_train_rank, 2, backend="gloo",
                            device=device, args=(dict(
                                train_model=train_model, out=out1),),
                            timeout_s=900)[0]
    os.makedirs(out2, exist_ok=True)
    shutil.copytree(os.path.join(out1, "step_00000002"),
                    os.path.join(out2, "step_00000002"))
    resumed = launch.spawn_ranks(parallel_train_rank, 2, backend="gloo",
                                 device=device, args=(dict(
                                     train_model=train_model, out=out2,
                                     resume=True),), timeout_s=600)[0]
    train = {"wall_s": time.perf_counter() - t0, "resume": resumed,
             "losses_uninterrupted": tr["losses"]}
    for name in ("tp2", "dp2"):
        r = tr[name]
        gaps = [{k: abs(a[k] - b[k]) / max(abs(a[k]), abs(b[k]), 1e-30)
                 for k in b} for a, b in zip(r["metrics"],
                                             r["single_metrics"])]
        r["rel_gap"] = gaps
        train[name] = r
        for i, g in enumerate(gaps):
            for k, v in g.items():
                rtol = (TRAIN_PARITY_LOSS_RTOL if k != "grad_norm"
                        else TRAIN_PARITY_RTOL if i < 2
                        else TRAIN_PARITY_RTOL_UPDATED)
                if v > rtol:
                    raise AssertionError(
                        f"{name} train step {i + 1} {k}: mesh "
                        f"{r['metrics'][i][k]} single "
                        f"{r['single_metrics'][i][k]} ({v:.3g} > {rtol})")
        if r["over_limit"] or r["elements_beyond_1e-6"] > 1e-3 * r[
                "elements"]:
            raise AssertionError(f"{name} train parameters: "
                                 f"{r['over_limit'][:3]}, "
                                 f"{r['elements_beyond_1e-6']} of "
                                 f"{r['elements']} beyond 1e-6")
        log(f"parallel: {name} train, 3 f32 steps (depth 2/1/1) against "
            f"the single-device step: loss and grad-norm gaps per step "
            + "; ".join(f"loss {g['loss/total']:.2g} norm "
                        f"{g['grad_norm']:.2g}" for g in gaps)
            + f"; max |d param| {r['max_abs_param_diff']:.3g}, "
            f"{r['elements_beyond_1e-6']} of {r['elements']} beyond 1e-6; "
            f"{r['seconds']:.2f}s (single {r['single_seconds']:.2f}s)")
    if not resumed["restored_bit_equal"] or resumed["resumed_step"] != 2:
        raise AssertionError(f"mesh snapshot restore: {resumed}")
    import numpy as np

    if not np.allclose(resumed["losses"], tr["losses"][2:],
                       rtol=TRAIN_RESUME_RTOL, atol=0):
        raise AssertionError(f"resumed losses {resumed['losses']} vs "
                             f"{tr['losses'][2:]}")
    log(f"parallel: tp=2 snapshot of step 2 restored on a fresh launch "
        f"bit-equal; step 3 loss {resumed['losses']} vs uninterrupted "
        f"{tr['losses'][2:]}")
    rep["train"] = train
    rep["wall_s"] = time.perf_counter() - t_phase
    log(f"parallel: phase {rep['wall_s']:.1f}s")
    return tp_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vilbert_multitask_tpu_torch import _build
    from vilbert_multitask_tpu_torch.config import ViLBertConfig

    report: dict = {}
    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    report["device"] = {"kind": kind, "nvidia_smi": smi,
                        "count": torch.cuda.device_count(),
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    report["device"]["pil"] = PIL_VERSION
    log(f"device: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | PIL {PIL_VERSION or 'not installed'}")
    # 2. build
    sources = sorted(f[:-3] for f in os.listdir(_build.SOURCE_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {sources} in {report['build_s']:.1f}s")
    report["build_notes"] = {}
    smem = _build.load("flash_attn").vmt_flash_attn_bf16_smem_bytes()
    for name in sources:
        notes = kernel_build_notes(_build, name)
        for rec in notes:
            if "flash_attn_bf16" in rec["kernel"]:
                rec["smem_dynamic_bytes"] = smem
            log(f"  {name}: {json.dumps(rec)}")
        report["build_notes"][name] = notes
        check_build_notes(notes)
    # 3. kernels against their plain versions
    by_shape = check_flash_attention(torch, report)
    nms_rows = check_nms(torch, report)
    roi_row = check_roi_align(torch, report)
    int8_rows = check_int8_linear(torch, report, ViLBertConfig())
    # detect: the full-width detector on seeded images
    detect_launches = check_detect(torch, report)
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as state:
        # 4. main path (predict, eager)
        eng = main_path(torch, report, root)
        # 5. one CUDA graph per bucket
        check_graphs(torch, report, eng)
        # 6. run_many
        batched_launches = check_batched(torch, report, eng)
        # int8: the int8 storage mode's main path; cli: its entry points
        int8_launches = check_int8(torch, report, eng, root, state)
        check_cli_entry_points(torch, report, eng, root, state)
        # boot: the kernel-library cache, its prewarm CLI, cold and warm
        # server boots
        check_boot(torch, report, root, state)
        # 7. the served path
        served_launches, served_detector = check_served(torch, report, eng,
                                                        root, state)
        # 8. the server's entry point and the remote worker, each in a
        # process of its own
        check_entry_point(report, root, state)
        check_remote_worker(torch, report, eng, root, state)
        # train: card against CPU, then the training path at full width
        check_train_parity(torch, report)
        check_train(torch, report, root, state)
        check_fixed_batch_training(torch, report)
        # parallel: the mesh on NCCL (world 1) and two ranks on this card
        tp_launches = check_parallel(torch, report, root, state)
    # 9. the kernels line: per-shape numbers summed over the 18 launches of
    # one bucket-1 forward (6 x 38x101, 6 x 101x38, 6 x 101x101).
    fwd = [by_shape[(1, 38, 101)], by_shape[(1, 101, 38)],
           by_shape[(1, 101, 101)]]
    total = lambda key: 6 * sum(r[key] for r in fwd)  # noqa: E731
    bound = total("bound_ms")
    # A tp = 2 rank's bucket-1 forward: the same 18 launches on 4 heads.
    shard = {(r["B"], r["Nq"], r["Nk"]): r
             for r in report["flash_attn_shapes"] if r["what"] == "tp=2 shard"}
    shard_fwd = [shard[(1, 38, 101)], shard[(1, 101, 38)],
                 shard[(1, 101, 101)]]
    kernels = {"kernels": [{
        "name": "flash_attn",
        "route": "cuda",
        "source": "vilbert_multitask_tpu_torch/csrc/flash_attn.cu",
        "replaces": "vilbert_multitask_tpu/ops/coattention.py:38",
        "launches": served_launches,
        "launches_by_path": {"predict": report["main_path_launches"],
                             "run_many": batched_launches,
                             "served": served_launches,
                             "per_graph_replay": report["graphs"][
                                 "replay_flash_launches_bucket1"],
                             "train_steps": report["train"][
                                 "flash_launches_train"],
                             "eval_hook_forward": report["train"][
                                 "eval_flash_launches"],
                             "tp_rank_forward": tp_launches["flash_attn"]},
        "max_abs_err": max(r["max_abs_err_f32"]
                           for r in report["flash_attn_shapes"]),
        "max_abs_err_bf16": max(r["max_abs_err_bf16"]
                                for r in report["flash_attn_shapes"]),
        "ms": total("kernel_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": bound,
        "bound_by": fwd[0]["bound_by"],
        "library_ms": total("library_ms"),
        "per": "one bucket-1 forward: 18 bf16 launches",
        "notes": {
            "instantiations": report["build_notes"]["flash_attn"],
            "max_tol_used_bf16": max(r["tol_used_bf16"]
                                     for r in report["flash_attn_shapes"]),
            "tp2_rank_forward": {
                key: 6 * sum(r[key] for r in shard_fwd)
                for key in ("kernel_ms", "plain_ms", "bound_ms",
                            "library_ms")},
            "tp2_shard_shapes": [
                {k: r[k] for k in ("B", "Nq", "Nk", "H", "D",
                                   "max_abs_err_f32", "max_abs_err_bf16",
                                   "tol_used_bf16", "kernel_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")}
                for r in shard.values()],
        },
    }, {
        "name": "nms",
        "route": "cuda",
        "source": "vilbert_multitask_tpu_torch/csrc/nms.cu",
        "replaces": "vilbert_multitask_tpu/ops/nms.py:37 (XLA, no Pallas "
                    "kernel)",
        "launches": served_detector["nms"],
        "launches_by_path": {"detect": detect_launches["nms"],
                             "served": served_detector["nms"],
                             "per_image": NMS_PER_IMAGE},
        "max_abs_err": max(r["mismatches"] for r in report["nms_cases"]),
        "ms": sum(r["kernel_ms"] for r in nms_rows.values()),
        "plain_ms": sum(r["plain_ms"] for r in nms_rows.values()),
        "bound_ms": sum(r["bound_ms"] for r in nms_rows.values()),
        "bound_by": max(nms_rows.values(),
                        key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "per": "one image: the RPN call (5 levels x 1000) and the "
               "selection call (1600 classes x 300 boxes)",
        "notes": {"instantiations": report["build_notes"]["nms"],
                  "shapes": nms_rows},
    }, {
        "name": "roi_align",
        "route": "cuda",
        "source": "vilbert_multitask_tpu_torch/csrc/roi_align.cu",
        "replaces": "vilbert_multitask_tpu/detect/model.py:185 (XLA, no "
                    "Pallas kernel)",
        "launches": served_detector["roi_align"],
        "launches_by_path": {"detect": detect_launches["roi_align"],
                             "served": served_detector["roi_align"],
                             "per_image": ROI_PER_IMAGE},
        "max_abs_err": max(r["max_abs_err"]
                           for r in report["roi_align_cases"]),
        "ms": roi_row["kernel_ms"],
        "plain_ms": roi_row["plain_ms"],
        "bound_ms": roi_row["bound_ms"],
        "bound_by": roi_row["bound_by"],
        "library_ms": None,
        "per": "one image: 300 proposals over P2..P5, 7x7 bins, 256 "
               "channels",
        "notes": {"instantiations": report["build_notes"]["roi_align"]},
    }]}
    def per_forward(rows: int, key: str) -> float:
        """A column of the int8_linear rows summed over the launches of one
        forward of ``rows`` image rows."""
        return sum(n * int8_rows[(M, N, K, b)][key] for M, N, K, b, n, _ in
                   int8_forward_shapes(ViLBertConfig(), rows))

    kernels["kernels"].append({
        "name": "int8_linear",
        "route": "cuda",
        "source": "vilbert_multitask_tpu_torch/csrc/int8_linear.cu",
        "replaces": "vilbert_multitask_tpu/quant.py:94 (dequantize_leaf, "
                    "fused by XLA into each matmul: engine/runtime.py:"
                    "684-705; no Pallas kernel)",
        "launches": int8_launches["int8_linear"],
        "launches_by_path": {
            "int8_predict": int8_launches["int8_linear"],
            "per_forward_bucket_1": int8_launches_per_forward(
                ViLBertConfig(), 1),
            "per_forward_bucket_32": int8_launches_per_forward(
                ViLBertConfig(), 32),
            "tp_rank_per_request": tp_launches["int8_linear"]},
        "max_abs_err": max(r["max_abs_err_f32"]
                           for r in report["int8_linear_shapes"]),
        "max_abs_err_bf16": max(r["max_abs_err_bf16"]
                                for r in report["int8_linear_shapes"]),
        "ms": per_forward(1, "kernel_ms"),
        "plain_ms": per_forward(1, "plain_ms"),
        "bound_ms": per_forward(1, "bound_ms"),
        "bound_by": ("bytes" if per_forward(1, "bound_bytes_ms")
                     >= per_forward(1, "bound_ops_ms") else "operations"),
        "library_ms": per_forward(1, "library_ms"),
        "ms_cold_l2": per_forward(1, "kernel_cold_ms"),
        "library_ms_cold_l2": per_forward(1, "library_cold_ms"),
        "per": "one bucket-1 forward: 189 bf16 launches (184 trunk Linear, "
               "5 head products); library = F.linear on the dequantized "
               "bf16 weights; *_cold_l2: the weights rotated through copies "
               "larger than the L2",
        "notes": {
            "instantiations": report["build_notes"]["int8_linear"],
            "bucket_32": {k: per_forward(32, f"{k}_ms") for k in
                          ("kernel", "plain", "bound", "library",
                           "kernel_cold", "library_cold")},
            "plans": {f"{M}x{N}x{K}x{b}": int8_rows[(M, N, K, b)]["plan"]
                      for rows in (1, 32) for M, N, K, b, _, _ in
                      int8_forward_shapes(ViLBertConfig(), rows)},
            "max_tol_used_bf16": max(r["tol_used_bf16"]
                                     for r in report["int8_linear_shapes"]),
            "int8pack_mm_on_cuda": report["int8pack_mm_on_cuda"],
            "tp2_sliced_shapes": report["parallel"]["gloo"]["tp2_int8"][
                "shapes"],
            "tp2_sliced_tol_used_bf16_by_rank": report["parallel"]["gloo"][
                "tp2_int8"]["tol_used_bf16_by_rank"],
            "tp2_bucket1_trunk_forward": report["parallel"]["gloo"][
                "tp2_int8"]["bucket1_trunk_forward"],
        },
    })
    report.update(kernels)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
