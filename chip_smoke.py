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
   kernel tolerance) and bf16; ``nms`` keep masks identical at the RPN
   (5 x 1000) and selection (1600 x 300) shapes, N off the 64-box words,
   ragged groups, identical, disjoint and tied boxes and IoUs exactly at
   the threshold; ``roi_align`` within atol 1e-5 + rtol 1e-5 at 300
   proposals over the 1344-canvas P2..P5 maps, boxes on level boundaries,
   off the canvas, of zero area, and each level alone; ``int8_linear`` in
   bf16 (atol 1e-2 + rtol 1e-2) and f32 (2e-5 x max(1, |ref|)) at every
   (N, K) of the full-width forward at M = 38·{1, 32} and 101·{1, 32}, at
   the shapes of a bucket-1 and a bucket-32 forward, at the edges (M = 1,
   15, 17; N = 1, 3, 4, 3129; K = 5 and 37, the element-wise x path; K off
   the 64-deep tiles) and on strided x; per serving shape,
   the kernel's device time (calls captured in a CUDA graph, replays timed
   by CUDA events, median), the plain version's, the yardstick library
   call's where one exists (``scaled_dot_product_attention``; ``F.linear``
   on the pre-dequantized bf16 weight for ``int8_linear``, and
   ``aten._weight_int8pack_mm`` where this PyTorch runs it on CUDA; never
   called by the port; none computes NMS or this ROIAlign), the same as eager
   back-to-back calls (host launch cost included), and the least time the
   card could take (``bound_ms``);
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
   f32 checkpoint re-quantizes it to the same tensors and answers;
cli. ``python -m vilbert_multitask_tpu_torch.evals.harness --task vqa``
   on seeded data over phase 4's feature files prints the in-process
   Evaluator's scores on phase 4's engine, and ``python -m
   vilbert_multitask_tpu_torch.checkpoint.onboard`` on a seeded
   upstream-layout ``.bin`` exits 0 holding that score, each in its own
   process on the card;
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
            cur["sass"] = dict.fromkeys(("HMMA", "LDGSTS", "LDSM"), 0)
        elif cur is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
            if m and m.group(1) in cur["sass"]:
                cur["sass"][m.group(1)] += 1
    out = []
    for mangled, rec in sorted(notes.items()):
        m = re.search(r"(flash_attn_(?:bf16|f32)_kernel|nms_mask_kernel|"
                      r"nms_scan_kernel|roi_align_kernel|"
                      r"int8_linear_(?:bf16|f32)_kernel)(?:IL[ib](\d+)E)?",
                      mangled)
        rec["kernel"] = (m.group(1) + (f"<{m.group(2)}>" if m.group(2)
                                       else "")) if m else mangled
        out.append(rec)
    return out


def check_build_notes(notes: list) -> None:
    for rec in notes:
        if rec.get("spill_store_bytes", 0) or rec.get("spill_load_bytes", 0):
            raise AssertionError(f"{rec['kernel']} spills: {rec}")
        sass = rec.get("sass", {})
        if "bf16" in rec["kernel"] and not (sass.get("HMMA")
                                            and sass.get("LDGSTS")):
            raise AssertionError(f"{rec['kernel']} has no mma.sync or no "
                                 f"cp.async in its SASS: {sass}")


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
    for B, Nq, Nk, H, D, keep, q_scale, what in SERVING + EDGES:
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
    sel_boxes = _boxes_in(torch, gen, (300,))
    logits = 2.0 * torch.randn(300, 1601, generator=gen)
    sel_scores = torch.softmax(logits, dim=1)[:, 1:].t()  # (1600, 300) view
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
    out = []
    for what, boxes, scores, thresh, valid, want in cases:
        v = None if valid is None else torch.tensor(valid).to(dev)
        out.append((what, boxes.to(dev), scores.to(dev), thresh, v, want))
    return out


def nms_bound_ms(torch, boxes, scores, keep, valid) -> tuple:
    """Least time for one NMS call: boxes and scores read once, the keep
    mask written once, against 13 f32 operations per IoU the greedy walk
    needs (each box against each box kept before it: this run's count)."""
    G, N = scores.shape
    unique_boxes = N if boxes.stride(0) == 0 else G * N
    n_bytes = unique_boxes * 16 + G * N * 4 + G * N
    n_valid = (torch.full((G,), N, device=scores.device) if valid is None
               else valid)
    pad = torch.arange(N, device=scores.device)[None] >= n_valid[:, None]
    order = torch.sort(scores.masked_fill(pad, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    ks = keep.gather(1, order).to(torch.int64)
    before = (torch.cumsum(ks, dim=1) - ks).masked_fill(pad, 0)
    flops = NMS_IOU_OPS * int(before.sum().item())
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
    for what, boxes, scores, thresh, valid, want in nms_cases(torch, dev):
        got = nm.nms_mask(boxes, scores, thresh, valid=valid)
        ref = nm.nms_mask_plain(boxes, scores, thresh, valid=valid)
        torch.cuda.synchronize()
        wrong = int((got != ref).sum().item())
        kept = int(got.sum().item())
        row = dict(what=what, G=scores.shape[0], N=scores.shape[1],
                   thresh=thresh, kept=kept, mismatches=wrong)
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
        log("nms %s: G=%d N=%d thresh %.2f kept %d, %d mismatches vs plain%s"
            % (what, row["G"], row["N"], thresh, kept, wrong,
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


def roi_cases(torch, dev):
    """(what, boxes): the serving shape (300 proposals over every level)
    first, then the edges."""
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
    cases = [("serving: 300 proposals over P2..P5", serving),
             ("level boundaries, off the canvas edge, zero area", edges)]
    for level, (lo, hi) in enumerate(((8, 100), (120, 200), (240, 420),
                                      (460, 1300))):
        side = lo + torch.rand(64, 1, generator=gen) * (hi - lo)
        xy = torch.rand(64, 2, generator=gen) * 1000.0
        cases.append((f"P{level + 2} alone (64 boxes)",
                      torch.cat([xy, xy + side], dim=1)))
    return [(what, b.to(dev)) for what, b in cases]


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
    _, views = roi_maps(torch, dev)
    strides = dm.FPN_STRIDES[:4]
    res, sampling = 7, 2
    rows = []
    for what, boxes in roi_cases(torch, dev):
        got = dm.roi_align(views, boxes, strides, res, sampling)
        ref = dm.roi_align_plain(views, boxes, strides, res, sampling)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        used = (err / (ROI_ATOL + ROI_RTOL * ref.abs())).max().item()
        levels = torch.bincount(dm.fpn_level(boxes), minlength=4).tolist()
        row = dict(what=what, R=boxes.shape[0], levels=levels,
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
        log("roi_align %s: R=%d per level %s, max abs err %.3e (%.3f of "
            "atol 1e-5 + rtol 1e-5)%s" % (
                what, row["R"], levels, row["max_abs_err"], used,
                "" if "kernel_ms" not in row else
                " | kernel_ms=%.5f (eager call %.5f) plain_ms=%.5f "
                "bound_ms=%.6f (%s)" % (row["kernel_ms"],
                                        row["kernel_call_ms"],
                                        row["plain_ms"], row["bound_ms"],
                                        row["bound_by"])))
        if not used <= 1.0:
            raise AssertionError(f"roi_align kernel error {err.max().item():.3e}"
                                 f" beyond atol 1e-5 + rtol 1e-5 ({what})")
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


def int8_bound_parts(M, N, K, batch, itemsize) -> tuple:
    """(ms to move the bytes, ms for the operations) of one call: q once
    (int8), the scales (f32) and bias once, x read once and y written once,
    over the HBM rate; 2·M·N·K operations at the bf16 tensor-core peak
    (itemsize 2) or the f32 CUDA-core peak."""
    n_bytes = batch * (N * K + 4 * N + itemsize * N + itemsize * M * K
                       + itemsize * M * N)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    return (n_bytes / PEAK_BYTES_PER_S * 1e3,
            2 * M * N * K * batch / peak * 1e3)


def check_int8_linear(torch, report: dict, mcfg) -> dict:
    """K1 against its plain version on the card: bf16 within atol 1e-2 +
    rtol 1e-2, f32 within 2e-5 x max(1, |ref|), at every (N, K) of the
    full-width forward at M = 38·{1, 32} and 101·{1, 32}, at the shapes of
    a bucket-1 and a bucket-32 forward, and at the edges; a strided x (the
    poolers' first token, the label pair's head axis). Per timed shape the
    kernel's device time, the plain version's, ``F.linear`` on the
    pre-dequantized bf16 weight (cuBLAS reading twice the weight bytes:
    the bf16 engine's own product) and ``aten._weight_int8pack_mm`` where
    this PyTorch runs it on CUDA, and the bound. Returns {(M, N, K, batch):
    row} of the timed shapes."""
    import torch.nn.functional as F

    from vilbert_multitask_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_plain,
    )

    gen = torch.Generator(device="cpu").manual_seed(0)
    timed = {}
    for rows in (1, 32):
        for M, N, K, batch, _, what in int8_forward_shapes(mcfg, rows):
            timed.setdefault((M, N, K, batch), f"{what}, bucket {rows}")
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
    for i, (M, N, K, batch, what, time_it) in enumerate(cases):
        round_scale = i % 2 == 0
        x16, q, s, b16 = int8_operands(torch, gen, M, N, K, batch,
                                       torch.bfloat16, round_scale)
        x32, b32 = x16.float(), b16.float()
        ref16 = int8_linear_plain(x16, q, s, b16).float()
        out16 = int8_linear(x16, q, s, b16).float()
        ref32 = int8_linear_plain(x32, q, s, b32)
        out32 = int8_linear(x32, q, s, b32)
        torch.cuda.synchronize()
        err16, used16 = bf16_check(out16, ref16)
        d32 = (out32 - ref32).abs()
        err32 = d32.max().item()
        used32 = (d32 / (F32_TOL * ref32.abs().clamp_min(1.0))).max().item()
        row = dict(M=M, N=N, K=K, batch=batch, what=what,
                   scale_rounded_to_bf16=round_scale,
                   max_abs_err_bf16=err16, tol_used_bf16=used16,
                   bit_equal_bf16=bool(err16 == 0.0),
                   max_abs_err_f32=err32, tol_used_f32=used32)
        if time_it:
            w16 = (q.float() * s.unsqueeze(-1)).to(torch.bfloat16)
            fns = dict(
                kernel=lambda: int8_linear(x16, q, s, b16),
                plain=lambda: int8_linear_plain(x16, q, s, b16),
                library=lambda: torch.baddbmm(
                    b16.unsqueeze(-2), x16, w16.transpose(-1, -2))
                if batch > 1 else F.linear(x16, w16, b16))
            if (pack_mm is not None and batch == 1 and K % 32 == 0
                    and N % 8 == 0 and pack_mm_ok is not False):
                s16 = s.to(torch.bfloat16)
                qc = q.contiguous()
                try:  # a yardstick only: the port never calls it
                    pack_mm(x16, qc, s16)
                    torch.cuda.synchronize()
                    pack_mm_ok = True
                except (RuntimeError, NotImplementedError) as e:
                    pack_mm_ok = False
                    report["int8pack_mm_error"] = str(e)[:300]
                if pack_mm_ok:
                    fns["int8pack_mm"] = lambda: pack_mm(x16, qc, s16)
            for name, fn in fns.items():
                row[f"{name}_ms"] = device_ms(fn, reps=9, inner=5)
            row["kernel_f32_ms"] = device_ms(
                lambda: int8_linear(x32, q, s, b32), reps=5, inner=2)
            row["bound_bytes_ms"], row["bound_ops_ms"] = int8_bound_parts(
                M, N, K, batch, 2)
            row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
            row["bound_by"] = ("bytes" if row["bound_bytes_ms"]
                               >= row["bound_ops_ms"] else "operations")
            by_shape[(M, N, K, batch)] = row
        rows_out.append(row)
        log("int8_linear M=%d N=%d K=%d batch=%d (%s): err_bf16=%.3e (%.2f "
            "of tol%s) err_f32=%.3e (%.2f of tol)%s" % (
                M, N, K, batch, what, err16, used16,
                ", bit-equal" if err16 == 0.0 else "", err32, used32,
                "" if not time_it else
                " | kernel_ms=%.5f plain_ms=%.5f library_ms=%.5f%s "
                "f32_kernel_ms=%.5f bound_ms=%.6f (%s)" % (
                    row["kernel_ms"], row["plain_ms"], row["library_ms"],
                    " int8pack_mm_ms=%.5f" % row["int8pack_mm_ms"]
                    if "int8pack_mm_ms" in row else "",
                    row["kernel_f32_ms"], row["bound_ms"], row["bound_by"])))
        if not used16 <= 1.0:
            raise AssertionError(
                f"int8_linear bf16 error {err16:.3e} beyond atol {BF16_ATOL}"
                f" + rtol {BF16_RTOL} at {(M, N, K, batch)} ({what})")
        if not used32 <= 1.0:
            raise AssertionError(
                f"int8_linear f32 error {err32:.3e} beyond {F32_TOL} x "
                f"max(1, |ref|) at {(M, N, K, batch)} ({what})")
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
        r"nms_mask_kernel|nms_scan_kernel|roi_align_kernel", k)}
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
    sort orders them, not the model (see ``same_top1``)."""
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


def same_top1(got: dict, want: dict, what: str) -> str:
    """The criterion for a row decoded from another batch than ``want``'s
    (a batched bf16 row rounds otherwise): the first answer, box or ranked
    image identical, and the k-th confidence and score within
    ``BATCHED_ROW``. Where either side's first entries tie exactly (the same
    confidence and score: bf16 logits often do with random weights), the
    order inside the tie is the sort's, not the model's, so the entries
    tied first on one side must include the other side's first. Returns ""
    when the whole order is identical too, else both orders with their
    confidences (a swap of near-tied labels)."""
    import numpy as np

    items = {"labels": "answers", "binary": "answers", "trinary": "answers",
             "grounding": "boxes", "ranking": "ranking"}[want["kind"]]
    key = {"answers": "answer", "boxes": "region_index",
           "ranking": "image"}[items]
    g, w = got[items], want[items]

    def tied_first(xs: list) -> set:
        rank = [f for f in ("confidence", "score") if f in xs[0]]
        return {x[key] for x in xs
                if rank and all(x[f] == xs[0][f] for f in rank)} | {
                    xs[0][key]}

    if len(g) != len(w) or (g[0][key] not in tied_first(w)
                            and w[0][key] not in tied_first(g)):
        raise AssertionError(f"{what}: top-1 {g[:1]} vs {w[:1]} (served "
                             f"{g}, predict() {w})")
    for field in ("confidence", "score"):
        if field in w[0]:
            np.testing.assert_allclose(
                [x[field] for x in g], [x[field] for x in w],
                err_msg=f"{what}: {field} by rank", **BATCHED_ROW)
    if [x[key] for x in g] == [x[key] for x in w]:
        return ""
    pairs = lambda xs: [(x[key], x.get("confidence")) for x in xs]  # noqa
    return f"{what}: served {pairs(g)} vs predict() {pairs(w)}"


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
    batches it: held to ``same_top1`` against predict()), then scale-out
    under load: 2 clients keep posting VQA submits while a second replica
    is built and captures its graphs beside the first, which goes on
    serving (``check_scale_out``). Every batch the scheduler dispatched is
    replayed through ``run_many`` afterwards and must come out identical.

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
    swaps, drift, gap = [], 0.0, math.inf
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
            swap = same_top1(got, want, what)
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
        f"and scale-out) with top-1 equal to predict() (within an exact tie) and confidences "
        f"within rtol {BATCHED_ROW['rtol']} / atol {BATCHED_ROW['atol']}, "
        f"{batched - len(swaps)} in the same order (largest confidence "
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
        # 7. the served path
        served_launches, served_detector = check_served(torch, report, eng,
                                                        root, state)
        # 8. the server's entry point, in a process of its own
        check_entry_point(report, root, state)
    # 9. the kernels line: per-shape numbers summed over the 18 launches of
    # one bucket-1 forward (6 x 38x101, 6 x 101x38, 6 x 101x101).
    fwd = [by_shape[(1, 38, 101)], by_shape[(1, 101, 38)],
           by_shape[(1, 101, 101)]]
    total = lambda key: 6 * sum(r[key] for r in fwd)  # noqa: E731
    bound = total("bound_ms")
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
                                 "replay_flash_launches_bucket1"]},
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
                ViLBertConfig(), 32)},
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
        "per": "one bucket-1 forward: 189 bf16 launches (184 trunk Linear, "
               "5 head products); library = F.linear on the dequantized "
               "bf16 weights",
        "notes": {
            "instantiations": report["build_notes"]["int8_linear"],
            "bucket_32": {k: per_forward(32, f"{k}_ms") for k in
                          ("kernel", "plain", "bound", "library")},
            "max_tol_used_bf16": max(r["tol_used_bf16"]
                                     for r in report["int8_linear_shapes"]),
            "int8pack_mm_on_cuda": report["int8pack_mm_on_cuda"],
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
