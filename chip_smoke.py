#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc; without a CUDA device it exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.

Phases (any failure exits non-zero; nothing is caught and carried on):

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the port from ``vilbert_multitask_tpu_torch/csrc``,
   one nvcc per source, all started together; per kernel instantiation, the
   registers, shared memory and spills ptxas reports (any spill fails) and
   the count of tensor-core (``HMMA``), async-copy (``LDGSTS``) and
   ``ldmatrix`` (``LDSM``) instructions in its SASS (a bf16 kernel without
   the first two fails);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes and at the edges of its tiles, widths and masks, in
   f32 (max abs error <= 2e-5, the JAX package's own kernel tolerance) and
   bf16; per shape, the kernel's device time (calls captured in a CUDA
   graph, replays timed by CUDA events, median), the plain version's, the
   yardstick library call's (``scaled_dot_product_attention``, never called
   by the port), the same as eager back-to-back calls (host launch cost
   included), and the least time the card could take (``bound_ms``);
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
7. served: ``ServeApp`` on the same engine (``http_port=0``): the six
   decode families and 8 VQA submits posted over HTTP one at a time (each
   its own forward: every answer equal to ``predict()`` on the same
   engine, the same labels, numbers within rtol 0.1 / atol 0.05), then a
   burst of 32 VQA submits over 8 images from 8 clients at once (batched
   by the scheduler: against ``predict()``, the same top-1 and the k-th
   confidence within rtol 0.1 / atol 1e-3); then scale-out under load: two
   clients keep posting VQA submits while ``ReplicaPool.add_replica``
   builds a second full-width replica and captures its 7 graphs, and the
   first replica must serve batches during those captures, with no
   failure, no failover and every answer held as the burst's; exactly one
   terminal push frame and one ``ResultStore`` row per submit; every batch
   the scheduler dispatched, replayed through ``run_many`` on the replica
   that served it, must give results identical to the served ones; a clean
   stop within 30 s;
8. entry point: ``python -m vilbert_multitask_tpu_torch.serve.app
   --features <dir> --http-port 0 --ws-port 0`` (ports the system picks,
   read from its ``http://`` line) in its own process boots on the card,
   captures its
   graphs, reports ready on ``/healthz``, stores an answer to one submit,
   and exits 0 on SIGTERM (the process is killed if anything fails);
9. a ``{"kernels": [...]}`` line, the card's nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Kernel launch counts are read per path: each is zeroed just before the
path runs and read just after (phase 4's ``predict``, phase 6's
``run_many``, phase 7's served submits); a path that launched the kernel
no time fails. Graph replays count the launches their capture recorded
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
        m = re.search(r"flash_attn_(?:bf16|f32)_kernel", mangled)
        rec["kernel"] = m.group(0) if m else mangled
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
            if r.spec.decode == "labels" and top1(got, 0) != top1(want, 0):
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
    ``BATCHED_ROW``. Returns "" when the whole order is identical too, else
    both orders with their confidences (a swap of near-tied labels)."""
    import numpy as np

    items = {"labels": "answers", "binary": "answers", "trinary": "answers",
             "grounding": "boxes", "ranking": "ranking"}[want["kind"]]
    key = {"answers": "answer", "boxes": "region_index",
           "ranking": "image"}[items]
    g, w = got[items], want[items]
    if len(g) != len(w) or g[0][key] != w[0][key]:
        raise AssertionError(f"{what}: top-1 {g[:1]} vs {w[:1]}")
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


def check_served(torch, report: dict, eng, root: str, state: str) -> int:
    """ServeApp on the engine: HTTP submits → queue → scheduler → worker
    → engine → result store + push hub. First 14 submits one at a time
    (each its own forward, at predict()'s bucket: answers must equal
    predict()'s), then a burst of 32 from 8 clients at once (the scheduler
    batches it: held to ``same_top1`` against predict()), then scale-out
    under load: 2 clients keep posting VQA submits while a second replica
    is built and captures its graphs beside the first, which goes on
    serving (``check_scale_out``). Every batch the scheduler dispatched is
    replayed through ``run_many`` afterwards and must come out identical.
    Returns the kernel launches of the solo and burst submits."""
    import dataclasses
    import http.client
    import queue as queue_mod
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
    )
    from vilbert_multitask_tpu_torch.serve.app import ServeApp

    serving = dataclasses.replace(
        eng.cfg.serving, queue_db_path=os.path.join(state, "q.sqlite3"),
        results_db_path=os.path.join(state, "r.sqlite3"),
        media_root=os.path.join(state, "media"), http_port=0, ws_port=0)
    cfg = dataclasses.replace(eng.cfg, serving=serving)
    solo = list(SERVED_FAMILIES) + [
        (1, f"what is on the left {k}", [f"img_{k}"]) for k in range(8)]
    burst = [(1, f"what is in this picture {k}", [f"img_{k % 8}"])
             for k in range(32)]
    load = [(1, f"what is happening here {k}", [f"img_{k % 8}"])
            for k in range(SCALE_OUT_MAX_SUBMITS)]
    jobs = solo + burst + load
    calls: list = []
    record_run_many(eng, calls)
    t0 = time.perf_counter()
    app = ServeApp(cfg, engine=eng, feature_root=root)
    app.warm()  # the graphs are captured already: nothing to do
    app.start()
    boot_s = time.perf_counter() - t0
    subs = {i: app.hub.subscribe(f"sock{i}") for i in range(len(jobs))}
    frames = {i: [] for i in range(len(jobs))}

    def post(conn, i) -> None:
        task_id, question, images = jobs[i]
        conn.request("POST", "/", body=json.dumps({
            "task_id": task_id, "socket_id": f"sock{i}",
            "question": question,
            "image_list": [f"{n}.jpg" for n in images]}),
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

    flash_cross_attention.launches = 0
    try:
        t_solo = time.perf_counter()
        for i in range(len(solo)):
            submit([i])
            drain(lambda i=i: bool(frames[i]), 60.0)
        solo_s = time.perf_counter() - t_solo
        solo_launches = flash_cross_attention.launches
        t_burst = time.perf_counter()
        ids = list(range(len(solo), len(solo) + len(burst)))
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(submit, [ids[k::8] for k in range(8)]))
        drain(lambda: all(frames[i] for i in ids), 120.0)
        makespan = time.perf_counter() - t_burst
        drain(lambda: True, 1.0, grace_s=0.5)  # any duplicate, any submit
        torch.cuda.synchronize()
        launches = flash_cross_attention.launches
        posted = check_scale_out(report, app, eng, calls, post, drain,
                                 frames, range(len(solo) + len(burst),
                                               len(jobs)))
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
    sent = list(range(len(solo) + len(burst))) + posted
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
        want = eng.predict(task_id, question,
                           [f"{n}.jpg" for n in images]).to_json()
        got = {k: v for k, v in frame["result"].items() if k in want}
        what = f"submit {i} (task {task_id})"
        if i < len(solo):
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
    replayed = replay_calls(calls)
    if replayed != len(sent):
        raise AssertionError(f"{replayed} served results replayed for "
                             f"{len(sent)} submits")
    solo_forwards = solo_launches // LAUNCHES_PER_FORWARD
    burst_forwards = (launches - solo_launches) // LAUNCHES_PER_FORWARD
    if launches % LAUNCHES_PER_FORWARD or solo_forwards != len(solo) \
            or burst_forwards < 1:
        raise AssertionError(f"served path: {launches} kernel launches "
                             f"({solo_launches} for {len(solo)} solo "
                             f"submits)")
    if stop_s > 30.0 or any(t.name == "serve-worker"
                            for t in threading.enumerate()):
        raise AssertionError(f"ServeApp.stop took {stop_s:.1f}s or left "
                             f"its worker running")
    batched = len(sent) - len(solo)
    log(f"served: {len(sent)} submits over HTTP, one terminal frame and one "
        f"ResultStore row each; {len(solo)} one at a time in {solo_s:.3f}s "
        f"({solo_forwards} forwards), answers equal to predict(); a burst "
        f"of {len(burst)} from 8 clients in {makespan:.3f}s "
        f"({burst_forwards} forwards); {batched} batched submits (burst "
        f"and scale-out) with top-1 equal to predict() and confidences "
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
        "stop_s": stop_s, "healthz_ok": health.get("ok")}
    return launches


def check_scale_out(report: dict, app, eng, calls: list, post, drain,
                    frames: dict, ids) -> list:
    """Scale-out under load: two clients post VQA submits (one every
    ~8 ms each) from ``ids`` while the pool gains a second replica — a
    full-width engine on the same weights, built, then warmed by
    ``ReplicaPool.add_replica(warm=True)`` (the autoscaler's actuator),
    which captures its 7 bucket graphs — and the first replica goes on
    serving meanwhile. The first replica must dispatch during the
    captures, the new one must come up ready and serve, no dispatch may
    fail, and every submit gets its answer. Returns the posted ids."""
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

    clients = [threading.Thread(target=client, name=f"load-{k}")
               for k in range(2)]
    graphs_mod.capture = timed_capture
    try:
        for t in clients:
            t.start()
        drain(lambda: sum(bool(frames[i]) for i in list(posted)) >= 8, 60.0)
        t0 = time.perf_counter()
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
    capture_s = sum(w1 - w0 for w0, w1 in windows)
    log(f"scale-out under load: {len(posted)} VQA submits from 2 clients; "
        f"replica r1 built in {build_s:.2f}s and warmed by add_replica in "
        f"{add_s - build_s:.2f}s ({len(windows)} graph captures, "
        f"{capture_s:.3f}s in "
        f"all), while r0 served {during} batches that overlapped a "
        f"capture; r1 then served {after} batches; no failure, no "
        f"failover, breakers closed ({[r['name'] for r in info]})")
    report["scale_out"] = {
        "submits": len(posted), "build_s": build_s,
        "warm_s": add_s - build_s, "capture_s": capture_s,
        "r0_batches_during_capture": during, "r1_batches": after,
        "replicas": info}
    return posted


# ---------------------------------------------------------------- phase 8
def check_entry_point(report: dict, root: str, state: str) -> None:
    """``python -m vilbert_multitask_tpu_torch.serve.app --features <dir>``
    in a process of its own: boots on the card, captures its graphs,
    reports ready on /healthz, answers a submit into its result store,
    and drains on SIGTERM with exit code 0."""
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
         "--features", root, "--http-port", "0", "--ws-port", "0"], cwd=cwd, env=env, stdout=subprocess.PIPE,
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
        if not health["ok"] or buckets != [1, 2, 4, 8, 10, 16, 32] or not \
                health["boot"]["boot_phases"].get("compile_s"):
            raise AssertionError(f"serve.app not ready: {health}")
        question = "what is the entry point serving"
        conn.request("POST", "/", body=json.dumps({
            "task_id": 1, "socket_id": "entry", "question": question,
            "image_list": ["img_0.jpg"]}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"serve.app submit: {resp.status} "
                                 f"{resp.read()!r}")
        resp.read()
        answer, end = None, time.perf_counter() + 60.0
        while answer is None and time.perf_counter() < end:
            conn.request("GET", "/admin/questionanswer?limit=5")
            for row in json.loads(conn.getresponse().read())["rows"]:
                if row.get("input_text") == question and row.get(
                        "answer_text"):
                    answer = row["answer_text"]
            time.sleep(0.05)
        if answer is None or len(answer.get("answers", [])) != 3:
            raise AssertionError(f"serve.app answered {answer}")
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
        f"ready in {boot_s:.1f}s (boot phases "
        f"{health['boot']['boot_phases']}), answered a VQA submit "
        f"({answer['answers'][0]['answer']}), exit 0 on SIGTERM")
    report["entry_point"] = {"boot_s": boot_s,
                             "boot_phases": health["boot"]["boot_phases"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vilbert_multitask_tpu_torch import _build

    report: dict = {}
    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    report["device"] = {"kind": kind, "nvidia_smi": smi,
                        "count": torch.cuda.device_count(),
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    log(f"device: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    # 2. build
    sources = sorted(f[:-3] for f in os.listdir(_build.SOURCE_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {sources} in {report['build_s']:.1f}s")
    notes = kernel_build_notes(_build, "flash_attn")
    smem = _build.load("flash_attn").vmt_flash_attn_bf16_smem_bytes()
    for rec in notes:
        if "bf16" in rec["kernel"]:
            rec["smem_dynamic_bytes"] = smem
        log(f"  flash_attn: {json.dumps(rec)}")
    report["build_notes"] = {"flash_attn": notes}
    check_build_notes(notes)
    # 3. kernels against their plain versions
    by_shape = check_flash_attention(torch, report)
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as state:
        # 4. main path (predict, eager)
        eng = main_path(torch, report, root)
        # 5. one CUDA graph per bucket
        check_graphs(torch, report, eng)
        # 6. run_many
        batched_launches = check_batched(torch, report, eng)
        # 7. the served path
        served_launches = check_served(torch, report, eng, root, state)
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
    }]}
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
