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
5. a ``{"kernels": [...]}`` line, the card's nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

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
    import numpy as np

    from vilbert_multitask_tpu_torch.features.pipeline import (
        synthetic_regions,
    )
    from vilbert_multitask_tpu_torch.features.store import save_reference_npy

    rng = np.random.default_rng(1234)
    for i in range(4):
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


def main_path(torch, report: dict) -> dict:
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
    with tempfile.TemporaryDirectory() as root:
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
    return report


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
    # 4. main path
    main_path(torch, report)
    # 5. the kernels line: per-shape numbers summed over the 18 launches of
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
        "launches": report["main_path_launches"],
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
