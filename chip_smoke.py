#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and nvcc; without a CUDA device it exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.

Phases (any failure exits non-zero; nothing is caught and carried on):

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the port from ``vilbert_multitask_tpu_torch/csrc``,
   one nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes, in f32 (max abs error <= 2e-5, the JAX package's own
   kernel tolerance) and bf16; per shape, the kernel's device time (calls
   captured in a CUDA graph, replays timed by CUDA events, median), the
   plain version's, the yardstick library call's
   (``scaled_dot_product_attention``, never called by the port), the same
   three as eager back-to-back calls (host launch cost included), and the
   least time the card could take (``bound_ms``);
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


# ---------------------------------------------------------------- phase 3
def check_flash_attention(torch, report: dict) -> dict:
    import torch.nn.functional as F

    from vilbert_multitask_tpu_torch.ops import coattention as co
    from vilbert_multitask_tpu_torch.ops.attention import mask_to_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    shapes = [(b, nq, nk, 8, 128) for b in (1, 2, 4, 8, 32)
              for nq, nk in ((38, 101), (101, 38), (101, 101))]
    shapes.append((2, 45, 300, 4, 96))  # several key tiles, ragged edges
    rows = []
    for B, Nq, Nk, H, D in shapes:
        q32, k32, v32 = (torch.randn(B, n, H, D, generator=gen).to(dev)
                         for n in (Nq, Nk, Nk))
        mask = torch.rand(B, Nk, generator=gen) < 0.9
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
        out16 = co.flash_cross_attention(q16, k16, v16, b16).float()
        ref16 = co.flash_cross_attention_plain(
            q16.float(), k16.float(), v16.float(), b32)
        err16 = (out16 - ref16).abs().max().item()
        ok16 = bool(((out16 - ref16).abs()
                     <= BF16_ATOL + BF16_RTOL * ref16.abs()).all())
        torch.cuda.synchronize()
        qt, kt, vt = (t.transpose(1, 2) for t in (q16, k16, v16))
        fns = dict(
            kernel=lambda: co.flash_cross_attention(q16, k16, v16, b16),
            plain=lambda: co.flash_cross_attention_plain(q16, k16, v16, b16),
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=b16))
        row = dict(B=B, Nq=Nq, Nk=Nk, H=H, D=D, max_abs_err_f32=err32,
                   max_abs_err_bf16=err16)
        for name, fn in fns.items():
            row[f"{name}_ms"] = device_ms(fn)
            row[f"{name}_call_ms"] = call_ms(fn)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            B, Nq, Nk, H, D, 2)
        rows.append(row)
        log("flash_attn B=%d Nq=%d Nk=%d H=%d D=%d kernel_ms=%.5f "
            "plain_ms=%.5f library_ms=%.5f bound_ms=%.6f (%s) | eager "
            "calls: kernel %.5f plain %.5f library %.5f | err_f32=%.3e "
            "err_bf16=%.3e" % (
                B, Nq, Nk, H, D, row["kernel_ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"], row["bound_by"],
                row["kernel_call_ms"], row["plain_call_ms"],
                row["library_call_ms"], err32, err16))
        if not err32 <= F32_TOL:
            raise AssertionError(f"f32 kernel error {err32:.3e} > {F32_TOL} "
                                 f"at {(B, Nq, Nk, H, D)}")
        if not ok16:
            raise AssertionError(f"bf16 kernel error {err16:.3e} beyond "
                                 f"atol {BF16_ATOL} + rtol {BF16_RTOL} at "
                                 f"{(B, Nq, Nk, H, D)}")
    report["flash_attn_shapes"] = rows

    # Strided inputs: q, k, v as views into fused (B, N, 3, H, D) buffers
    # (the layout a fused QKV projection gives), read in place.
    B, Nq, Nk, H, D = 2, 38, 101, 8, 128
    qb = torch.randn(B, Nq, 3, H, D, generator=gen).to(dev)
    kvb = torch.randn(B, Nk, 3, H, D, generator=gen).to(dev)
    q, k, v = qb[:, :, 0], kvb[:, :, 1], kvb[:, :, 2]
    assert not q.is_contiguous() and k.stride(1) == 3 * H * D
    mask = torch.ones(B, Nk, dtype=torch.bool)
    mask[1, 60:] = False
    bias = mask_to_bias(mask.to(dev), torch.float32)
    err = (co.flash_cross_attention(q, k, v, bias)
           - co.flash_cross_attention_plain(q.contiguous(), k.contiguous(),
                                            v.contiguous(), bias)
           ).abs().max().item()
    log(f"flash_attn strided views (B={B} Nq={Nq} Nk={Nk}): f32 max abs "
        f"err {err:.3e}")
    if not err <= F32_TOL:
        raise AssertionError(f"strided f32 kernel error {err:.3e}")
    report["flash_attn_strided_err_f32"] = err
    return {(r["B"], r["Nq"], r["Nk"]): r for r in rows}


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


def compare_bundles(ref: dict, got: dict, tol: dict, what: str) -> float:
    import numpy as np

    worst = 0.0
    for name, r in flat_bundle(ref).items():
        g = flat_bundle(got)[name]
        if r.shape != g.shape or not np.isfinite(g).all():
            raise AssertionError(f"{what}: {name} shape {g.shape} vs "
                                 f"{r.shape} or non-finite")
        # Masked grounding rows carry the -10000 bias (-9984 in bf16); the
        # relative tolerance covers that the same way for every leaf.
        np.testing.assert_allclose(g, r, err_msg=f"{what}: {name}", **tol)
        worst = max(worst, float(np.abs(g - r).max()))
    return worst


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
        worst_bf16 = worst_f32 = 0.0
        for task_id, question, keys in REQUESTS:
            ref = cpu32.bundle(cpu32.prepare_from_store(task_id, question,
                                                        keys))[1]
            b16 = eng.bundle(eng.prepare_from_store(task_id, question,
                                                    keys))[1]
            b32 = eng32.bundle(eng32.prepare_from_store(task_id, question,
                                                        keys))[1]
            worst_bf16 = max(worst_bf16, compare_bundles(
                ref, b16, BUNDLE_BF16, f"task {task_id} bf16 card vs f32 cpu"))
            worst_f32 = max(worst_f32, compare_bundles(
                ref, b32, BUNDLE_F32, f"task {task_id} f32 card vs f32 cpu"))
        report["bundle_max_abs_err"] = {"bf16_card_vs_f32_cpu": worst_bf16,
                                        "f32_card_vs_f32_cpu": worst_f32}
        log(f"decode bundles vs CPU f32: bf16 card max abs err {worst_bf16:.3e}"
            f" (rtol 0.1, atol 0.05); f32 card max abs err {worst_f32:.3e} "
            f"(rtol 2e-3, atol 2e-3)")

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
    logs = _build.build(sources)
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {sources} in {report['build_s']:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
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
