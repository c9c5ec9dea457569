"""Where one served request's time goes on the card.

    python3 -m vilbert_multitask_tpu_torch.engine.profile_run [--reps N] [--graphs]
        [--param-dtype int8]

Builds the engine at the full serving config (``ViLBertConfig()`` +
``EngineConfig()``: bf16 compute, fused heads, flash kernel on; with
``--param-dtype int8`` the int8 storage mode, every Linear and head product
on the int8 GEMM) with seeded random weights on ``cuda``, prepares one VQA
request (bucket 1, 100 seeded regions), warms ``run()`` — eagerly, or with
``--graphs`` after capturing bucket 1's CUDA graph (engine.warmup), so every
run replays it — then measures:

- ``wall_ms``: host clock around ``run()`` (which ends in the blocking fetch
  of the decode bundle), median of ``reps`` runs without the profiler;
- under ``torch.profiler`` (CPU + CUDA activities) over ``reps`` runs: the
  kernels each run launches, the device busy time per run (the union of the
  kernels' device intervals), and the kernels that take the most device time;
- ``idle_share = 1 - busy / wall``: how far the host holds the card back;
- ``host_top``: the host-side operations with the most self CPU time per
  run (where the host's share of the wall goes);
- ``int8_linear``: the int8 GEMM kernels' launches and device time per run
  and their share of the device's busy time (int8 storage mode);
- ``row_kernels``: launches and device time per run of each of
  ``ROW_KERNELS`` (the residual LayerNorm, the softmax, the dense core).

Prints one JSON line and writes it to ``chiprun_out/profile_run.json``
(``profile_run_graphs.json`` with ``--graphs``; ``_int8`` before
``.json`` with ``--param-dtype int8``).
Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import time


# The port's kernels that stand for XLA's fusions, by wrapper name (each
# kernel's name in the trace is the wrapper's with ``_kernel`` after it).
ROW_KERNELS = ("add_layer_norm", "scaled_masked_softmax", "dense_attention")


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_run(reps: int = 20, seed: int = 0, graphs: bool = False,
                param_dtype: str = None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vilbert_multitask_tpu_torch.config import FrameworkConfig
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
    from vilbert_multitask_tpu_torch.features.pipeline import (
        synthetic_regions,
    )

    cfg = FrameworkConfig()
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, param_dtype=param_dtype))
    eng = InferenceEngine(cfg, seed=seed, device="cuda")
    region = synthetic_regions(cfg.model.v_feature_size, n_boxes=100,
                               seed=seed)
    req = eng.prepare(1, "what is the man holding", [region])
    if graphs:
        eng.warmup(buckets=[1])
    for _ in range(5):
        eng.run(req)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.run(req)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eng.run(req)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _union_us(intervals) / 1e3 / reps if kernels else None
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    flash = [v for k, v in by_name.items() if "flash_attn" in k]
    int8 = [v for k, v in by_name.items() if "int8_linear" in k]
    rowwise = {n: [v for k, v in by_name.items() if n + "_kernel" in k]
               for n in ROW_KERNELS}
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    return {
        "device": torch.cuda.get_device_name(0),
        "config": "ViLBertConfig() + EngineConfig(param_dtype=%r), bucket 1 "
                  "(VQA)" % cfg.engine.param_dtype,
        "mode": "graph replay" if graphs else "eager",
        "reps": reps,
        "wall_ms_p50": wall_ms,
        "wall_ms_min": min(walls),
        "device_busy_ms_per_run": busy_ms,
        "idle_share": (None if busy_ms is None
                       else max(0.0, 1.0 - busy_ms / wall_ms)),
        "kernels_per_run": len(kernels) / reps,
        "flash_attn": ({"launches_per_run": sum(c for c, _ in flash) / reps,
                        "device_ms_per_run":
                            sum(t for _, t in flash) / 1e3 / reps}
                       if flash else None),
        "int8_linear": ({"launches_per_run": sum(c for c, _ in int8) / reps,
                         "device_ms_per_run":
                             sum(t for _, t in int8) / 1e3 / reps,
                         "share_of_busy":
                             sum(t for _, t in int8) / 1e3 / reps / busy_ms
                             if busy_ms else None,
                         "by_kernel": {k[:120]: {"launches_per_run": c / reps,
                                                 "device_ms_per_run":
                                                     t / 1e3 / reps}
                                       for k, (c, t) in by_name.items()
                                       if "int8_linear" in k}}
                        if int8 else None),
        "row_kernels": {n: {"launches_per_run": sum(c for c, _ in v) / reps,
                            "device_ms_per_run":
                                sum(t for _, t in v) / 1e3 / reps}
                        for n, v in rowwise.items()},
        "top_kernels": [{"name": k[:120], "launches_per_run": c / reps,
                         "device_ms_per_run": t / 1e3 / reps}
                        for k, (c, t) in top],
        "host_top": [{"name": e.key[:120], "calls_per_run": e.count / reps,
                      "self_cpu_ms_per_run":
                          e.self_cpu_time_total / 1e3 / reps}
                     for e in host],
        "stage_ms": {k[:-2] + "_ms": v * 1e3
                     for k, v in eng.stage_times.items()},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", action="store_true",
                    help="capture bucket 1's CUDA graph first (engine.warmup)")
    ap.add_argument("--param-dtype", default=None,
                    help="EngineConfig.param_dtype (e.g. int8)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    report = profile_run(args.reps, args.seed, graphs=args.graphs,
                         param_dtype=args.param_dtype)
    name = "profile_run_graphs" if args.graphs else "profile_run"
    if args.param_dtype:
        name += f"_{args.param_dtype}"
    args.out = args.out or os.path.join("chiprun_out", name + ".json")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
