"""Where one block of each bf16 int8_linear kernel spends its cycles.

    python3 -m vilbert_multitask_tpu_torch.ops.int8_phases

Builds ``csrc/int8_linear.cu`` a second time with ``-DVMT_INT8_PHASES``, in
which block (0, 0, 0) of the bf16 kernels stamps ``clock64()`` at the end of
each phase, launches that build at serving shapes (the trunk's bf16 scale,
seeded operands, after a warm-up) and prints per shape the launch plan and
the SM cycles of each phase:

- the stream kernel (thread 0, split 0 of the first output tile): the
  prologue (scales read, the first copies issued), per K tile the wait for
  its copies and the issue of its products, then with splits the wait for
  the cluster's blocks to start, the partials' stores and the cluster
  barrier, and the ordered sum and stores of y;
- the ``wgmma`` kernel (the first thread of each consumer warpgroup, its
  first 8 K tiles): the wait for the weight tile, its dequantization, the
  wait for the x tile, and the products up to their retirement; the TMA
  warps' issue times of their first 8 loads; the epilogue.

The stamps time one thread's issue and completion points, and an SM's
cycle counter is shared by all its warps. Writes
``chiprun_out/int8_phases.json``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

# (M, N, K): bucket-1 products (text q/k/v, text intermediate, visual, a
# pooler) on the stream kernel; bucket-32 products on the wgmma kernel,
# one with a single weight row (vision_logit: no work but the pipeline's).
SHAPES = ((38, 768, 768), (38, 3072, 768), (101, 1024, 1024), (1, 1024, 768),
          (1216, 768, 3072), (3232, 1024, 1024), (3232, 1, 1024))
FLAG = "-DVMT_INT8_PHASES"
N_STAMPS = 128
STREAM_TILES = 16  # K tiles the stream kernel stamps
WGMMA_TILES = 8  # K tiles the wgmma kernel stamps per warpgroup


def stream_phases(stamps, splits: int) -> dict:
    """Phase name -> cycles of the stream kernel, from its stamps."""
    out = {"prologue": stamps[1] - stamps[0]}
    last = stamps[1]
    i = 0
    while i < STREAM_TILES and stamps[3 + 2 * i]:
        out[f"tile{i}_wait"] = stamps[2 + 2 * i] - last
        out[f"tile{i}_products"] = stamps[3 + 2 * i] - stamps[2 + 2 * i]
        last = stamps[3 + 2 * i]
        i += 1
    if splits > 1:
        out["cluster_started"] = stamps[40] - last
        out["partials_stored"] = stamps[41] - stamps[40]
        last = stamps[41]
    out["sum_and_store" if splits > 1 else "store"] = stamps[42] - last
    out["total"] = stamps[42] - stamps[0]
    return out


def wgmma_phases(stamps) -> dict:
    """Phase name -> cycles of the wgmma kernel, from its stamps, per
    consumer warpgroup and tile, with the TMA warps' issue times (cycles
    after the block's start) and each phase's mean over tiles 2..7."""
    t0 = stamps[0]
    out = {}
    steady: dict = {}
    for wg in range(2):
        base = 8 + 32 * wg
        last = t0
        it = 0
        while it < WGMMA_TILES and stamps[base + 4 * it + 3]:
            s = stamps[base + 4 * it: base + 4 * it + 4]
            row = {"weight_wait": s[0] - last, "dequantize": s[1] - s[0],
                   "x_wait": s[2] - s[1], "products": s[3] - s[2]}
            out[f"wg{wg}_tile{it}"] = row
            if it >= 2:
                for k, v in row.items():
                    steady.setdefault(k, []).append(v)
            last = s[3]
            it += 1
        out[f"wg{wg}_rest_and_epilogue"] = stamps[88 + wg] - last
    out["tma_x_issued"] = [stamps[72 + i] - t0 for i in range(WGMMA_TILES)
                           if stamps[72 + i]]
    out["tma_w_issued"] = [stamps[80 + i] - t0 for i in range(WGMMA_TILES)
                           if stamps[80 + i]]
    out["steady_tile_mean"] = {k: sum(v) / len(v) for k, v in steady.items()}
    out["total"] = max(stamps[88], stamps[89]) - t0
    return out


def main() -> None:
    import torch

    from vilbert_multitask_tpu_torch import _build
    from vilbert_multitask_tpu_torch.ops import int8_linear as il

    if not torch.cuda.is_available():
        raise SystemExit("int8_phases needs a CUDA device")
    lib = _build.load("int8_linear", _build.NVCC_FLAGS + (FLAG,))
    take = lib.vmt_int8_phases_take
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    report = {"device": smi, "shapes": []}
    gen = torch.Generator().manual_seed(0)
    for M, N, K in SHAPES:
        x = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
        q = torch.randint(-127, 128, (N, K), generator=gen,
                          dtype=torch.int8).cuda()
        s = (torch.rand(N, generator=gen) / 64).to(torch.bfloat16).float()
        s = s.cuda()
        b = (0.02 * torch.randn(N, generator=gen)).to("cuda", torch.bfloat16)
        plan = il.plan_launch(M, N, K)
        stamps = (ctypes.c_longlong * N_STAMPS)()
        for _ in range(5):
            il._launch(x, q, s, b, scale_bf16=True, lib=lib)
        torch.cuda.synchronize()
        take(stamps)
        il._launch(x, q, s, b, scale_bf16=True, lib=lib)
        torch.cuda.synchronize()
        if take(stamps) != 0:
            raise RuntimeError("could not read the phase stamps")
        got = list(stamps)
        cycles = (wgmma_phases(got) if plan.regime == "wgmma"
                  else stream_phases(got, plan.splits))
        row = {"M": M, "N": N, "K": K, "regime": plan.regime,
               "splits": plan.splits, "blocks": plan.blocks,
               "cycles": cycles}
        report["shapes"].append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "int8_phases.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
