"""Where one block of the bf16 flash-attention kernel spends its cycles.

    python3 -m vilbert_multitask_tpu_torch.ops.flash_phases

Builds ``csrc/flash_attn.cu`` a second time with ``-DVMT_FLASH_PHASES``, in
which thread 0 of block (0, 0, 0) of the bf16 kernel stamps ``clock64()`` at
the end of each phase, launches that build at the serving shapes (bf16,
8 heads x 128, seeded inputs, after a warm-up), and prints per shape the SM
cycles each phase took: the prologue (every copy of Q and the first two key
tiles issued), then per key tile the wait for its copies, the score
products (with Q's fragments on the first tile), the softmax and P·V, then
the epilogue's staging and stores. The stamps time one warp's issue: an
``mma.sync`` that is still running when its phase ends shows up in the next
phase. Writes ``chiprun_out/flash_phases.json``. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

SHAPES = ((1, 38, 101), (1, 101, 38), (1, 101, 101), (32, 101, 101))
FLAG = "-DVMT_FLASH_PHASES"


def phases(stamps) -> dict:
    """Phase name -> cycles, from the 64 stamps (0 where not written)."""
    out = {"prologue": stamps[1] - stamps[0]}
    last, j = stamps[1], 0
    while 5 + 4 * j < 40 and stamps[5 + 4 * j]:
        names = ("wait", "scores", "softmax", "pv")
        for i, name in enumerate(names):
            out[f"tile{j}_{name}"] = stamps[2 + 4 * j + i] - last
            last = stamps[2 + 4 * j + i]
        j += 1
    out["epilogue_stage"] = stamps[41] - stamps[40]
    out["epilogue_store"] = stamps[42] - stamps[41]
    out["total"] = stamps[42] - stamps[0]
    return out


def main() -> None:
    import torch

    from vilbert_multitask_tpu_torch import _build
    from vilbert_multitask_tpu_torch.ops import coattention as co
    from vilbert_multitask_tpu_torch.ops.attention import mask_to_bias

    if not torch.cuda.is_available():
        raise SystemExit("flash_phases needs a CUDA device")
    lib = _build.load("flash_attn", _build.NVCC_FLAGS + (FLAG,))
    take = lib.vmt_flash_phases_take
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    report = {"device": smi, "shapes": []}
    gen = torch.Generator().manual_seed(0)
    for B, Nq, Nk in SHAPES:
        q, k, v = (torch.randn(B, n, 8, 128, generator=gen).to(
            "cuda", torch.bfloat16) for n in (Nq, Nk, Nk))
        bias = mask_to_bias(torch.ones(B, Nk, device="cuda"), torch.bfloat16)
        stamps = (ctypes.c_longlong * 64)()
        for _ in range(5):
            co._launch(q, k, v, bias, lib=lib)
        torch.cuda.synchronize()
        take(stamps)
        co._launch(q, k, v, bias, lib=lib)
        torch.cuda.synchronize()
        if take(stamps) != 0:
            raise RuntimeError("could not read the phase stamps")
        row = {"B": B, "Nq": Nq, "Nk": Nk, "cycles": phases(list(stamps))}
        report["shapes"].append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "flash_phases.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
