"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (read
from a profiled sub-window). Every run compares what its timed path
produced with the plain reference (``portbench/reference/``) and prints
each number compared beside its limit, last on standard error and last in
the line. ``--control`` reads the control's numbers instead: the answers
judged are the plain reference's in fp8 compute, put in the program's
place, and the detector runs its TF32 path. The benchmark's own runs do
not use it.

Exit codes: 0 with a result; 3 without a card or with fewer cards than
the cell asks for; 4 when JAX, jaxlib, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def _quarters(records) -> dict:
    """Mean latency of each quarter of an open-loop stream, in arrival
    order: a backlog that grows through the window shows as a rise."""
    out = {}
    for key in ("upload_latency_s", "answer_latency_s"):
        lat = records.get(key)
        if lat:
            n = len(lat)
            out[key] = [round(1e3 * sum(q) / max(len(q), 1), 1) for q in (
                lat[i * n // 4:(i + 1) * n // 4] for i in range(4))]
    return out


def main(argv=None) -> int:
    args = _args(argv)
    from portbench import harness

    harness.set_cache_env()
    import torch

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = harness.Run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_process=T_PROCESS,
                      bench=bench, control=args.control)
    driver = harness.load_module("drivers", run.traffic["driver"])
    out = driver.run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    line = harness.result(run, out["checks"], out["attempted"],
                          out["failed"],
                          lambda: torch.cuda.get_device_name(run.device))
    print(json.dumps({"boot": run.boot, "setup_s": run.setup_s,
                      "judge_s": run.records.get("judge_s"),
                      "readings": out["readings"],
                      "latency_quarters_ms": _quarters(run.records)}),
          file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else '  FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
