"""A whole run of a cell at toy sizes on the CPU, for the tests: the
cell's own files with the model, the detector and the traffic shrunk
(the program's ``tiny()`` sizes), the kernels' plain versions, and the
look for a card skipped."""

from __future__ import annotations

import copy
import dataclasses

from portbench import harness

TINY_TRAFFIC = {
    "gallery": {"n_images": 24, "n_boxes": 10},
    "uploads": {"long_sides": [64, 96]},
    "batch_questions": 16, "pool_questions": 40, "warm_questions": 8,
    "sample_every": 3, "judge_samples": 6, "judge_uploads": 2,
    "drain_s": 20, "host_cache_entries": 8,
    "trace": {"offset_s": 0.2, "length_s": 0.5},
}
TINY_RATE = 4.0


def tiny_config(name: str) -> dict:
    from vilbert_multitask_tpu_torch.config import (
        DetectorConfig,
        ViLBertConfig,
    )

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == name)
    cfg = copy.deepcopy(harness.load_json(harness.ROOT, conf["file"]))
    small = dataclasses.asdict(ViLBertConfig().tiny())
    cfg["model"] = {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in small.items() if k in cfg["model"]}
    cfg["engine"]["device_input_cache_entries"] = 4
    if "detector" in cfg:
        det = dataclasses.asdict(DetectorConfig().tiny())
        cfg["detector"] = {k: (list(v) if isinstance(v, tuple) else v)
                           for k, v in det.items()}
        cfg["detector"]["num_keep"] = 10
    return cfg


def tiny_traffic(name: str) -> dict:
    t = copy.deepcopy(harness.load_json(harness.HERE, "traffic",
                                        name + ".json"))
    for k, v in TINY_TRAFFIC.items():
        if k in t and isinstance(v, dict):
            t[k].update(v)
        elif k in t:
            t[k] = v
    if "rate" in t:
        t["rate"] = TINY_RATE
    return t


def tiny_run(workload: str, seed: int = 7, seconds: float = 1.5,
             trace: bool = False, work_dir: str = None,
             limits=None) -> harness.Run:
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = tiny_config(cell["config"])
    cfg["limits"] = dict(limits or {k: 1e9 for k in cfg["limits"]})
    return harness.Run(workload, seed, seconds, trace, device="cpu",
                       bench=bench, config=cfg,
                       traffic=tiny_traffic(cell["traffic"]),
                       work_dir=work_dir)


def drive(run: harness.Run) -> dict:
    driver = harness.load_module("drivers", run.traffic["driver"])
    out = driver.run(run)
    line = harness.result(run, out["checks"], out["attempted"],
                          out["failed"], lambda: "cpu")
    return line
