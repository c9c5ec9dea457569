"""What every cell shares: finding a cell's files by name, the run's state,
the program's set-up, the traced sub-window, and the result line.

A cell names a configuration and a traffic mix; the configuration is
``portbench/configs/<name>.json``, the traffic ``portbench/traffic/
<name>.json``, which names its driver ``portbench/drivers/<kind>.py``; every
metric is read by ``portbench/metrics/<name>.py``. A later cell, mix or
metric is a file and an entry, never an edit here.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# Every build and kernel cache the program keeps, at one fixed path inside
# the checkout, so that only a checkout's first run builds.
CACHE = os.path.join(ROOT, ".benchcache")
FORBIDDEN = ("jax", "jaxlib", "flax", "vilbert_multitask_tpu")


def load_json(*parts: str) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def module_path(kind: str, name: str) -> str:
    """``portbench/<kind>/<name>.py`` (a name may hold dots); a metric
    named ``<family>.<cells>`` with no file of its own is read by its
    family's ``<family>.py``."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(HERE, kind, name.split(".")[0] + ".py")
    return path


def load_module(kind: str, name: str):
    path = module_path(kind, name)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is JAX's, jaxlib's, flax's
    or the JAX package's, compared whole."""
    names = modules if modules is not None else list(sys.modules)
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def set_cache_env() -> None:
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile (linear between order statistics); a missing
    value (an unanswered request) is +inf."""
    xs = sorted(values)
    if not xs:
        return math.inf
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Check:
    """One number the correctness comparison reads, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(run: "Run", readings: Dict[str, float]) -> List[Check]:
    """The numbers the configuration's ``limits`` name, each beside its
    limit."""
    return [Check(k, float(readings[k]), float(v))
            for k, v in run.config["limits"].items()]


class Tracer:
    """The traced sub-window of a ``--trace 1`` run. PyTorch's profiler
    records the host ranges of the thread that starts it (and the device's
    work from every thread), so the cell's busiest thread calls
    :meth:`step` between its units of work: the profiler starts at the
    first step ``offset_s`` into the window and stops at the first step
    ``length_s`` after. The profiler slows the host, so a per-layer metric
    read by the host's clock counts only the window before it starts:
    ``on_start`` lets the cell take that snapshot."""

    def __init__(self, enabled: bool, offset_s: float, length_s: float,
                 device):
        self.on_start: Optional[Callable[[], None]] = None
        self.enabled = enabled
        self.offset_s = offset_s
        self.length_s = length_s
        self.device = device
        self.prof = None
        self.t_start = self.t_stop = None
        self.done = False
        self.tid = None

    def step(self, window_start: float) -> None:
        if not self.enabled or self.done:
            return
        now = time.perf_counter()
        if self.prof is None and now - window_start >= self.offset_s:
            from torch.profiler import ProfilerActivity, profile

            if self.on_start is not None:
                self.on_start()
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.tid = threading.get_native_id()
            self.t_start = time.perf_counter()
        elif (self.prof is not None and now - self.t_start >= self.length_s):
            self.stop()

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            self.prof.__exit__(None, None, None)
            self.t_stop = time.perf_counter()
            self.done = True


class Run:
    """One run of one cell: its files, its seed, and what the cell's
    traffic module records for the metric readers and the comparison."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, *, device="cuda", t_process: float = None,
                 bench: Optional[dict] = None,
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None,
                 control: bool = False, work_dir: Optional[str] = None):
        import torch

        self.bench = bench or load_json(ROOT, "BENCHMARK.json")
        self.cell = next(w for w in self.bench["workloads"]
                         if w["name"] == workload)
        conf = next(c for c in self.bench["configs"]
                    if c["name"] == self.cell["config"])
        self.config = config or load_json(ROOT, conf["file"])
        self.traffic = traffic or load_json(
            HERE, "traffic", self.cell["traffic"] + ".json")
        self.workload, self.seed, self.seconds = workload, int(seed), seconds
        self.device = torch.device(device)
        self.control = control
        self.t_process = t_process or time.perf_counter()
        # The traffic's files: under the run's TMPDIR, else in the checkout.
        self.work_dir = work_dir or os.path.join(
            os.environ.get("TMPDIR") or CACHE, "portbench-work")
        self.records: Dict[str, Any] = {}
        self.window_start: Optional[float] = None
        self.setup_s: Optional[float] = None
        self.memory_peak: int = 0
        trace_cfg = self.traffic.get("trace", {})
        self.tracer = Tracer(bool(trace), float(trace_cfg.get("offset_s", 2)),
                             float(trace_cfg.get("length_s", 3)),
                             self.device)
        self.trace = bool(trace)
        self.boot: Dict[str, Any] = {}

    # ------------------------------------------------------------- window
    def start_window(self) -> float:
        """Set-up ends here: the first request is due now."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.window_start = time.perf_counter()
        self.setup_s = self.window_start - self.t_process
        return self.window_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        """Start the peak here: once the program is built and the seeded
        weights and traffic drawn on the card for it are freed, so that
        the peak is what the program holds and uses, not the benchmark's
        own loading."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))

    def release(self) -> None:
        """Free the program's state (the caller has dropped its references)
        before the reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


# ------------------------------------------------------------- the program
def framework_config(config: dict):
    """The program's configuration from a configuration file."""
    from vilbert_multitask_tpu_torch.config import FrameworkConfig

    engine = dict(config["engine"])
    return FrameworkConfig.from_dict({"model": config["model"],
                                     "engine": engine})


def start_kernel_builds(cfg, live_extract: bool, device):
    """Start nvcc for every kernel library of the variant under the
    benchmark's cache (the program's own boot path): a miss builds, a hit
    loads. None on the CPU."""
    if device.type != "cuda":
        return None
    from vilbert_multitask_tpu_torch.engine.aotcache import (
        AotCache,
        compile_fingerprint,
    )

    cache = AotCache(os.path.join(CACHE, "kernels"),
                     compile_fingerprint(cfg, live_extract=live_extract))
    cache.prefetch()
    return cache


def build_engine(run: Run, cfg, store, buckets) -> Any:
    """The served engine with the seed's weights, its kernel libraries
    loaded and only ``buckets`` warmed (one CUDA graph each)."""
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    from portbench import weights
    from portbench.reference.vilbert import Dims

    t0 = time.perf_counter()
    sd = weights.trunk_weights(Dims.from_config(run.config["model"]),
                               run.seed, run.device)
    run.sync()
    t1 = time.perf_counter()
    before = _allocated(run.device)
    engine = InferenceEngine(cfg, params=sd, feature_store=store,
                             device=run.device)
    run.sync()
    run.boot["trunk_weights_s"] = t1 - t0
    run.boot["engine_build_s"] = time.perf_counter() - t1
    # What the served weights take on the card: the engine's allocations,
    # its model's tensors and its fused head slabs.
    run.boot["engine_allocated_bytes"] = _allocated(run.device) - before
    run.boot["model_tensor_bytes"] = _tensor_bytes(
        engine.model.state_dict().values())
    run.boot["head_slab_bytes"] = _tensor_bytes(
        (engine.head_slabs or {}).values())
    del sd
    return engine


def _allocated(device) -> int:
    import torch

    return (int(torch.cuda.memory_allocated(device))
            if device.type == "cuda" else 0)


def _tensor_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def join_kernels(run: Run, cache) -> None:
    if cache is not None:
        rep = cache.join()
        run.boot["nvcc_s"] = rep["compile_s"]
        run.boot["kernel_misses"] = rep["misses"]


def warm(run: Run, engine, buckets) -> None:
    t0 = time.perf_counter()
    engine.warmup(buckets=list(buckets))
    run.boot["capture_s"] = time.perf_counter() - t0


def build_extractor(run: Run, *, allow_tf32: bool = False):
    """The live extractor with the seed's detector weights, not yet
    warmed (:func:`warm_extractor`)."""
    from vilbert_multitask_tpu_torch.config import DetectorConfig
    from vilbert_multitask_tpu_torch.detect.extractor import (
        LiveFeatureExtractor,
    )

    from portbench import weights
    from portbench.reference.detector import DetDims

    det = dict(run.config["detector"])
    det.pop("num_keep", None)
    fields = {f.name for f in dataclasses.fields(DetectorConfig)}
    dcfg = DetectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in det.items() if k in fields})
    t0 = time.perf_counter()
    sd = weights.detector_weights(DetDims.from_config(run.config["detector"]),
                                  run.seed, run.device)
    ex = LiveFeatureExtractor(dcfg, params=sd, device=run.device,
                              num_keep=int(run.config["detector"]
                                           .get("num_keep", 100)),
                              allow_tf32=allow_tf32)
    del sd
    run.boot["detector_weights_s"] = time.perf_counter() - t0
    return ex


def warm_extractor(run: Run, ex) -> None:
    t0 = time.perf_counter()
    ex.warmup()
    run.boot["detector_warmup_s"] = time.perf_counter() - t0


def labelled(name: str):
    """A host range in the profiler's trace (a no-op context when the
    profiler is off)."""
    from torch.profiler import record_function

    return record_function(name)


def reader_values(run: Run, names: List[str]) -> Dict[str, Any]:
    out = {}
    for name in names:
        value = load_module("metrics", name).read(run)
        if value is not None:
            out[name] = value
    return out


def result(run: Run, checks: List[Check], attempted: int, failed: int,
           device_kind: Callable[[], str]) -> dict:
    """The contract's last line, before the checks key is appended."""
    bench, w = run.bench, run.workload
    metrics = (bench["per_layer"] if run.trace else bench["end_to_end"])
    chosen = [m for m in metrics if applies(m, w)]
    values = reader_values(run, [m["name"] for m in chosen])
    out = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {m["name"]: {"value": values[m["name"]],
                                "unit": m["unit"]}
                    for m in chosen if m["name"] in values},
        "device": {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                   "kind": device_kind(), "count": 1,
                   "memory_peak_bytes": run.memory_peak},
    }
    if run.trace and "trace" in run.records:
        tr = run.records["trace"]
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    # JSON has no infinity: a number that could not be read is "inf"
    out["checks"] = {c.name: {"value": (c.value if math.isfinite(c.value)
                                        else str(c.value)),
                              "limit": c.limit}
                     for c in checks}
    return out
