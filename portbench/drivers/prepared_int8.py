"""``prepared``'s closed loop on an engine that serves int8 weights, judged
against the storage it serves.

The window is ``prepared``'s: a pool of questions prepared at set-up,
``run_many`` of ``batch_questions`` at a time round the pool, an answer
counted when it is decoded inside the window. Two things differ:

- the program's tracer is on while the engine is built, so that the
  ``engine.quantize`` span of the engine's host quantization is kept
  (``quantize_s``), and off again before the window;
- every sampled answer is judged against the plain reference computed on
  the int8 values and scales the configuration's storage holds
  (``reference_weights(..., int8=True)`` of the same seed's weights), not
  on the floating weights the engine never served. The control is that
  reference in fp8 compute.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from portbench import harness, judge, traffic
from portbench.reference import vilbert as ref_vil


class Int8Reference(judge.Reference):
    """:class:`judge.Reference` over the int8 storage of the seed's trunk
    weights (float32 compute, TF32 off); its control computes in fp8 on
    that storage."""

    def __init__(self, config: dict, seed: int, device, *,
                 control: bool = False):
        from portbench import weights
        from portbench.reference import inputs as ref_in

        self.device = device
        self.dims = ref_vil.Dims.from_config(config["model"])
        sd = weights.trunk_weights(self.dims, seed, device)
        self.w = ref_vil.reference_weights(sd, self.dims, int8=True)
        del sd
        self.control_w = (ref_vil.reference_weights(self.w, self.dims,
                                                    compute="fp8")
                          if control else None)
        self.tok = ref_in.tokenizer()
        self.labels = {"vqa": ref_in.label_names("vqa"),
                       "gqa": ref_in.label_names("gqa")}
        self.det_dims = self.det_w = None
        self.max_text_len = int(config["engine"]["max_text_len"])
        self.max_regions = int(config["engine"]["max_regions"])


def _build(r: harness.Run, cfg, store):
    """``harness.build_engine`` for an int8 engine, whose state dict holds
    ``{"int8", "scale"}`` pairs: the engine with the seed's weights, built
    with the program's tracer on; the ``engine.quantize`` spans it opened
    go to the run's records."""
    from vilbert_multitask_tpu_torch import obs
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    from portbench import weights

    t0 = time.perf_counter()
    sd = weights.trunk_weights(ref_vil.Dims.from_config(r.config["model"]),
                               r.seed, r.device)
    r.sync()
    t1 = time.perf_counter()
    before = harness._allocated(r.device)
    tracer = obs.default_tracer()
    was = tracer.enabled
    tracer.enable()
    try:
        engine = InferenceEngine(cfg, params=sd, feature_store=store,
                                 device=r.device)
        r.sync()
    finally:
        if not was:
            tracer.disable()
    r.records["quantize_spans"] = [
        (s.dur_s, dict(s.attrs)) for s in tracer.spans()
        if s.name == "engine.quantize" and s.start_s >= t1]
    r.boot["trunk_weights_s"] = t1 - t0
    r.boot["engine_build_s"] = time.perf_counter() - t1
    r.boot["engine_allocated_bytes"] = harness._allocated(r.device) - before
    r.boot["model_tensor_bytes"] = harness._tensor_bytes(
        t for v in engine.model.state_dict().values()
        for t in (v.values() if isinstance(v, dict) else (v,)))
    r.boot["head_slab_bytes"] = harness._tensor_bytes(
        (engine.head_slabs or {}).values())
    del sd
    return engine


def run(r: harness.Run) -> dict:
    t = r.traffic
    cfg = harness.framework_config(r.config)
    cache = harness.start_kernel_builds(cfg, False, r.device)
    work = os.path.join(r.work_dir, "gallery")
    shutil.rmtree(work, ignore_errors=True)
    gallery = traffic.write_gallery(t["gallery"], r.seed, work,
                                    int(r.config["model"]["v_feature_size"]),
                                    r.device)
    from vilbert_multitask_tpu_torch.features.store import FeatureStore

    store = FeatureStore(work, max_cached=int(t["host_cache_entries"]))
    engine = _build(r, cfg, store)
    harness.join_kernels(r, cache)
    r.reset_peak()
    harness.warm(r, engine, cfg.engine.all_row_buckets())
    stream = traffic.question_stream(t["questions"], r.seed, gallery)
    pool = [next(stream) for _ in range(int(t["pool_questions"]))]
    reqs = [engine.prepare_from_store(q.task_id, q.text, q.images)
            for q in pool]
    engine.run_many(reqs)  # the caches a running server holds

    rng = np.random.default_rng([r.seed, 21])
    chosen = set(int(i) for i in rng.permutation(len(pool))[
        :int(t["judge_samples"])])
    chosen.add(max(range(len(pool)), key=lambda i: len(pool[i].images)))
    served = {}
    batch = int(t["batch_questions"])
    done = [0, 0]  # answers, image rows
    traced_buckets = []
    failed = attempted = 0
    stats0 = engine.input_cache_stats

    def untraced():
        s = engine.input_cache_stats
        r.records["untraced"] = dict(
            window_s=time.perf_counter() - start, answers=done[0],
            rows=done[1], cache_hits=s["hits"] - stats0["hits"],
            cache_misses=s["misses"] - stats0["misses"])

    r.tracer.on_start = untraced
    start = r.start_window()
    end = start + r.seconds
    at = 0
    while time.perf_counter() < end:
        r.tracer.step(start)
        idx = [(at + k) % len(pool) for k in range(batch)]
        at = (at + batch) % len(pool)
        chunk = [reqs[i] for i in idx]

        def on_result(pos, res, idx=idx, chunk=chunk):
            if time.perf_counter() > end:
                return
            done[0] += 1
            done[1] += chunk[pos].n_images
            if idx[pos] in chosen:
                served[idx[pos]] = res

        if r.tracer.prof is not None and not r.tracer.done:
            plan = engine.chunk_plan([x.n_images for x in chunk])
            traced_buckets.extend(
                cfg.engine.row_bucket_for(sum(chunk[i].n_images for i in c))
                for c in plan)
        attempted += len(chunk)
        try:
            with harness.labelled("bench.dispatch"):
                engine.run_many(chunk, on_result=on_result)
        except Exception:  # noqa: BLE001 — a failed batch counts
            failed += len(chunk)
    r.tracer.stop()
    r.tracer.on_start = None
    stats1 = engine.input_cache_stats
    r.read_peak()
    r.records.update(
        answers=done[0], rows=done[1], window_s=r.seconds,
        cache_hits=stats1["hits"] - stats0["hits"],
        cache_misses=stats1["misses"] - stats0["misses"],
        traced_buckets=traced_buckets)
    if r.tracer.done:
        from portbench.devtrace import Trace

        tr = Trace.from_profiler(r.tracer.prof, r.work_dir, r.tracer.tid)
        r.records["trace"] = {"obj": tr, "busy_s": tr.busy_s(),
                              "window_s": tr.window_s,
                              "breakdown": tr.breakdown()}
    del engine, store, reqs
    r.release()

    samples = [judge.Sample(pool[i].task_id, pool[i].text, pool[i].images,
                            served[i]) for i in sorted(served)]
    t0 = time.perf_counter()
    ref = Int8Reference(r.config, r.seed, r.device, control=r.control)
    worst = ref.judge(samples)
    del ref
    r.records["judge_s"] = time.perf_counter() - t0
    r.records["judged_samples"] = samples
    shutil.rmtree(work, ignore_errors=True)
    # A question chosen for the comparison whose answer never came fails it.
    worst["judged_missing"] = float(len(chosen) - len(served))
    return {"checks": harness.checks(r, worst), "readings": worst,
            "attempted": attempted, "failed": failed}
