"""Closed-loop batched answers on precomputed features, prepared ahead:
the engine's dispatch, forward and decode, with host preparation outside
the window.

Set-up prepares a pool of ``pool_questions`` questions from the seed's
stream (``InferenceEngine.prepare_from_store``: tokenize, read the gallery
file, encode the regions) and runs the pool once to fill the caches a
running server holds. The window hands ``run_many`` ``batch_questions`` of
the pool at a time, round and round: it packs them into row-bucket
chunks, runs the forwards through the captured graphs and streams each
decoded answer to ``on_result``. An answer counts when it is decoded
inside the window. Every answer's rows are looked up in the device input
cache by their gallery file, so the cache sees the gallery's Zipf
popularity. A prepared request is served many times over: what this
measures is the rate the engine answers at once its input is ready, not
what a user who also waits for the preparation sees.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from portbench import harness, judge, traffic


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
    engine = harness.build_engine(r, cfg, store, None)
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
    ref = judge.Reference(r.config, r.seed, r.device, control=r.control)
    worst = ref.judge(samples)
    del ref
    r.records["judge_s"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    # A question chosen for the comparison whose answer never came fails it.
    worst["judged_missing"] = float(len(chosen) - len(served))
    return {"checks": harness.checks(r, worst), "readings": worst,
            "attempted": attempted, "failed": failed}
