"""Open-loop uploads of novel photos, each with one question about it.

Uploads arrive at the traffic's fixed ``rate`` (``traffic.arrivals``: the
seed's own order of the same gaps in every block of the window); one
worker serves them in order of arrival, each through the program's upload path: the JPEG decoded
with PIL (``LiveFeatureExtractor.extract``), the X-152 detector on the
card, ``InferenceEngine.prepare`` over its regions, ``run`` and the decode.
An upload's latency runs from its due time to its decoded answer, its
service time from the moment the worker takes it up; an upload due in
the window is waited for up to ``drain_s`` after its close,
and one that fails or never comes counts as missing.
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import List, Optional

import numpy as np

from portbench import harness, judge, traffic


class Uploads:
    """The set-up and the serving loop, shared with the mixed cell."""

    def __init__(self, r: harness.Run, *, with_gallery: bool):
        t = r.traffic
        self.r = r
        self.cfg = harness.framework_config(r.config)
        cache = harness.start_kernel_builds(self.cfg, True, r.device)
        self.up_dir = os.path.join(r.work_dir, "uploads")
        self.gal_dir = os.path.join(r.work_dir, "gallery")
        for d in (self.up_dir, self.gal_dir):
            shutil.rmtree(d, ignore_errors=True)
        self.files = traffic.write_uploads(t["uploads"], r.seed, self.up_dir,
                                           r.device)
        self.gallery = store = None
        if with_gallery:
            from vilbert_multitask_tpu_torch.features.store import (
                FeatureStore,
            )

            self.gallery = traffic.write_gallery(
                t["gallery"], r.seed, self.gal_dir,
                int(r.config["model"]["v_feature_size"]), r.device)
            store = FeatureStore(self.gal_dir,
                                 max_cached=int(t["host_cache_entries"]))
        self.store = store
        self.engine = harness.build_engine(r, self.cfg, store, None)
        harness.join_kernels(r, cache)
        self.extractor = harness.build_extractor(r, allow_tf32=r.control)
        r.reset_peak()
        harness.warm_extractor(r, self.extractor)
        harness.warm(r, self.engine, t["buckets"])
        rng = np.random.default_rng([r.seed, 31])
        self.dues = traffic.arrivals(float(t["rate"]), r.seconds, r.seed,
                                     float(t["arrival_block_s"]), 14)
        self.order = [self.files[i % len(self.files)]
                      for i in rng.permutation(len(self.dues))]
        qs = traffic.question_stream(t["upload_questions"], r.seed, None,
                                     tasks=traffic.SINGLE_IMAGE)
        self.questions = [next(qs) for _ in self.dues]
        sizes = {p: os.path.getsize(p) for p in self.files}
        largest = max(range(len(self.order)),
                      key=lambda k: sizes[self.order[k]])
        pick = rng.permutation(len(self.dues))[:int(t["judge_uploads"])]
        self.judged = set(int(k) for k in pick) | {largest}
        # One upload through the whole path before the window: the first
        # real-size resize and decode.
        self.serve(self.files[0], self.questions[0])
        self.latencies: List[float] = []
        self.services: List[float] = []
        self.samples: List[judge.Sample] = []
        self.failed = 0
        self.traced_sizes: List[tuple] = []

    def serve(self, path: str, q):
        region = self.extractor.extract(path)
        req = self.engine.prepare(q.task_id, q.text, [region], [path])
        _, result = self.engine.run(req)
        return region, result

    def loop(self, t0: float, drain_s: float) -> None:
        """Serve every upload due in the window, in order, on this
        thread."""
        r = self.r
        self.t0 = t0
        close = t0 + r.seconds + drain_s
        for k, (due, path, q) in enumerate(zip(self.dues, self.order,
                                               self.questions)):
            r.tracer.step(t0)
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            start = time.perf_counter()
            if start > close:
                self.latencies.extend([math.inf] * (len(self.dues) - k))
                self.services.extend([math.inf] * (len(self.dues) - k))
                self.failed += len(self.dues) - k
                break
            if r.tracer.prof is not None and not r.tracer.done:
                from PIL import Image

                with Image.open(path) as im:
                    self.traced_sizes.append(im.size)
            try:
                with harness.labelled("bench.upload"):
                    region, result = self.serve(path, q)
            except Exception:  # noqa: BLE001 — a failed upload is missing
                self.failed += 1
                self.latencies.append(math.inf)
                self.services.append(math.inf)
                continue
            done = time.perf_counter()
            self.latencies.append(done - (t0 + due))
            self.services.append(done - start)
            if k in self.judged:
                self.samples.append(judge.Sample(
                    q.task_id, q.text, [path], result, upload=True,
                    regions=region))
        r.tracer.stop()

    def finish(self, extra: Optional[dict] = None) -> None:
        """Read the peak and the trace, then free the program's state."""
        r = self.r
        r.read_peak()
        r.records.update(upload_latency_s=self.latencies,
                         upload_service_s=self.services,
                         upload_due_s=[self.t0 + d for d in self.dues],
                         trace_start=r.tracer.t_start,
                         traced_upload_sizes=self.traced_sizes)
        r.records.update(extra or {})
        if r.tracer.done:
            from portbench.devtrace import Trace

            tr = Trace.from_profiler(r.tracer.prof, r.work_dir, r.tracer.tid)
            r.records["trace"] = {"obj": tr, "busy_s": tr.busy_s(),
                                  "window_s": tr.window_s,
                                  "breakdown": tr.breakdown()}
        self.engine = self.extractor = self.store = None
        r.release()

    def judge(self, questions: List[judge.Sample]) -> List[harness.Check]:
        r = self.r
        t0 = time.perf_counter()
        ref = judge.Reference(r.config, r.seed, r.device, detector=True,
                              control=r.control)
        worst = ref.judge(self.samples + questions)
        del ref
        r.records["judge_s"] = time.perf_counter() - t0
        for d in (self.up_dir, self.gal_dir):
            shutil.rmtree(d, ignore_errors=True)
        # An upload chosen for the comparison that never came fails it.
        worst["judged_missing"] = float(len(self.judged) - len(self.samples))
        self.readings = worst
        return harness.checks(r, worst)


def run(r: harness.Run) -> dict:
    u = Uploads(r, with_gallery=False)
    t0 = r.start_window()
    u.loop(t0, float(r.traffic["drain_s"]))
    u.finish()
    checks = u.judge([])
    return {"checks": checks, "readings": u.readings,
            "attempted": len(u.dues), "failed": u.failed}
