"""Uploads and gallery questions on one card, as a demo server sees them.

The uploads of ``uploads.py`` at the same fixed rate, served on the main
thread, and beside them a second open-loop stream of gallery questions
(the eight-task mix, ``questions_per_upload`` per upload) served on a
thread of its own: it waits for the next due question, prepares every
question due by then (up to ``max_rows`` image rows) with
``prepare_from_store`` (the benchmark's clock around it gives
``prep_ms.mixed``) and hands them to ``run_many``. The two threads
share the card (each the program's own stream) and the interpreter. A
question's latency runs from its due time to its decoded answer.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from portbench import harness, judge, traffic
from portbench.drivers.uploads import Uploads


def run(r: harness.Run) -> dict:
    t = r.traffic
    u = Uploads(r, with_gallery=True)
    engine = u.engine
    rate = float(t["rate"]) * float(t["questions_per_upload"])
    dues = traffic.arrivals(rate, r.seconds, r.seed,
                            float(t["arrival_block_s"]), 15)
    stream = traffic.question_stream(t["questions"], r.seed, u.gallery)
    qs = [next(stream) for _ in dues]
    # The caches a running server holds: fill them with questions drawn
    # as the window's are.
    warm = traffic.question_stream(t["questions"], r.seed + 1, u.gallery)
    engine.run_many([engine.prepare_from_store(q.task_id, q.text, q.images)
                     for q in (next(warm) for _ in range(
                         int(t["warm_questions"])))])
    max_rows = int(t["max_rows"])
    drain_s = float(t["drain_s"])
    latency = [math.inf] * len(dues)
    waits, preps = [], []
    kept, longest = [], {"n": 0, "sample": None}
    keep_every = int(t["sample_every"])
    failed = [0]

    def questions(t0: float) -> None:
        close = t0 + r.seconds + drain_s
        i = 0
        while i < len(dues) and time.perf_counter() < close:
            wait = t0 + dues[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            now = time.perf_counter()
            batch, rows = [], 0
            while (i < len(dues) and t0 + dues[i] <= now
                   and rows + len(qs[i].images) <= max_rows):
                batch.append(i)
                rows += len(qs[i].images)
                i += 1
            if not batch:  # one request larger than max_rows alone
                batch, i = [i], i + 1
            try:
                reqs = [engine.prepare_from_store(qs[j].task_id, qs[j].text,
                                                  qs[j].images)
                        for j in batch]
            except Exception:  # noqa: BLE001 — a failed request is missing
                failed[0] += len(batch)
                continue
            called = time.perf_counter()
            preps.append((now, called - now, len(batch)))
            waits.extend((t0 + dues[j], called - (t0 + dues[j]))
                         for j in batch)

            def on_result(pos, res, batch=batch):
                j = batch[pos]
                latency[j] = time.perf_counter() - (t0 + dues[j])
                q = qs[j]
                sample = judge.Sample(q.task_id, q.text, q.images, res)
                if j % keep_every == 0:
                    kept.append(sample)
                if len(q.images) > longest["n"]:
                    longest.update(n=len(q.images), sample=sample)

            try:
                engine.run_many(reqs, on_result=on_result)
            except Exception:  # noqa: BLE001 — a failed batch is missing
                failed[0] += len(batch)

    t0 = r.start_window()
    worker = threading.Thread(target=questions, args=(t0,), name="questions",
                              daemon=True)
    worker.start()
    u.loop(t0, drain_s)
    worker.join(timeout=r.seconds + 2 * drain_s)
    u.finish({"answer_latency_s": latency, "waits": waits, "preps": preps,
              "trace_start": r.tracer.t_start})
    del engine

    rng = np.random.default_rng([r.seed, 22])
    samples = judge.pick(rng, kept, int(t["judge_samples"]),
                         longest["sample"])
    checks = u.judge(samples)
    return {"checks": checks, "readings": u.readings,
            "attempted": len(u.dues) + len(dues),
            "failed": u.failed + failed[0]}
