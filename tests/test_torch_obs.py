"""The port's span tracing (``vilbert_multitask_tpu_torch.obs``) on the
CPU: a disabled tracer costs a no-op, a profiler makes every tracer record
on every thread and name its ranges after the spans, the export and the
benchmark's calibration put spans on the device trace's clock, and the
engine, the extractor and ``profile_run`` open their spans where the work
happens.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import re
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import spans as bench_spans
from portbench.devtrace import Trace
from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.config import (
    DetectorConfig,
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.engine import profile_run
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
from vilbert_multitask_tpu_torch.features.pipeline import synthetic_regions
from vilbert_multitask_tpu_torch.obs import trace as obs_trace

CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2, 4), throughput_buckets=(8,),
        compute_dtype="float32", device_input_cache_entries=8,
        use_pallas_coattention=False, use_pallas_self_attention=False))
CHUNK_SETS = ("engine.pack", "engine.cache", "engine.upload",
              "engine.replay", "engine.fetch", "engine.decode")


@pytest.fixture
def tracer():
    """The default tracer, emptied and enabled; restored afterwards."""
    t = obs.default_tracer()
    was = t.enabled
    t.clear()
    t.enable()
    yield t
    if not was:
        t.disable()
    t.clear()


@pytest.fixture
def disabled():
    """The default tracer, emptied and disabled; restored afterwards."""
    t = obs.default_tracer()
    was = t.enabled
    t.clear()
    t.disable()
    yield t
    if was:
        t.enable()
    t.clear()


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(CFG, device="cpu")


def _requests(eng, n):
    regions = [synthetic_regions(CFG.model.v_feature_size, n_boxes=5,
                                 seed=i) for i in range(3)]
    return [eng.prepare(1, f"what is in picture {k}", [regions[k % 3]],
                        cache_keys=[f"img{k % 3}"]) for k in range(n)]


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ------------------------------------------------------------ the no-op
def test_a_disabled_span_is_the_shared_noop_and_cheap(disabled):
    assert not obs_trace.Tracer().enabled
    assert obs_trace.Tracer().span("engine.pack") is obs_trace._NOOP
    assert obs.span("engine.pack", bucket=8) is obs_trace._NOOP
    with obs.span("engine.pack") as sp:
        assert not sp.recording
        sp.set(device_ms=1.0)
    assert disabled.spans() == []

    # What a disabled span adds to the code it wraps: the same loop with
    # and without it, in turns, each the least of many short batches (the
    # tests share the host's cores).
    def batch(wrapped: bool, n: int = 1000) -> float:
        t0 = time.perf_counter()
        if wrapped:
            for _ in range(n):
                with obs.span("engine.pack"):
                    pass
        else:
            for _ in range(n):
                pass
        return (time.perf_counter() - t0) / n

    best = {True: float("inf"), False: float("inf")}
    for _ in range(200):
        for wrapped in (True, False):
            best[wrapped] = min(best[wrapped], batch(wrapped))
    cost = best[True] - best[False]
    assert cost < 1e-6, f"{cost * 1e9:.0f} ns a disabled span"


def test_the_ring_counts_what_it_evicts():
    t = obs_trace.Tracer(max_spans=3, enabled=True)
    for k in range(5):
        t.record_span(f"s{k}", start_s=float(k), dur_s=0.5)
    assert [s.name for s in t.spans()] == ["s2", "s3", "s4"]
    assert t.evicted == 2
    assert t.evicted_end_s == 1.5


def test_ids_ignore_the_global_seed_and_differ_in_a_forked_child():
    import os
    import random

    minted = []
    for _ in range(2):
        random.seed(1234)  # as a trainer or an eval script does
        minted.append(obs_trace.new_trace_id())
    assert minted[0] != minted[1]
    read, write = os.pipe()
    pid = os.fork()
    if pid == 0:  # the child: one id through the pipe, then out
        os.write(write, obs_trace.new_trace_id().encode())
        os._exit(0)
    os.close(write)
    child = os.read(read, 64).decode()
    os.close(read)
    os.waitpid(pid, 0)
    assert len(child) == 16 and child != obs_trace.new_trace_id()


def test_a_late_attribute_joins_the_recorded_span(tracer):
    with obs.span("detect.enqueue") as sp:
        pass
    recorded = tracer.spans()[-1]
    before = recorded.attrs
    sp.set(device_ms=2.5)
    assert recorded.attrs == {"device_ms": 2.5}
    assert before == {}  # a reader of the old dict saw no change


# ------------------------------------------------- the profiler and clock
def test_a_profiler_records_spans_and_ranges_on_one_clock(disabled,
                                                          tmp_path):
    """Under a CPU profiler the disabled tracer records each span (a
    second thread's too), the trace holds a ``user_annotation`` range of
    each name on the profiled thread, and the offset calibrated from them
    puts each span within 1 ms of its range and the second thread's span
    inside the range that was open around it."""
    assert not torch.autograd.profiler._is_profiler_enabled

    def other():
        with obs.span("test.other"):
            time.sleep(0.002)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.outer"):
            for _ in range(3):
                with obs.span("test.inner"):
                    time.sleep(0.002)
            th = threading.Thread(target=other, name="other")
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
            time.sleep(0.002)
    assert not torch.autograd.profiler._is_profiler_enabled
    got = disabled.spans()
    names = _by_name(got)
    assert len(names["test.inner"]) == 3
    assert names["test.other"][0].thread_name == "other"
    main_tid = threading.get_native_id()
    assert names["test.outer"][0].thread_id == main_tid
    assert names["test.other"][0].thread_id != main_tid

    path = tmp_path / "device.json"
    prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())
    tr = Trace(exported["traceEvents"], main_tid)
    ranges = [e for e in tr.ranges if e["name"].startswith("test.")]
    assert sorted(e["name"] for e in ranges) == (
        ["test.inner"] * 3 + ["test.outer"])
    assert all(e["cat"] == "user_annotation" and e["tid"] == main_tid
               for e in ranges)
    offset, err = bench_spans.calibrate(tr, got)
    assert err < 1000.0
    for e in ranges:
        s = min((s for s in names[e["name"]]),
                key=lambda s: abs(s.start_s * 1e6 + offset - e["ts"]))
        assert abs(s.start_s * 1e6 + offset - float(e["ts"])) < 1000.0
    outer = next(e for e in ranges if e["name"] == "test.outer")
    placed = names["test.other"][0].start_s * 1e6 + offset
    assert outer["ts"] < placed < outer["ts"] + outer["dur"]

    # The export and the device trace share a frame: ts + base is Unix.
    doc = obs.chrome_trace(spans=names["test.outer"], tracer=disabled)
    event = next(e for e in doc["traceEvents"] if e["ph"] == "X")
    assert event["tid"] == main_tid
    shift = (doc["baseTimeNanoseconds"] - exported["baseTimeNanoseconds"])
    assert abs(event["ts"] + shift / 1e3 - float(outer["ts"])) < 50e3


def test_chrome_trace_stamps_unix_time(tracer):
    before = time.time_ns()
    with obs.span("test.fresh"):
        pass
    doc = obs.chrome_trace(tracer=tracer)
    after = time.time_ns()
    event = next(e for e in doc["traceEvents"] if e["name"] == "test.fresh")
    unix_ns = event["ts"] * 1e3 + doc["baseTimeNanoseconds"]
    assert before - 1e9 < unix_ns < after + 1e9
    assert event["tid"] == threading.get_native_id()


# ------------------------------------------------------ where spans open
def test_run_many_opens_one_set_of_spans_a_chunk(engine, tracer):
    reqs = _requests(engine, 6)
    assert len(engine.chunk_plan([1] * 6, chunk_rows=4)) == 2
    engine.run_many(reqs, chunk_rows=4)
    names = _by_name(tracer.spans())
    [run] = names["engine.run_many"]
    assert run.attrs["n_chunks"] == 2
    for name in CHUNK_SETS:
        assert len(names[name]) == 2, name
        assert all(s.parent_id == run.span_id for s in names[name]), name
    assert [s.attrs["graph"] for s in names["engine.replay"]] == [False,
                                                                   False]
    assert [s.attrs["bucket"] for s in names["engine.replay"]] == [4, 2]
    looked_up = [s.attrs["hits"] + s.attrs["misses"]
                 for s in names["engine.cache"]]
    assert looked_up == [4, 2]
    # The CPU has no events: no device time.
    assert all("device_ms" not in s.attrs for s in names["engine.fetch"])


def test_prepare_opens_one_parent_over_its_stages(engine, tracer):
    _requests(engine, 1)
    names = _by_name(tracer.spans())
    [prep] = names["engine.prepare"]
    assert names["engine.tokenize"][0].parent_id == prep.span_id
    [feats] = names["engine.features"]
    assert feats.parent_id == prep.span_id
    assert feats.attrs["source"] == "encode"


def test_the_extractor_opens_a_span_a_stage(tracer, tmp_path):
    from PIL import Image

    from vilbert_multitask_tpu_torch.detect.extractor import (
        LiveFeatureExtractor,
    )

    path = tmp_path / "upload.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (40, 50, 3), np.uint8)).save(path)
    ex = LiveFeatureExtractor(DetectorConfig().tiny(), seed=3, num_keep=10,
                              device="cpu")
    tracer.clear()
    ex.extract(str(path))
    names = _by_name(tracer.spans())
    for name in ("detect.decode", "detect.preprocess", "detect.enqueue",
                 "detect.select", "detect.host_copy", "detect.backbone",
                 "detect.fpn", "detect.rpn", "detect.roi_align",
                 "detect.box_head"):
        assert len(names[name]) == 1, name
    enqueue = names["detect.enqueue"][0]
    assert names["detect.backbone"][0].parent_id == enqueue.span_id
    assert names["detect.box_head"][0].parent_id == enqueue.span_id
    order = [s.name for s in sorted(tracer.spans(), key=lambda s: s.start_s)
             if s.parent_id is None]
    assert order == ["detect.decode", "detect.preprocess", "detect.enqueue",
                     "detect.select", "detect.host_copy"]


def test_profile_run_stage_sums_are_the_histogram_deltas(engine, disabled):
    req = _requests(engine, 1)[0]
    before = obs.span_totals()
    stages = profile_run.stage_ms(lambda: engine.run(req), reps=3)
    after = obs.span_totals()
    assert not disabled.enabled  # enabled for the reps only
    names = _by_name(disabled.spans())
    assert set(stages) == set(names) == {
        "engine.forward", "engine.pack", "engine.cache", "engine.upload",
        "engine.replay", "engine.fetch", "engine.decode"}
    for name, got in stages.items():
        assert got["calls_per_run"] == 1.0
        ms = sum(s.dur_s for s in names[name]) * 1e3 / 3
        assert got["ms_per_run"] == pytest.approx(ms, rel=1e-9, abs=1e-9)
        delta = (after[name][0] - before.get(name, (0.0, 0))[0]) / 3
        assert got["ms_per_run"] == pytest.approx(delta, rel=1e-12)


# ------------------------------------------------------- the serve tier
def test_a_booted_server_serves_its_span_histogram(engine, tmp_path):
    from vilbert_multitask_tpu_torch.serve.app import ServeApp

    t = obs.default_tracer()
    was = t.enabled
    t.disable()
    cfg = dataclasses.replace(CFG, serving=dataclasses.replace(
        CFG.serving, queue_db_path=str(tmp_path / "q.sqlite3"),
        results_db_path=str(tmp_path / "r.sqlite3"),
        media_root=str(tmp_path / "media"), http_port=0, ws_port=0,
        sampler_cadence_s=0.2))
    before = obs.span_totals().get("serve.warmup", (0.0, 0))[1]
    try:
        app = ServeApp(cfg, engine=engine, feature_root=str(tmp_path),
                       device="cpu")
        assert t.enabled
        app.warm()
        app.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                              timeout=10)
            conn.request("GET", "/metrics?format=prometheus")
            resp = conn.getresponse()
            body = resp.read().decode()
            assert resp.status == 200
        finally:
            app.stop()
    finally:
        if not was:
            t.disable()
    counts = [int(m) for m in re.findall(
        r'vmt_span_ms_count\{name="serve.warmup"[^}]*\} (\d+)', body)]
    assert counts and sum(counts) > before
