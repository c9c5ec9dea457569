"""The readers of the program's spans (``portbench/spans.py`` and the four
metrics that read it) and of its ``engine.replay`` ranges
(``chunk_device_ms``): fed made-up spans and a made-up trace whose clock
lies a known offset from the spans', each reads the number the spans or
the trace give, and none reads a window whose spans the ring has evicted
or a program that keeps none."""

import math
import types

import pytest

from portbench import spans
from portbench.devtrace import Trace
from portbench.harness import load_module
from vilbert_multitask_tpu_torch.obs.trace import Span

OFFSET = 5.0e6  # trace µs = span start · 1e6 + OFFSET
T0 = 100.0  # the profiler's start, on the spans' clock (s)
TID, OTHER = 11, 12


def _span(name, start, dur, tid=TID, thread="MainThread", **attrs):
    return Span(name, "t", f"{name}@{start}", None, T0 + start, dur, tid,
                thread, attrs)


def _trace(busy=(), ranged=(), window_s=1.0):
    """A trace of ``window_s`` from T0 with device operations over
    ``busy`` (s after T0) and a host range on the profiled thread for each
    span of ``ranged``, 3 µs after the span began."""
    us = lambda s: T0 * 1e6 + OFFSET + s * 1e6  # noqa: E731
    events = [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
               "ts": us(0), "dur": window_s * 1e6}]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": us(a),
                "dur": (b - a) * 1e6} for a, b in busy]
    events += [{"ph": "X", "cat": "user_annotation", "name": s.name,
                "tid": TID, "ts": s.start_s * 1e6 + OFFSET + 3.0,
                "dur": s.dur_s * 1e6} for s in ranged]
    return Trace(events, TID)


def _run(monkeypatch, got, trace, evicted_end=-math.inf):
    tracer = types.SimpleNamespace(spans=lambda: list(got),
                                   evicted_end_s=evicted_end)
    monkeypatch.setattr(spans, "program_tracer", lambda: tracer)
    return types.SimpleNamespace(
        records={"trace": {"obj": trace, "busy_s": trace.busy_s(),
                           "window_s": trace.window_s}},
        tracer=types.SimpleNamespace(t_start=T0, t_stop=T0 + 1.0))


def _chunk(at, device_ms):
    """One chunk's spans: 5 ms of host work and a 10 ms wait."""
    return [_span("engine.pack", at, 0.001),
            _span("engine.cache", at + 0.001, 0.0005),
            _span("engine.upload", at + 0.0015, 0.0005),
            _span("engine.replay", at + 0.002, 0.002),
            _span("engine.fetch", at + 0.004, 0.010, device_ms=device_ms),
            _span("engine.decode", at + 0.014, 0.001)]


def _read(name, run):
    return load_module("metrics", name).read(run)


def test_dispatch_and_device_time_per_chunk(monkeypatch):
    got = ([_span("engine.run_many", 0.1, 0.05)] + _chunk(0.1, 3.0)
           + _chunk(0.12, 5.0)
           + [_span("engine.pack", 1.5, 0.001)])  # after the window
    run = _run(monkeypatch, got, _trace())
    assert _read("dispatch_host_ms.prepared", run) == pytest.approx(5.0)


def _replay_trace(with_ranges=True):
    """Two ``engine.replay`` ranges on the profiled thread, each with a
    launch (correlations 1 and 2): chunk 1's kernels overlap over 3 ms,
    chunk 2's one runs 4 ms, 1 ms of it past the window's end. A copy
    launched outside the ranges (3) and a launch of another thread inside
    one (4) are not a chunk's."""
    us = lambda s: T0 * 1e6 + OFFSET + s * 1e6  # noqa: E731
    events = [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
               "ts": us(0), "dur": 1e6}]
    if with_ranges:
        events += [{"ph": "X", "cat": "user_annotation",
                    "name": "engine.replay", "tid": TID, "ts": us(a),
                    "dur": 500.0} for a in (0.1, 0.9)]
    for corr, tid, at in ((1, TID, 0.1001), (2, TID, 0.9001),
                          (3, TID, 0.5), (4, OTHER, 0.1002)):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaGraphLaunch", "tid": tid, "ts": us(at),
                       "dur": 10.0, "args": {"correlation": corr}})
    for corr, a, b in ((1, 0.100, 0.102), (1, 0.101, 0.103),
                       (2, 0.997, 1.001), (3, 0.5, 0.6), (4, 0.2, 0.3)):
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": us(a), "dur": (b - a) * 1e6,
                       "args": {"correlation": corr}})
    return Trace(events, TID)


def test_device_time_per_chunk_is_what_each_replay_launched(monkeypatch):
    # (3 ms + the 3 ms of chunk 2's kernel inside the window) / 2 chunks.
    run = _run(monkeypatch, [], _replay_trace())
    assert _read("chunk_device_ms.prepared", run) == pytest.approx(3.0)
    # A program without the replay's ranges (the spans are newer than it),
    # or an untraced run: nothing to read, no raise.
    assert _read("chunk_device_ms.prepared", _run(
        monkeypatch, [], _replay_trace(with_ranges=False))) is None
    untraced = types.SimpleNamespace(records={}, tracer=run.tracer)
    assert _read("chunk_device_ms.prepared", untraced) is None


def test_detector_enqueue_per_image(monkeypatch):
    got = [_span("detect.enqueue", 0.1, 0.080, device_ms=150.0),
           _span("detect.enqueue", 0.5, 0.100, device_ms=151.0),
           _span("detect.backbone", 0.1, 0.050)]
    run = _run(monkeypatch, got, _trace())
    for name in ("detect_enqueue_ms.poisson", "detect_enqueue_ms.mixed"):
        assert _read(name, run) == pytest.approx(90.0)


def test_idle_inside_the_question_threads_spans(monkeypatch):
    # Calibrated on the upload thread (two names, one span cut by the
    # profiler's stop has no range); the question thread's spans placed by
    # that offset: idle 0.3-0.4 s inside the prepare, 0.7-0.9 s inside
    # run_many, of a 1 s window.
    upload = [_span("detect.enqueue", 0.05, 0.08),
              _span("detect.enqueue", 0.45, 0.08),
              _span("engine.forward", 0.2, 0.01),
              _span("engine.forward", 0.99, 0.02)]
    questions = [
        _span("engine.prepare", 0.2, 0.2, OTHER, "questions"),
        _span("engine.run_many", 0.65, 0.25, OTHER, "questions"),
        _span("engine.prepare", 0.0, 0.9, OTHER, "uploads")]
    trace = _trace(busy=[(0.0, 0.3), (0.6, 0.7)], ranged=upload[:3])
    run = _run(monkeypatch, upload + questions, trace)
    offset, err = spans.calibrate(trace, upload + questions)
    assert offset == pytest.approx(OFFSET + 3.0)
    assert err == pytest.approx(0.0, abs=1e-6)
    assert _read("idle_in_questions.mixed", run) == pytest.approx(
        30.0, abs=1e-3)


def test_calibration_pairs_each_name_in_order_past_cut_spans():
    # Evenly spaced spans of their own lengths; ranges for spans 1..3
    # only, jittered 0, 2, 4 µs: the median 2 µs.
    got = [_span("engine.pack", 0.01 * k, 0.001 * (1 + k % 3))
           for k in range(5)]
    events = [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
               "ts": T0 * 1e6 + OFFSET, "dur": 1e6}]
    events += [{"ph": "X", "cat": "user_annotation", "name": "engine.pack",
                "tid": TID, "ts": got[k].start_s * 1e6 + OFFSET + 2.0 * j,
                "dur": got[k].dur_s * 1e6} for j, k in enumerate((1, 2, 3))]
    events.append({"ph": "X", "cat": "user_annotation", "name": "bench.x",
                   "tid": TID, "ts": T0 * 1e6, "dur": 1.0})
    offset, err = spans.calibrate(Trace(events, TID), got)
    assert offset == pytest.approx(OFFSET + 2.0)
    assert err == pytest.approx(2.0)
    assert spans.calibrate(Trace(events[:1], TID), got) is None


@pytest.mark.parametrize("name", [
    "dispatch_host_ms.prepared", "detect_enqueue_ms.poisson",
    "detect_enqueue_ms.mixed", "idle_in_questions.mixed"])
def test_no_number_from_a_window_the_ring_lost_part_of(monkeypatch, name):
    got = (_chunk(0.1, 3.0) + [_span("detect.enqueue", 0.1, 0.08)]
           + [_span("engine.prepare", 0.2, 0.2, OTHER, "questions")])
    trace = _trace(busy=[(0.0, 0.3)], ranged=got[:1])
    assert _read(name, _run(monkeypatch, got, trace)) is not None
    # A span that ended inside the window was evicted.
    assert _read(name, _run(monkeypatch, got, trace,
                            evicted_end=T0 + 0.05)) is None
    # Evictions from before the window do not matter.
    assert _read(name, _run(monkeypatch, got, trace,
                            evicted_end=T0 - 1.0)) is not None


@pytest.mark.parametrize("name", [
    "dispatch_host_ms.prepared", "detect_enqueue_ms.poisson",
    "idle_in_questions.mixed"])
def test_no_number_from_a_program_without_the_spans(monkeypatch, name):
    # A program whose tracer keeps no eviction count (the spans' readers
    # are newer than it) or an untraced run: nothing to read, no raise.
    got = _chunk(0.1, 3.0)
    run = _run(monkeypatch, got, _trace(ranged=got[:1]))
    monkeypatch.setattr(spans, "program_tracer",
                        lambda: types.SimpleNamespace(spans=lambda: got))
    assert _read(name, run) is None
    untraced = types.SimpleNamespace(records={}, tracer=run.tracer)
    assert _read(name, untraced) is None
