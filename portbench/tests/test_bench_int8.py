"""The ``int8-prepared`` cell's own files at toy sizes on the CPU: its
driver judges the int8 engine's answers correct against the reference on
the int8 storage, which lies nearer them than the float-weight reference;
the int8 GEMM's bytes and operations against a count written out per
matrix; and the cell's three readers on made-up traces and spans. On the
card (``-m cuda``), the cell's control comes out not correct."""

import json
import os
import subprocess
import sys
import types

import pytest

from portbench import harness, int8_bounds, judge, traffic
from portbench.devtrace import Trace
from portbench.harness import load_module
from portbench.reference import vilbert as ref_vil
from portbench.tests.tiny import drive, tiny_run

CELL = "int8-prepared"


def _limits():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return harness.load_json(harness.ROOT, conf["file"])["limits"]


@pytest.fixture(scope="module", params=[7, 2 ** 31 + 11])
def served(request, tmp_path_factory):
    r = tiny_run(CELL, seed=request.param, seconds=8.0, limits=_limits(),
                 work_dir=str(tmp_path_factory.mktemp("int8")))
    return r, drive(r)


def test_a_tiny_int8_run_is_judged_correct(served):
    r, line = served
    assert r.config["engine"]["param_dtype"] == "int8"
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"answers_per_s", "setup_s"}  # no peak
    # The engine's build quantized the seeded tree once, in one span.
    [(seconds, attrs)] = r.records["quantize_spans"]
    assert seconds > 0 and attrs["leaves"] > 0 and attrs["bytes"] > 0


def test_the_float_weight_reference_reads_farther(served):
    r, line = served
    samples = r.records["judged_samples"]
    assert samples
    # The driver removed the gallery; the seed writes the same files again.
    traffic.write_gallery(r.traffic["gallery"], r.seed,
                          r.work_dir + "/gallery",
                          int(r.config["model"]["v_feature_size"]), r.device)
    f32 = judge.Reference(r.config, r.seed, r.device).judge(samples)
    int8 = line["checks"]["answer_logp_mean"]["value"]
    assert f32["answer_logp_mean"] > int8


def test_a_traced_tiny_run_reads_the_quantize_span(tmp_path):
    r = tiny_run(CELL, seconds=3.0, trace=True, work_dir=str(tmp_path))
    line = drive(r)
    # No device on the CPU: the two kernel readers find nothing to read.
    assert set(line["metrics"]) == {"quantize_s.int8"}
    assert line["metrics"]["quantize_s.int8"]["value"] == pytest.approx(
        r.records["quantize_spans"][0][0])


# ------------------------------------------------ bytes and operations
FULL = harness.load_json(harness.ROOT, "portbench/configs/"
                         "vilbert-12in1-int8.json")


def _rows(key, B, e):
    """Rows a matrix multiplies in a forward of B rows."""
    nt, nv = B * (e["max_text_len"] + 1), B * e["max_regions"]
    if key.startswith(("bert.v_embeddings", "bert.encoder.v_layer",
                       "vision_logit")):
        return nv
    if key.startswith(("bert.encoder.layer", "linguisic_logit")):
        return nt
    if key.startswith("bert.encoder.c_layer"):
        visual = ("query1", "key1", "value1", "dense1", "v_intermediate",
                  "v_output")
        return nv if any(f".{v}" in key for v in visual) else nt
    if key.startswith("vil_binary_prediction"):
        return B // 2
    return B  # the poolers and the pooled heads


def _hand_count(B):
    """(bytes, operations) summed matrix by matrix over the served
    Linears: each int8 weight, its f32 scales and bf16 bias once; x and y in
    bf16 once a product; the label pair's first layer reads x once for both
    heads, and so do ``vil_logit`` and ``vil_tri_prediction`` (one
    product)."""
    m, e = FULL["model"], FULL["engine"]
    d = ref_vil.Dims.from_config(m)
    n_bytes = flops = 0
    for key, shape, kind in ref_vil.param_shapes(d):
        if kind != "linear" or key.startswith("cls."):
            continue
        if key.startswith("vil_binary_prediction") and B % 2:
            continue
        n, k = shape
        rows = _rows(key, B, e)
        n_bytes += n * k + 6 * n + 2 * rows * n + 2 * rows * k
        flops += 2 * rows * n * k
    # One read of the pooled rows for each of the two fused pairs.
    n_bytes -= 2 * 2 * B * d.bi_hidden_size
    return n_bytes, flops


@pytest.mark.parametrize("B", [1, 32])
def test_bytes_and_operations_match_a_hand_count(B):
    m, e = FULL["model"], FULL["engine"]
    launches = int8_bounds.forward_products(m, e, B)
    assert len(launches) == (189 if B % 2 else 191)
    n_bytes, flops = _hand_count(B)
    assert sum(map(int8_bounds.launch_bytes, launches)) == n_bytes
    assert sum(map(int8_bounds.launch_flops, launches)) == flops
    n, bound = int8_bounds.forward_int8_bound(m, e, B)
    assert n == len(launches)
    assert bound == pytest.approx(sum(
        max(int8_bounds.launch_bytes(x) / 3.35e12,
            int8_bounds.launch_flops(x) / 989.4e12) for x in launches))


# ------------------------------------------------------------ readers
T0 = 1000.0  # µs


def _trace(with_ranges=True):
    """One ``engine.replay`` range on thread 11 whose graph launch
    (correlation 1) runs two int8 kernels of 30 and 50 µs and another
    kernel of 20; an int8 kernel of 40 µs launched outside the range
    (correlation 2)."""
    events = [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
               "ts": T0, "dur": 1000.0}]
    if with_ranges:
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "engine.replay", "tid": 11, "ts": T0 + 10,
                       "dur": 20.0})
    for corr, at in ((1, T0 + 12), (2, T0 + 500)):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaGraphLaunch", "tid": 11, "ts": at,
                       "dur": 5.0, "args": {"correlation": corr}})
    for corr, name, at, dur in (
            (1, "int8_linear_bf16_stream_kernel", 100, 30),
            (1, "int8_linear_bf16_wgmma_kernel", 130, 50),
            (1, "flash_attn_bf16_kernel", 180, 20),
            (2, "int8_linear_bf16_stream_kernel", 600, 40)):
        events.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": T0 + at, "dur": float(dur),
                       "args": {"correlation": corr}})
    return Trace(events, 11)


def _run(trace=None, buckets=(), spans=None):
    rec = {"traced_buckets": list(buckets)}
    if trace is not None:
        rec["trace"] = {"obj": trace, "busy_s": trace.busy_s(),
                        "window_s": trace.window_s}
    if spans is not None:
        rec["quantize_spans"] = spans
    return types.SimpleNamespace(records=rec, config=FULL)


def _read(name, run):
    return load_module("metrics", name).read(run)


def test_int8_linear_ms_reads_the_replays_int8_kernels():
    # 30 + 50 µs in the one replay's launch: 0.08 ms a chunk.
    assert _read("int8_linear_ms.int8", _run(_trace())) == pytest.approx(
        0.08)
    assert _read("int8_linear_ms.int8",
                 _run(_trace(with_ranges=False))) is None
    assert _read("int8_linear_ms.int8", _run()) is None


def test_int8_roofline_scales_the_bound_by_the_launches_seen():
    m, e = FULL["model"], FULL["engine"]
    n, bound = int8_bounds.forward_int8_bound(m, e, 32)
    # 3 int8 launches seen of the 2 x 191 two 32-row forwards make.
    want = 100.0 * 2 * bound * 3 / (2 * n) / 120e-6
    got = _read("int8_roofline.int8", _run(_trace(), buckets=[32, 32]))
    assert got == pytest.approx(want)
    assert _read("int8_roofline.int8", _run(_trace())) is None
    no_int8 = Trace([{"ph": "X", "cat": "kernel", "name": "k", "ts": T0,
                      "dur": 5.0}], 11)
    assert _read("int8_roofline.int8", _run(no_int8, buckets=[1])) is None


def test_quantize_s_sums_the_builds_spans():
    assert _read("quantize_s.int8", _run(spans=[
        (1.5, {"leaves": 10}), (0.25, {"leaves": 2})])) == pytest.approx(1.75)
    # A program without the span: nothing to read, no raise.
    assert _read("quantize_s.int8", _run(spans=[])) is None
    assert _read("quantize_s.int8", _run()) is None


@pytest.mark.cuda
def test_the_control_is_not_correct(card, tmp_path):
    """The int8-storage reference in fp8 compute, put in the program's
    place at the cell's own size over a short window, fails a limit."""
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL,
         "--seed", "2718281828", "--seconds", "10", "--trace", "0",
         "--control"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
    assert any(float(c["value"]) > c["limit"]
               for c in line["checks"].values())
