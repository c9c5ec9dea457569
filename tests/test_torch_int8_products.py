"""What the int8 storage mode tells its readers on the CPU: the
``engine.quantize`` span around the host quantization of a floating tree
(the benchmark's ``quantize_s.int8`` reads it), and the count of int8
products each warmed bucket makes, by the kernel
``ops/int8_linear.py:plan_launch`` plans for its shape
(``InferenceEngine.int8_product_stats``; ``/metrics`` exports it as
``vmt_int8_products``)."""

from __future__ import annotations

import collections
import types

import pytest
import torch

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.config import (
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.engine.runtime import (
    InferenceEngine,
    init_state_dict,
)
from vilbert_multitask_tpu_torch.ops import int8_linear as int8_ops

MODEL = ViLBertConfig().tiny()
BUCKETS = (1, 2, 4, 16, 32)


def _cfg(param_dtype="int8", compute_dtype="bfloat16"):
    return FrameworkConfig(model=MODEL, engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=BUCKETS[:3], throughput_buckets=BUCKETS[3:],
        compute_dtype=compute_dtype, param_dtype=param_dtype,
        device_input_cache_entries=4))


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


def _quantize_spans(t):
    return [s for s in t.spans() if s.name == "engine.quantize"]


def test_an_int8_build_opens_one_quantize_span(tracer):
    params = init_state_dict(MODEL, seed=3)
    floating = [v for v in params.values()
                if torch.as_tensor(v).is_floating_point()
                and torch.as_tensor(v).dim() >= 2]
    eng = InferenceEngine(_cfg(), params=params, device="cpu")
    [span] = _quantize_spans(tracer)
    assert span.attrs["leaves"] == len(floating)
    assert span.attrs["bytes"] == sum(
        torch.as_tensor(v).numel() * torch.as_tensor(v).element_size()
        for v in floating)
    assert span.dur_s > 0
    # A tree already quantized (a restored int8 checkpoint) passes through.
    tracer.clear()
    eng.load_params(eng.state_dict())
    assert _quantize_spans(tracer) == []


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_a_floating_build_opens_no_quantize_span(tracer, param_dtype):
    InferenceEngine(_cfg(param_dtype), params=init_state_dict(MODEL, seed=3),
                    device="cpu")
    assert _quantize_spans(tracer) == []


@pytest.fixture(scope="module")
def warmed():
    eng = InferenceEngine(_cfg(), params=init_state_dict(MODEL, seed=4),
                          device="cpu")
    eng.warmup()
    return eng


def _plain_launches(monkeypatch, eng, bucket):
    """The plain route's int8 products in one forward of ``bucket`` rows,
    each labelled by the kernel :func:`plan_launch` plans for its shape."""
    seen = collections.Counter()
    plain = int8_ops.int8_linear_plain

    def spy(x, q, scale, bias=None):
        batch = q.shape[0] if q.dim() == 3 else 1
        if x.dtype == torch.bfloat16:
            plan = int8_ops.plan_launch(x.shape[-2], q.shape[-2],
                                        q.shape[-1], batch)
            seen["wgmma" if plan.regime == "wgmma"
                 else f"stream_s{plan.splits}"] += 1
        else:
            seen["f32"] += 1
        return plain(x, q, scale, bias)

    monkeypatch.setattr(int8_ops, "int8_linear_plain", spy)
    nt = eng.cfg.engine.max_text_len
    pack = torch.zeros((bucket, 3 * nt + 2), dtype=torch.long)
    pack[:, 2 * nt:3 * nt] = 1
    with torch.inference_mode():
        eng._rows_step(pack)
    monkeypatch.undo()
    return dict(seen)


@pytest.mark.parametrize("bucket", BUCKETS)
def test_the_product_counter_is_what_the_plain_route_launches(
        monkeypatch, warmed, bucket):
    got = warmed.int8_product_stats
    assert sorted(got) == sorted(BUCKETS)
    assert got[bucket] == _plain_launches(monkeypatch, warmed, bucket)
    # The trunk's 6 products a layer, 12 a bridge, the embeddings' and the
    # poolers' 2 each, and the fused heads' 5 (7 at an even bucket).
    m = MODEL
    trunk = (6 * (m.num_hidden_layers + m.v_num_hidden_layers)
             + 12 * len(m.v_biattention_id) + 4)
    assert sum(got[bucket].values()) == trunk + 5 + 2 * (bucket % 2 == 0)


def test_kernel_labels_follow_the_plan(warmed):
    got = warmed.int8_product_stats
    # 32 rows of 9 regions (288) stay under the wgmma kernel's 512; the
    # text's 32 x 13 = 416 too: every product streams at this size.
    assert all(k.startswith("stream_s") for k in got[32])
    assert int8_ops.kernel_label(torch.bfloat16, 32 * 101, 1024, 1024) \
        == "wgmma"
    assert int8_ops.kernel_label(torch.bfloat16, 1, 4096, 1024) == \
        f"stream_s{int8_ops.plan_launch(1, 4096, 1024).splits}"
    assert int8_ops.kernel_label(torch.float32, 1, 8, 8) == "f32"


def test_a_floating_engine_counts_no_products():
    eng = InferenceEngine(_cfg("float32"),
                          params=init_state_dict(MODEL, seed=4),
                          device="cpu")
    eng.warmup(buckets=[1, 2])
    assert eng.int8_product_stats == {}


def test_an_f32_int8_engine_labels_its_products_f32():
    eng = InferenceEngine(_cfg("int8", "float32"),
                          params=init_state_dict(MODEL, seed=4),
                          device="cpu")
    eng.warmup(buckets=[1])
    assert set(eng.int8_product_stats[1]) == {"f32"}


def test_metrics_exports_the_product_counter(warmed):
    from vilbert_multitask_tpu_torch.serve.http_api import ApiServer

    queue = types.SimpleNamespace(counts=lambda: {})
    api = ApiServer(queue, None, None, stats_fn=lambda: {
        "input_cache": warmed.input_cache_stats,
        "int8_products": warmed.int8_product_stats})
    api.refresh_gauges()
    text = obs.render_prometheus()
    for bucket, kernels in warmed.int8_product_stats.items():
        for kernel, n in kernels.items():
            line = (f'vmt_int8_products{{bucket="{bucket}",'
                    f'kernel="{kernel}"}}')
            assert any(row.startswith(line) and float(row.split()[-1]) == n
                       for row in text.splitlines()), line


def test_the_tally_nests():
    x = torch.zeros(2, 16, dtype=torch.bfloat16)
    q = torch.zeros(8, 16, dtype=torch.int8)
    s = torch.ones(8)
    with int8_ops.planned_kernels() as outer:
        int8_ops.int8_linear(x, q, s)
        with int8_ops.planned_kernels() as inner:
            int8_ops.int8_linear(x, q, s)
        int8_ops.int8_linear(x, q, s)
    label = int8_ops.kernel_label(torch.bfloat16, 2, 8, 16)
    assert inner.counts == {label: 1}
    assert outer.counts == {label: 2}
    int8_ops.int8_linear(x, q, s)  # no tally open: nothing counted
    assert outer.counts == {label: 2}
