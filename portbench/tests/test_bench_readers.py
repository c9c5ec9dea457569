"""The upload time readers: every upload due in the window counts, a
missing one is infinite, and a traced run counts only the uploads due
before its profiler started."""

import math
import types

import pytest

from portbench.harness import load_module

P95 = load_module("metrics", "upload_p95_ms")
SERVICE = load_module("metrics", "upload_service_ms")


def _run(latencies, dues, trace_start=None, services=None):
    return types.SimpleNamespace(records={
        "upload_latency_s": latencies, "upload_due_s": dues,
        "upload_service_s": services if services is not None
        else latencies, "trace_start": trace_start})


def test_every_upload_counts_without_a_trace():
    lat = [0.1 * (k + 1) for k in range(21)]
    r = _run(lat, [float(k) for k in range(21)], services=[0.1] * 20 + [2.1])
    assert P95.read(r) == pytest.approx(2000.0)
    assert SERVICE.read(r) == pytest.approx(4100.0 / 21)  # the mean


def test_a_traced_run_counts_the_uploads_due_before_the_profiler():
    lat = [0.2] * 10 + [5.0] * 10
    r = _run(lat, [float(k) for k in range(20)], trace_start=10.0)
    assert P95.read(r) == pytest.approx(200.0)
    assert SERVICE.read(r) == pytest.approx(200.0)


def test_a_missing_upload_is_infinite():
    lat = [0.2] * 10 + [math.inf] * 10
    r = _run(lat, [float(k) for k in range(20)])
    assert P95.read(r) is None
    assert SERVICE.read(r) is None
    one = _run([0.2] * 19 + [math.inf], [float(k) for k in range(20)])
    assert SERVICE.read(one) is None
