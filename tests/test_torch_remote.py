"""The port's remote worker (``vilbert_multitask_tpu_torch/serve/remote.py``)
on the CPU: the five cases of tests/test_remote_worker.py against the port's
own ``ApiServer``. A real ServeWorker whose queue, store and hub are the
HTTP shims drains the web host's queue over a real socket; the answers it
stores equal ``predict()`` of the same engine."""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request

import pytest

from tests.torch_port_helpers import assert_same_result, write_feature_files
from vilbert_multitask_tpu_torch.config import (
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
from vilbert_multitask_tpu_torch.features.store import FeatureStore
from vilbert_multitask_tpu_torch.serve import (
    DurableQueue,
    PushHub,
    ResultStore,
    ServeWorker,
)
from vilbert_multitask_tpu_torch.serve.http_api import ApiServer
from vilbert_multitask_tpu_torch.serve.remote import (
    RemoteHub,
    RemoteQueue,
    RemoteStore,
    WorkerApiClient,
    build_remote_worker,
)

# The port's transport fault site (serve/remote.py). A name, not a literal
# in the FaultRule: vmtlint's protocol manifest (PROTOCOL_SURFACE.json) maps
# the JAX package's fault sites to the literal rules that inject them, and
# this rule injects the port's site of the same name.
REMOTE_POST = "remote.post"
# The same engine: a row batched by the worker against predict()'s bucket-1
# forward differs by f32 rounding of other GEMM shapes (test_torch_serve's
# tolerance).
F32 = dict(rtol=2e-5, atol=2e-5)
CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(max_text_len=12, max_regions=9, num_features=8,
                        image_buckets=(1, 2, 4), throughput_buckets=(8,),
                        compute_dtype="float32"))


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_remote_features")
    write_feature_files(str(d), CFG.model.v_feature_size, ("img_a", "img_b"))
    return InferenceEngine(CFG, feature_store=FeatureStore(str(d)),
                           device="cpu")


def _serving(tmp_path, **kw):
    return dataclasses.replace(
        CFG.serving, queue_db_path=str(tmp_path / "q.sqlite3"),
        results_db_path=str(tmp_path / "r.sqlite3"),
        media_root=str(tmp_path / "media"), **kw)


@pytest.fixture()
def web_host(tmp_path):
    """The web tier: queue, store and hub behind a live ApiServer, with no
    engine of its own."""
    s = _serving(tmp_path)
    hub = PushHub()
    q = DurableQueue(s.queue_db_path,
                     max_delivery_attempts=s.max_delivery_attempts)
    store = ResultStore(s.results_db_path)
    api = ApiServer(q, store, hub, s)
    port = api.start()
    yield s, hub, q, store, f"http://127.0.0.1:{port}"
    api.stop()


def _submit(base_url, payload):
    req = urllib.request.Request(
        base_url + "/", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _frames(sub):
    out = []
    while not sub.empty():
        out.append(sub.get_nowait())
    return out


def _remote_worker(engine, s, client):
    return ServeWorker(engine, RemoteQueue(client), RemoteStore(client),
                       RemoteHub(client), s)


def test_remote_worker_drains_queue_over_http(web_host, engine):
    s, hub, q, store, url = web_host
    jobs = [(1, "what is this?", ["img_a"]), (13, "a dog runs", ["img_b"]),
            (12, "both show a wolf", ["img_a", "img_b"])]
    subs = []
    for i, (task, question, images) in enumerate(jobs):
        sock = f"sock-remote-{i}"
        subs.append(hub.subscribe(sock))
        out = _submit(url, {"task_id": task, "socket_id": sock,
                            "question": question, "image_list": images})
        assert "job_id" in out
    worker = _remote_worker(engine, s, WorkerApiClient(url))
    done = 0
    for _ in range(5):
        done += worker.step_batch()
        if done == len(jobs):
            break
    assert done == len(jobs)
    assert q.counts() == {}  # acked over HTTP: gone
    rows = {r["input_text"]: r for r in store.recent()}
    assert len(rows) == len(jobs)
    for sub, (task, question, images) in zip(subs, jobs):
        results = [f for f in _frames(sub) if "result" in f]
        assert len(results) == 1  # one terminal per submit
        want = engine.predict(task, question,
                              [f"{k}.jpg" for k in images]).to_json()
        for got in (results[0]["result"], rows[question]["answer_text"]):
            assert_same_result({k: v for k, v in got.items() if k in want},
                               want, F32)


def test_remote_worker_failure_nacks_to_dead_letter(web_host, engine):
    s, hub, q, store, url = web_host
    # An unknown feature key makes intake raise on the worker at every
    # delivery, until the job dead-letters: all over HTTP.
    _submit(url, {"task_id": 1, "socket_id": "sock-x", "question": "what",
                  "image_list": ["missing_key"]})
    worker = _remote_worker(engine, s, WorkerApiClient(url))
    for _ in range(s.max_delivery_attempts + 1):
        worker.step_batch()
    assert q.counts().get("dead", 0) == 1


def test_worker_endpoints_reject_bad_token(tmp_path):
    s = _serving(tmp_path, worker_token="sekrit")
    q = DurableQueue(s.queue_db_path)
    api = ApiServer(q, ResultStore(s.results_db_path), PushHub(), s)
    url = f"http://127.0.0.1:{api.start()}"
    try:
        for token in (None, "wrong"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                WorkerApiClient(url, token=token).post("/worker/claim", {})
            assert ei.value.code == 401
        out = WorkerApiClient(url, token="sekrit").post("/worker/claim", {})
        assert out == {"job": None}
        # Submission stays open: it is the browser's surface.
        assert "job_id" in _submit(url, {"task_id": 1, "socket_id": "s",
                                         "question": "q",
                                         "image_list": ["img_a"]})
    finally:
        api.stop()


def test_build_remote_worker_reuses_engine(web_host, engine):
    _, _, _, _, url = web_host
    w = build_remote_worker(url, engine=engine)
    assert w.engine is engine
    assert isinstance(w.queue, RemoteQueue)
    assert isinstance(w.store, RemoteStore) and isinstance(w.hub, RemoteHub)


def test_remote_worker_survives_transport_flaps(web_host, engine):
    """Injected transport faults hit the real retry path: the job still
    completes exactly once and the breaker never trips."""
    from vilbert_multitask_tpu_torch.resilience import (
        CircuitBreaker,
        FaultPlan,
        FaultRule,
        RetryBudget,
        RetryPolicy,
        clear_plan,
        install_plan,
    )

    s, hub, q, store, url = web_host
    sub = hub.subscribe("sock-flap")
    _submit(url, {"task_id": 1, "socket_id": "sock-flap",
                  "question": "what is this", "image_list": ["img_a"]})
    client = WorkerApiClient(
        url,
        retry=RetryPolicy(max_attempts=6, base_delay_s=0.001,
                          max_delay_s=0.01, budget=RetryBudget(1e9, 1e9)),
        breaker=CircuitBreaker(name="test.flap", failure_threshold=5,
                               window_s=5.0, reset_timeout_s=0.05))
    worker = _remote_worker(engine, s, client)
    plan = install_plan(FaultPlan(3, [
        FaultRule(REMOTE_POST, "error", rate=0.4, max_injections=4)]))
    try:
        done = 0
        for _ in range(10):  # a flapped claim reads as "drained": re-step
            done += worker.step_batch()
            if done:
                break
        assert done == 1
        assert q.counts() == {}
        assert plan.injections().get(REMOTE_POST, 0) > 0
    finally:
        clear_plan()
    assert len([f for f in _frames(sub) if "result" in f]) == 1


def test_remote_worker_entry_point_drains_and_stops_on_sigterm(
        web_host, engine, tmp_path):
    """``python -m vilbert_multitask_tpu_torch.serve.remote --device cpu``
    in its own process: it answers a submit (as predict() of an engine on
    the same seeded weights) and exits 0 on SIGTERM."""
    import os
    import signal
    import subprocess
    import sys
    import time

    s, hub, q, store, url = web_host
    root = engine.feature_store.root
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "vilbert_multitask_tpu_torch.serve.remote",
         "--url", url, "--features", root, "--device", "cpu", "--tiny",
         "--no-warmup", "--poll", "0.05"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        sub = hub.subscribe("sock-cli")
        _submit(url, {"task_id": 1, "socket_id": "sock-cli",
                      "question": "what is this", "image_list": ["img_a"]})
        frames, end = [], time.monotonic() + 120
        while not any("result" in f for f in frames) and \
                time.monotonic() < end and proc.poll() is None:
            frames += _frames(sub)
            time.sleep(0.05)
        results = [f["result"] for f in frames if "result" in f]
        assert len(results) == 1, (frames, proc.poll())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # The process's engine: the tiny config's seeded weights (seed 0).
    ref = InferenceEngine(dataclasses.replace(CFG.__class__(), model=CFG.model),
                          feature_store=engine.feature_store, device="cpu")
    want = ref.predict(1, "what is this", ["img_a.jpg"]).to_json()
    assert_same_result({k: v for k, v in results[0].items() if k in want},
                       want, F32)
