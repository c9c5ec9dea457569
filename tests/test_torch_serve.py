"""The port's serving tier (``vilbert_multitask_tpu_torch.serve``) on the
CPU, over a tiny port engine that carries the JAX engine's weights: HTTP
submit → durable queue → scheduler → worker → engine → result store + push
hub. Every submit gets exactly one terminal frame and a stored row, and
the answers equal the JAX engine's ``predict()`` on the same weights and
feature files (f32: same answers, scores and confidences within 2e-5).

Threads are joined with bounded waits (ServeApp.stop, explicit joins);
conftest's thread-leak guard checks the rest.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import queue as queue_mod
import threading
import time

import pytest

from tests.torch_port_helpers import (
    assert_same_result,
    engine_pair,
    write_feature_files,
)
from vilbert_multitask_tpu.config import (
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.resilience import Deadline
from vilbert_multitask_tpu_torch.serve import (
    DurableQueue,
    PushHub,
    ResultStore,
    ServeWorker,
    make_job_message,
)
from vilbert_multitask_tpu_torch.serve import metrics as port_metrics
from vilbert_multitask_tpu_torch.serve.app import ServeApp

F32 = dict(rtol=2e-5, atol=2e-5)
IMAGES = ("img_0", "img_1", "img_2", "img_3")
JAX_CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2, 4), throughput_buckets=(8,),
        compute_dtype="float32",
        use_pallas_coattention=False, use_pallas_self_attention=False))
# One submit per decode family (task id, question, images).
FAMILY_JOBS = [
    (1, "what is the man holding", ["img_0"]),
    (15, "is the bowl right of the mug", ["img_1"]),
    (11, "the woman in the red coat", ["img_2"]),
    (13, "two dogs are playing in the snow", ["img_3"]),
    (12, "both images contain two wolves", ["img_0", "img_1"]),
    (7, "a man riding a horse on the beach", ["img_0", "img_2", "img_3"]),
]
# A burst of distinct VQA questions over the images (no result-cache hits).
BURST = [(1, f"what is in picture {k}", [IMAGES[k % 4]]) for k in range(8)]


def _is_terminal(frame: dict) -> bool:
    """A submit's terminal frames, by shape (scripts/serve_soak.py's
    rule): a result, an error, a deadline or a dead-letter push."""
    return bool("result" in frame or "error" in frame
                or frame.get("deadline_exceeded")
                or frame.get("dead_letter"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve_features")
    write_feature_files(str(d), JAX_CFG.model.v_feature_size, IMAGES)
    jeng, peng, sd = engine_pair(JAX_CFG, str(d))
    return dict(root=str(d), jax=jeng, port=peng, sd=sd)


def _serving(cfg, tmp_path, **kw):
    return dataclasses.replace(
        cfg.serving, queue_db_path=str(tmp_path / "q.sqlite3"),
        results_db_path=str(tmp_path / "r.sqlite3"),
        media_root=str(tmp_path / "media"), http_port=0, ws_port=0,
        sampler_cadence_s=0.2, **kw)


def _collect(subs: dict, want: int, timeout_s: float = 60.0) -> dict:
    """Terminal frames per socket, until ``want`` sockets have one (or the
    time is up), then a short extra drain to catch duplicates."""
    frames: dict = {sid: [] for sid in subs}
    end = time.monotonic() + timeout_s
    extra = None
    while time.monotonic() < (extra or end):
        got = False
        for sid, sub in subs.items():
            try:
                frame = sub.get_nowait()
            except queue_mod.Empty:
                continue
            got = True
            if _is_terminal(frame):
                frames[sid].append(frame)
        if extra is None and sum(bool(v) for v in frames.values()) >= want:
            extra = time.monotonic() + 0.3
        if not got:
            time.sleep(0.01)
    return frames


def _jax_answer(world, task_id, question, images):
    """The JAX engine's answer to a submit of ``images`` (as .jpg names)."""
    return world["jax"].predict(task_id, question,
                                [f"{n}.jpg" for n in images]).to_json()


def _same_answer(result: dict, want: dict) -> None:
    got = {k: v for k, v in result.items() if k in want}
    assert_same_result(got, want, F32)


def test_serveapp_answers_every_submit_once_like_jax(world, tmp_path):
    """ServeApp over the port engine (the scheduler's run_many path): the
    six decode families and a burst of VQA submits over HTTP, each with
    its own push socket."""
    pcfg = dataclasses.replace(world["port"].cfg,
                               serving=_serving(world["port"].cfg, tmp_path))
    app = ServeApp(pcfg, engine=world["port"], feature_root=world["root"],
                   device="cpu")
    app.warm()
    app.start()
    jobs = FAMILY_JOBS + BURST
    subs = {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=10)
        for i, (task_id, question, images) in enumerate(jobs):
            sid = f"sock{i}"
            subs[sid] = app.hub.subscribe(sid)
            conn.request("POST", "/", body=json.dumps({
                "task_id": task_id, "socket_id": sid, "question": question,
                "image_list": [f"{name}.jpg" for name in images]}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200, resp.read()
            resp.read()
        frames = _collect(subs, len(jobs))
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
    finally:
        t0 = time.monotonic()
        app.stop()
        assert time.monotonic() - t0 < 15.0
    counts = {sid: len(f) for sid, f in frames.items()}
    assert all(n == 1 for n in counts.values()), counts
    for i, (task_id, question, images) in enumerate(jobs):
        frame = frames[f"sock{i}"][0]
        assert "result" in frame, frame
        _same_answer(frame["result"],
                     _jax_answer(world, task_id, question, images))
    assert len(app.store.recent(100)) == len(jobs)
    assert health["ok"] is True
    assert health["boot"]["buckets"] == [1, 2, 4, 8]
    assert app.engine.replicas[0].engine is world["port"]


def test_worker_and_scheduler_drain_a_queue_like_jax(world, tmp_path):
    """ServeWorker.run_forever through the ContinuousScheduler on a
    tmp_path queue: each job one terminal, one stored row, the JAX
    answer."""
    s = _serving(world["port"].cfg, tmp_path)
    hub = PushHub()
    q = DurableQueue(s.queue_db_path,
                     max_delivery_attempts=s.max_delivery_attempts)
    store = ResultStore(s.results_db_path)
    worker = ServeWorker(world["port"], q, store, hub, s)
    jobs = FAMILY_JOBS + BURST[:4]
    subs = {}
    for i, (task_id, question, images) in enumerate(jobs):
        sid = f"w{i}"
        subs[sid] = hub.subscribe(sid)
        q.publish(make_job_message([f"{n}.jpg" for n in images], question,
                                   task_id, sid))
    stop = threading.Event()
    thread = threading.Thread(target=worker.run_forever,
                              kwargs=dict(stop_event=stop), daemon=True)
    thread.start()
    try:
        frames = _collect(subs, len(jobs))
    finally:
        stop.set()
        thread.join(timeout=15.0)
    assert not thread.is_alive()
    assert all(len(f) == 1 for f in frames.values()), frames
    for i, (task_id, question, images) in enumerate(jobs):
        _same_answer(frames[f"w{i}"][0]["result"],
                     _jax_answer(world, task_id, question, images))
    assert q.counts() == {}
    assert len(store.recent(100)) == len(jobs)


def test_worker_step_runs_jobs_through_run(world, tmp_path):
    """The synchronous loop (``step``) goes through engine.run(); an
    expired job gets a deadline terminal and no forward."""
    s = _serving(world["port"].cfg, tmp_path, sched_enabled=False)
    hub = PushHub()
    q = DurableQueue(s.queue_db_path,
                     max_delivery_attempts=s.max_delivery_attempts)
    store = ResultStore(s.results_db_path)
    worker = ServeWorker(world["port"], q, store, hub, s)
    sub = hub.subscribe("solo")
    task_id, question, images = FAMILY_JOBS[4]
    q.publish(make_job_message([f"{n}.jpg" for n in images], question,
                               task_id, "solo"))
    assert worker.step() == "acked"
    late = hub.subscribe("late")
    q.publish(make_job_message(["img_0.jpg"], "too late", 1, "late",
                               deadline=Deadline(-1.0).to_wire()))
    worker.step()
    frames = _collect({"solo": sub, "late": late}, 2, timeout_s=10.0)
    assert len(frames["solo"]) == 1 and len(frames["late"]) == 1
    _same_answer(frames["solo"][0]["result"],
                 _jax_answer(world, task_id, question, images))
    assert frames["late"][0].get("deadline_exceeded")
    assert q.counts() == {}


def test_serveapp_refuses_what_is_not_ported(world, tmp_path):
    pcfg = dataclasses.replace(world["port"].cfg,
                               serving=_serving(world["port"].cfg, tmp_path))
    with pytest.raises(NotImplementedError, match="A5"):
        ServeApp(pcfg, engine=world["port"], checkpoint_path="ckpt",
                 device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        ServeApp(pcfg, engine=world["port"], live_extract=True,
                 device="cpu")


def test_serveapp_boots_its_own_cpu_engines(world, tmp_path):
    """No engine given: the app seeds one per replica on the device asked
    for, all replicas on the same weights."""
    cfg = dataclasses.replace(world["port"].cfg, serving=_serving(
        world["port"].cfg, tmp_path, pool_replicas=2))
    app = ServeApp(cfg, feature_root=world["root"], device="cpu")
    engines = [r.engine for r in app.engine.replicas]
    assert [e.replica_id for e in engines] == ["r0", "r1"]
    assert all(e.device.type == "cpu" for e in engines)
    a, b = (e.model.state_dict() for e in engines)
    assert all(a[k].equal(b[k]) for k in a)
    assert app.boot_info["boot_phases"]["upload_s"] > 0
    app.recorder.close()


def test_device_trace_toggles_write_a_chrome_trace(tmp_path):
    port_metrics.start_device_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        port_metrics.start_device_trace(str(tmp_path))
    port_metrics.stop_device_trace()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(RuntimeError):
        port_metrics.stop_device_trace()


def test_server_entry_point_boots_serves_and_drains(world, tmp_path):
    """``python -m vilbert_multitask_tpu_torch.serve.app`` (tiny, CPU) in a
    process of its own: ready on /healthz, a submit answered into the
    result store as an in-process engine on the same seed answers it, exit
    0 on SIGTERM."""
    import signal
    import subprocess
    import sys

    from vilbert_multitask_tpu_torch.config import (
        FrameworkConfig as PortFramework,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine as PortEngine,
    )
    from vilbert_multitask_tpu_torch.features.store import (
        FeatureStore as PortStore,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vilbert_multitask_tpu_torch.serve.app",
         "--features", world["root"], "--device", "cpu", "--tiny",
         "--http-port", "0", "--ws-port", "0", "--no-warmup"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue_mod.Queue" = queue_mod.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    out = []
    try:
        url = None
        end = time.monotonic() + 120.0
        while url is None and time.monotonic() < end \
                and proc.poll() is None:
            try:
                line = lines.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            out.append(line)
            if line.startswith("http://"):
                url = line.split()[0]
        assert url, "".join(out)
        conn = http.client.HTTPConnection(
            "127.0.0.1", int(url.rsplit(":", 1)[1]), timeout=10)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["ok"] is True
        question = "what is the entry point serving"
        conn.request("POST", "/", body=json.dumps({
            "task_id": 1, "socket_id": "entry", "question": question,
            "image_list": ["img_0.jpg"]}),
            headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 200
        answer, end = None, time.monotonic() + 60.0
        while answer is None and time.monotonic() < end:
            conn.request("GET", "/admin/questionanswer?limit=5")
            for row in json.loads(conn.getresponse().read())["rows"]:
                if row["input_text"] == question and row["answer_text"]:
                    answer = row["answer_text"]
            time.sleep(0.05)
        assert answer is not None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, "".join(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
    cfg = PortFramework()
    cfg = dataclasses.replace(cfg, model=cfg.model.tiny())
    want = PortEngine(cfg, seed=0, feature_store=PortStore(world["root"]),
                      device="cpu").predict(1, question,
                                            ["img_0.jpg"]).to_json()
    _same_answer(answer, want)
