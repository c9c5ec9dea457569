"""Novel uploads through the port (``vilbert_multitask_tpu_torch``) on the
CPU, against the JAX package on the same weights and the same image files:

- ``FallbackFeatureStore``: the port's counterparts of
  tests/test_detect.py's fallback tests (novel upload, confinement to the
  media root, get-only stores, a forward fed by live features);
- ``ServeApp(live_extract=True)`` booted from a trunk checkpoint and a
  maskrcnn detector checkpoint answers an image uploaded over HTTP exactly
  as the JAX engine answers on the JAX extractor's features for the same
  file and weights (f32: answers equal, numbers within 2e-5 relative); a
  resubmit of the same upload runs no detector;
- ``checkpoint.convert.load_torch_checkpoint``: the JAX package's
  ``to_torch_state_dict`` of the JAX engine's weights, saved with
  ``torch.save``, predicts as ``from_flax_params`` and the JAX engine do.

Images are 64 pixels on their long side, which the tiny detector's canvas
takes unscaled, so both packages see the same canvas (PIL's resize and the
port's differ by a level at some pixels: tests/test_torch_detect.py).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import queue as queue_mod
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_helpers import (
    assert_same_result,
    detector_params,
    engine_pair,
    maskrcnn_state_dict,
    write_feature_files,
)
from vilbert_multitask_tpu.checkpoint.convert import to_torch_state_dict
from vilbert_multitask_tpu.config import (
    DetectorConfig as JaxDetectorConfig,
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu.detect.extractor import (
    FallbackFeatureStore as JaxFallback,
    LiveFeatureExtractor as JaxExtractor,
)
from vilbert_multitask_tpu.features.store import FeatureStore as JaxStore
from vilbert_multitask_tpu_torch.checkpoint.convert import (
    load_torch_checkpoint,
)
from vilbert_multitask_tpu_torch.config import DetectorConfig
from vilbert_multitask_tpu_torch.detect import convert as pconvert
from vilbert_multitask_tpu_torch.detect.extractor import (
    FallbackFeatureStore,
    LiveFeatureExtractor,
)
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
from vilbert_multitask_tpu_torch.features.store import FeatureStore
from vilbert_multitask_tpu_torch.serve.app import ServeApp

F32 = dict(rtol=2e-5, atol=2e-5)
JAX_CFG = FrameworkConfig(
    model=ViLBertConfig().tiny(),
    engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2, 4), throughput_buckets=(8,),
        compute_dtype="float32",
        use_pallas_coattention=False, use_pallas_self_attention=False))
JAX_DET = JaxDetectorConfig().tiny(
    representation_size=JAX_CFG.model.v_feature_size)
PORT_DET = DetectorConfig().tiny(
    representation_size=JAX_CFG.model.v_feature_size)


def _png(path, seed: int, hw=(48, 64)) -> str:
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tiny trunk engines (JAX and port, same weights), the JAX extractor
    and the same detector as a maskrcnn file, the trunk as an upstream
    ``.bin``, a feature dir with img_0..img_3 and a media root."""
    root = tmp_path_factory.mktemp("detect_serve")
    features = root / "features"
    features.mkdir()
    write_feature_files(str(features), JAX_CFG.model.v_feature_size,
                        ("img_0", "img_1", "img_2", "img_3"))
    jeng, peng, sd = engine_pair(JAX_CFG, str(features))
    jax_params = jax.device_get(jeng.params)
    trunk = root / "pytorch_model_9.bin"
    torch.save({"state_dict": {
        f"module.{k}": torch.from_numpy(np.array(v))
        for k, v in to_torch_state_dict(jax_params, JAX_CFG.model).items()}},
        trunk)
    det = detector_params(JAX_DET, seed=1)
    det_path = root / "model_final.pth"
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in
                          maskrcnn_state_dict(det, JAX_DET).items()}},
               det_path)
    media = root / "media"
    (media / "demo").mkdir(parents=True)
    return dict(root=root, features=str(features), media=str(media),
                jax=jeng, port=peng, sd=sd, trunk=str(trunk),
                det=det, det_path=str(det_path),
                jax_extractor=JaxExtractor(JAX_DET, params=det, num_keep=8),
                port_extractor=LiveFeatureExtractor(
                    PORT_DET, params=pconvert.from_flax_params(det, PORT_DET),
                    num_keep=8, device="cpu"))


# ---------------------------------------------------- FallbackFeatureStore
def test_fallback_store_extracts_a_novel_upload_once(world, tmp_path):
    media = tmp_path / "media"
    (media / "demo").mkdir(parents=True)
    img = _png(media / "demo" / "novel_upload.png", 2)
    calls = []
    ex = world["port_extractor"]

    class Counting:
        def extract(self, path):
            calls.append(path)
            return ex.extract(path)

    fb = FallbackFeatureStore(FeatureStore(str(tmp_path / "features")),
                              Counting(), media_root=str(media))
    region, ident = fb.fetch(img)
    assert region.num_boxes >= 1 and ident.startswith(os.path.realpath(img))
    assert fb.get(img) is region  # the content-identity cache
    assert fb.get("demo/novel_upload.png") is region  # media-relative
    assert len(calls) == 1
    with pytest.raises(KeyError, match="no precomputed features"):
        fb.get("does_not_exist.png")
    # a replaced upload (new mtime/size) is a new identity: extracted again
    time.sleep(0.01)
    _png(img, 3, hw=(40, 64))
    assert fb.get(img) is not region and len(calls) == 2


def test_fallback_store_confined_to_the_media_root(world, tmp_path):
    outside = _png(tmp_path / "secret.png", 4, hw=(16, 16))
    media = tmp_path / "media"
    media.mkdir()
    fb = FallbackFeatureStore(FeatureStore(str(tmp_path / "f")),
                              world["port_extractor"], media_root=str(media))
    with pytest.raises(KeyError):
        fb.get(outside)
    with pytest.raises(KeyError):
        fb.get("../secret.png")


def test_fallback_store_consults_a_get_only_store_first():
    sentinel = object()

    class GetOnlyStore:
        def get(self, key):
            if key == "hit":
                return sentinel
            raise KeyError(key)

    fb = FallbackFeatureStore(GetOnlyStore(), extractor=None,
                              media_root="/nonexistent")
    region, ident = fb.fetch("hit")
    assert region is sentinel and ident is None
    assert fb.get("hit") is sentinel


def test_fallback_store_precomputed_features_win(world):
    fb = FallbackFeatureStore(FeatureStore(world["features"]), None,
                              media_root=world["media"])
    region, ident = fb.fetch("img_1.jpg")
    want, want_ident = FeatureStore(world["features"]).fetch("img_1.jpg")
    np.testing.assert_array_equal(region.features, want.features)
    assert ident == want_ident == fb.identity("img_1.jpg")


def test_live_features_feed_the_port_engine_like_jax(world, tmp_path):
    """Novel image → live features → answer, port against JAX: the same
    regions (boxes, fc6 at 1e-4) and the same answer."""
    media = tmp_path / "media"
    (media / "demo").mkdir(parents=True)
    img = _png(media / "demo" / "fresh.png", 5, hw=(64, 50))
    want_region = world["jax_extractor"].extract(img)
    got_region = world["port_extractor"].extract(img)
    assert got_region.num_boxes == want_region.num_boxes
    np.testing.assert_allclose(got_region.boxes, want_region.boxes,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_region.features, want_region.features,
                               rtol=1e-4, atol=1e-4)
    jeng, peng = world["jax"], world["port"]
    saved = jeng.feature_store, peng.feature_store
    try:
        jeng.feature_store = JaxFallback(JaxStore(world["features"]),
                                         world["jax_extractor"],
                                         media_root=str(media))
        peng.feature_store = FallbackFeatureStore(
            FeatureStore(world["features"]), world["port_extractor"],
            media_root=str(media))
        want = jeng.predict(1, "what is in this new image", [img]).to_json()
        got = peng.predict(1, "what is in this new image", [img]).to_json()
    finally:
        jeng.feature_store, peng.feature_store = saved
    assert_same_result(got, want, dict(rtol=1e-4, atol=1e-4))


# -------------------------------------------------------------- ServeApp
def _multipart(files: dict) -> tuple:
    boundary = "vmt-test-boundary"
    parts = []
    for name, data in files.items():
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"file\"; filename=\"{name}\"\r\nContent-Type: "
            f"image/png\r\n\r\n".encode() + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _terminal(sub, timeout_s: float = 60.0) -> list:
    frames, end, extra = [], time.monotonic() + timeout_s, None
    while time.monotonic() < (extra or end):
        try:
            frame = sub.get(timeout=0.05)
        except queue_mod.Empty:
            continue
        if "result" in frame or "error" in frame \
                or frame.get("deadline_exceeded") or frame.get("dead_letter"):
            frames.append(frame)
            extra = extra or time.monotonic() + 0.3
    return frames


def test_serveapp_answers_an_uploaded_image_like_jax(world, tmp_path):
    """Boot from the two checkpoints with live extraction, upload a PNG
    over HTTP, submit it: one terminal frame and one stored row, the JAX
    engine's answer on the JAX extractor's features; then a resubmit of the
    same upload (another question) answers with no detector run."""
    pcfg = dataclasses.replace(
        world["port"].cfg, serving=dataclasses.replace(
            world["port"].cfg.serving,
            queue_db_path=str(tmp_path / "q.sqlite3"),
            results_db_path=str(tmp_path / "r.sqlite3"),
            media_root=str(tmp_path / "media"), http_port=0, ws_port=0,
            sampler_cadence_s=0.2))
    app = ServeApp(pcfg, feature_root=world["features"], device="cpu",
                   checkpoint_path=world["trunk"], live_extract=True,
                   detector_checkpoint=world["det_path"],
                   detector=DetectorConfig().tiny())
    assert app.detector_cfg == PORT_DET
    calls = []
    real_extract = app.extractor.extract
    app.extractor.extract = lambda path: (calls.append(path),
                                          real_extract(path))[1]
    app.warm()
    app.start()
    png = _png(tmp_path / "upload.png", 6)
    questions = ("what is in the uploaded picture", "what colour is it")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=30)
        body, ctype = _multipart({"upload.png": open(png, "rb").read()})
        conn.request("POST", "/upload_image/", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        assert resp.status == 200
        (path,) = json.loads(resp.read())["file_paths"]
        frames = []
        for i, question in enumerate(questions):
            sub = app.hub.subscribe(f"up{i}")
            conn.request("POST", "/", body=json.dumps({
                "task_id": 1, "socket_id": f"up{i}", "question": question,
                "image_list": [path]}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200, resp.read()
            resp.read()
            frames.append(_terminal(sub))
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        rows = app.store.recent(10)
    finally:
        app.stop()
    assert [len(f) for f in frames] == [1, 1], frames
    assert len(rows) == 2
    assert len(calls) == 1  # the resubmit hit the extractor's cache
    assert health["boot"]["live_extract"] is True
    assert health["boot"]["detector_warm"] is True
    jeng = world["jax"]
    saved = jeng.feature_store
    try:
        jeng.feature_store = JaxFallback(
            JaxStore(world["features"]), world["jax_extractor"],
            media_root=str(tmp_path / "media"))
        for question, frame in zip(questions, frames):
            want = jeng.predict(1, question, [path]).to_json()
            got = {k: v for k, v in frame[0]["result"].items() if k in want}
            assert_same_result(got, want, F32)
    finally:
        jeng.feature_store = saved


# --------------------------------------------------- trunk checkpoint (A5)
def test_load_torch_checkpoint_predicts_like_flax_params_and_jax(world):
    loaded = load_torch_checkpoint(world["trunk"], world["port"].cfg.model)
    assert set(loaded) == set(world["sd"])
    for k, v in world["sd"].items():
        np.testing.assert_array_equal(loaded[k].numpy(), v, err_msg=k)
    eng = InferenceEngine(world["port"].cfg, params=loaded,
                          feature_store=FeatureStore(world["features"]),
                          device="cpu")
    for task_id, question, images in (
            (1, "what is the man holding", ["img_0"]),
            (12, "both images contain two wolves", ["img_1", "img_2"])):
        names = [f"{n}.jpg" for n in images]
        got = eng.predict(task_id, question, names).to_json()
        assert got == world["port"].predict(task_id, question,
                                            names).to_json()
        assert_same_result(got, world["jax"].predict(
            task_id, question, names).to_json(), F32)


def test_load_torch_checkpoint_is_strict(world, tmp_path):
    sd = torch.load(world["trunk"], weights_only=True)["state_dict"]
    sd.pop("module.bert.t_pooler.dense.bias")
    sd["module.extra.weight"] = torch.zeros(1)
    path = tmp_path / "bad.bin"
    torch.save(sd, path)
    with pytest.raises(KeyError, match="1 missing keys.*1 unexpected"):
        load_torch_checkpoint(str(path), world["port"].cfg.model)


def test_rolling_swap_reads_a_checkpoint_file(world, tmp_path):
    pcfg = dataclasses.replace(
        world["port"].cfg, serving=dataclasses.replace(
            world["port"].cfg.serving,
            queue_db_path=str(tmp_path / "q.sqlite3"),
            results_db_path=str(tmp_path / "r.sqlite3"),
            media_root=str(tmp_path / "media"), http_port=0, ws_port=0))
    app = ServeApp(pcfg, engine=world["port"],
                   feature_root=world["features"], device="cpu")
    try:
        report = app.rolling_swap(checkpoint_path=world["trunk"])
    finally:
        app.stop()
    assert report["checkpoint"] == world["trunk"]
    assert [r["name"] for r in report["replicas"]] == ["r0"]
    got = world["port"].predict(1, "what is the man holding",
                                ["img_0.jpg"]).to_json()
    assert_same_result(got, world["jax"].predict(
        1, "what is the man holding", ["img_0.jpg"]).to_json(), F32)
