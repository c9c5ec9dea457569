"""A whole run at toy sizes on the CPU, the look for a card skipped: sound,
it comes out correct; with the timed path broken underneath (an answer or
a region altered where the program produces it), ``correct`` comes out
false. The cells' own limits decide."""

import json

import numpy as np
import pytest

from portbench import harness
from portbench.tests.tiny import drive, tiny_run


def _limits(workload):
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return harness.load_json(harness.ROOT, conf["file"])["limits"]


def _run(workload, tmp_path, **kw):
    r = tiny_run(workload, seconds=3.0, work_dir=str(tmp_path),
                 limits=_limits(workload), **kw)
    line = drive(r)
    json.dumps(line)  # the line is JSON
    return line


def _alter_answers(monkeypatch):
    """Every decoded answer's first choice moved to another choice."""
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    decode = InferenceEngine.decode

    def altered(self, req, bundle, row=0):
        res = decode(self, req, bundle, row)
        if res.answers is not None:
            names = [a["answer"] for a in res.answers]
            if len(names) > 1:
                res.answers[0]["answer"] = names[-1]
            else:
                res.answers[0]["answer"] = "yes" if names[0] != "yes" else "no"
        if res.ranking is not None:
            res.ranking[0]["image"] = res.ranking[-1]["image"]
        if res.boxes is not None:
            res.boxes[0]["region_index"] = (res.boxes[0]["region_index"]
                                            + 1) % 11
        return res

    monkeypatch.setattr(InferenceEngine, "decode", altered)


def _alter_second_entries(monkeypatch):
    """Every decoded bundle's second entry swapped with its last: the first
    choice stays right, the rest of the top-3 does not."""
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    decode = InferenceEngine.decode

    def altered(self, req, bundle, row=0):
        res = decode(self, req, bundle, row)
        for entries in (res.answers, res.ranking, res.boxes):
            if entries is not None and len(entries) > 2:
                entries[1], entries[-1] = entries[-1], entries[1]
            elif entries is not None and len(entries) == 2:
                entries[1] = dict(entries[1], confidence=entries[1][
                    "confidence"] * 0.25)
        return res

    monkeypatch.setattr(InferenceEngine, "decode", altered)


@pytest.mark.parametrize("workload", ["bf16-prepared", "upload-poisson"])
def test_a_sound_run_is_correct(workload, tmp_path):
    line = _run(workload, tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("workload", ["bf16-prepared", "upload-poisson",
                                      "upload-mixed"])
def test_an_answer_altered_where_it_is_produced_fails(workload, tmp_path,
                                                       monkeypatch):
    _alter_answers(monkeypatch)
    line = _run(workload, tmp_path)
    assert not line["correct"]
    c = line["checks"]["answer_logp_mean"]
    assert float(c["value"]) > c["limit"]


@pytest.mark.parametrize("workload", ["bf16-prepared", "upload-mixed"])
def test_a_wrong_second_or_third_answer_fails(workload, tmp_path,
                                              monkeypatch):
    _alter_second_entries(monkeypatch)
    line = _run(workload, tmp_path)
    assert not line["correct"]


def test_a_region_altered_where_it_is_produced_fails(tmp_path, monkeypatch):
    from vilbert_multitask_tpu_torch.detect.extractor import (
        LiveFeatureExtractor,
    )

    extract = LiveFeatureExtractor.extract_array

    def shifted(self, rgb):
        out = extract(self, rgb)
        out.boxes = out.boxes + np.float32(6.0)
        return out

    monkeypatch.setattr(LiveFeatureExtractor, "extract_array", shifted)
    line = _run("upload-poisson", tmp_path)
    assert not line["correct"]
    c = line["checks"]
    assert c["region_miss"]["value"] > c["region_miss"]["limit"] or \
        c["region_feat_err"]["value"] > c["region_feat_err"]["limit"]


def test_the_result_line_carries_the_contract_keys(tmp_path):
    line = _run("bf16-prepared", tmp_path)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert set(line["metrics"]) == {"answers_per_s", "setup_s"}
    assert line["device"]["count"] == 1
