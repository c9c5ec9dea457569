"""BENCHMARK.json keeps to the benchmark's contract, every name in it finds
its file, and nothing the benchmark runs imports JAX or the JAX
package."""

import ast
import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "vilbert_multitask_tpu")
PORT = "vilbert_multitask_tpu_torch"


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= n <= 24
    # a full check of 24 cells fits its time
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        body = harness.load_json(harness.ROOT, c["file"])
        assert body["reduced"] == c["reduced"]
        assert body["name"] == c["name"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_workloads_find_their_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        t = harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json")
        assert os.path.isfile(os.path.join(harness.HERE, "drivers",
                                           t["driver"] + ".py"))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_keep_to_the_contract_and_find_their_readers():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert harness.applies(moved, w), (m["name"], w)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.isfile(harness.module_path("metrics", m["name"]))
        if m["name"].endswith("_roofline") or "roofline" in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        ends = [m for m in BENCH["end_to_end"] if harness.applies(m, w)]
        assert len(ends) >= 2 and any(m["name"] == "setup_s" for m in ends)
        assert any(harness.applies(m, w) for m in BENCH["per_layer"])


def test_layers_have_one_spelling():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    lowered = {x.lower().strip() for x in layers}
    assert len(lowered) == len(layers)


def _modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    root = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _modules(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _modules(path):
            assert mod.split(".")[0] != PORT, (path, mod)
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_the_top_level_name_is_compared_whole():
    assert harness.forbidden_modules([PORT, PORT + ".engine"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "vilbert_multitask_tpu.models", "flax"]) == [
        "flax", "jax.numpy", "vilbert_multitask_tpu.models"]


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result(
        tmp_path):
    import shutil
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the path without one")
    # A directory with only BENCHMARK.json and the benchmark's files.
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
