"""The PyTorch port stands alone: importing it loads no JAX, no Flax and no
module of the JAX package, its sources import none of them (nor the tests),
and its asset files are byte-identical copies of the JAX package's."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "vilbert_multitask_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "vilbert_multitask_tpu", "tests"}

_PROBE = r"""
import importlib, json, pkgutil, sys
import vilbert_multitask_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_port_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    n_modules = len([p for p in PORT.rglob("*.py")
                     if p.name != "__init__.py"])
    assert len(report["imported"]) >= n_modules
    leaked = [m for m in report["modules"]
              if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not leaked, leaked


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    bad = sorted(set(roots) & FORBIDDEN_ROOTS)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


ASSETS = ("wordpiece_vocab.txt", "labels/vqa/cache/trainval_label2ans.pkl",
          "labels/gqa/cache/trainval_label2ans.pkl")


@pytest.mark.parametrize("rel", ASSETS)
def test_asset_copies_are_byte_identical(rel):
    ours = PORT / "assets" / rel
    theirs = REPO / "vilbert_multitask_tpu" / "assets" / rel
    assert ours.read_bytes() == theirs.read_bytes()


def test_kernel_sources_build_only_from_the_checkout():
    """The build reads csrc/ next to the package and writes under the
    git-ignored _build/ beside it."""
    from vilbert_multitask_tpu_torch import _build

    assert pathlib.Path(_build.SOURCE_DIR) == PORT / "csrc"
    assert pathlib.Path(_build.BUILD_DIR) == PORT / "_build"
    lib = pathlib.Path(_build.library_path("flash_attn"))
    assert lib.parent == PORT / "_build" and lib.suffix == ".so"
    assert "vilbert_multitask_tpu_torch/_build/" in (
        REPO / ".gitignore").read_text()
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
