"""The repo's lint (``python -m vilbert_multitask_tpu.analysis``) over the
PyTorch port, with no baseline: every finding it reports is one of those
named below, each with the reason it stands, and no named finding has
gone stale.

A finding that is the port's fault is repaired in the port, not named
here. The findings left are of two kinds:

- the reference's designs, which the port copies and which
  ``vmtlint_baseline.json`` keeps for the JAX package with the
  justification quoted here (the port has no baseline of its own:
  ``pyproject.toml`` and the baseline file are the reference's);
- rules written for JAX that read the port's torch code wrongly, each
  explained below.

The port adds no inline suppression: each ``# vmtlint: disable`` comment
in it is on a line copied from the file of the same path in the JAX
package, which suppresses it the same way. A finding is named by its
rule, file and source line (the baseline's ``content``), not its line
number, so an edit elsewhere in a file does not move it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "vilbert_multitask_tpu_torch"

_SWAP_LOCK = (
    "the reference's design (vmtlint_baseline.json, VMT120 at "
    "vilbert_multitask_tpu/serve/pool.py): _swap_lock exists only to "
    "serialize concurrent rolling_swap (and retire) calls; the checkout / "
    "checkin / state paths that notify _cond never touch _swap_lock, so the "
    "waiters this wait depends on cannot block on the held lock - no "
    "deadlock, and releasing _swap_lock mid-swap would let a second swap "
    "interleave replica drains")
_KNOB = (
    "a false positive: EngineConfig's own methods read the knob through "
    "self (all_row_buckets, max_batch_rows, the bucket checks in "
    "config.py), and VMT122 counts only reads through a config object "
    "outside the class; the JAX package reads it in its engine, which is "
    "why it is not flagged there")

# (rule, file in the port, source line) -> why it stands.
EXPECTED = {
    ("VMT120", "serve/pool.py", "self._wait_locked("): _SWAP_LOCK,
    ("VMT120", "serve/pool.py",
     "self._wait_locked(lambda: rep.inflight == 0,"): _SWAP_LOCK,
    ("VMT130", "obs/fleet.py", "c.executescript(_SCHEMA)"): (
        "the reference's design (vmtlint_baseline.json, VMT130 at "
        "vilbert_multitask_tpu/obs/fleet.py:142): "
        "fleet_instruments.updated_unix is written for forensic inspection "
        "of the raw db, not for queries; instrument staleness is derived "
        "from fleet_heartbeats.updated_unix via live_idents()"),
    ("VMT118", "models/heads.py", "f32 = quant.dequantize_tree("): (
        "a rule for JAX: it asks for the int8 tree to be dequantized inside "
        "a jit so HBM reads stay int8. build_int8_head_slabs runs once per "
        "load, on the host: it dequantizes the served heads' leaves to f32, "
        "stacks them and quantizes the slabs again (as the JAX engine's "
        "slab builder does under jit); the forward reads only the int8 "
        "slabs, through int8_linear"),
    ("VMT122", "config.py",
     "image_buckets: Sequence[int] = (1, 2, 4, 8, 10)"): _KNOB,
    ("VMT122", "config.py",
     "throughput_buckets: Sequence[int] | None = (16, 32)"): _KNOB,
}
# How many times each expected finding is reported (the drain wait of a
# swap and of a retirement are the same source line).
TIMES = {("VMT120", "serve/pool.py", "self._wait_locked("): 2}


@pytest.fixture(scope="module")
def findings():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-m", "vilbert_multitask_tpu.analysis", PORT,
         "--no-baseline", "--format", "json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    report = json.loads(run.stdout)
    assert run.returncode in (0, 1), run.stderr
    assert report["files_scanned"] > 80  # the whole port was read
    found: dict = {}
    for f in report["findings"]:
        key = (f["rule"], os.path.relpath(f["path"], PORT), f["content"])
        found[key] = found.get(key, 0) + 1
    return found


@pytest.mark.parametrize("key", sorted(EXPECTED), ids=lambda k: k[0])
def test_each_named_finding_is_reported_and_justified(findings, key):
    assert findings.get(key) == TIMES.get(key, 1), (key, findings)
    assert len(EXPECTED[key]) > 80


def test_the_port_has_no_other_lint_finding(findings):
    assert set(findings) - set(EXPECTED) == set(), findings


def test_every_inline_suppression_is_the_references_own():
    copied = 0
    for dirpath, _, files in os.walk(os.path.join(REPO, PORT)):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                lines = [ln.strip() for ln in f if "vmtlint: disable" in ln]
            if not lines:
                continue
            ref = path.replace(os.path.join(REPO, PORT),
                               os.path.join(REPO, "vilbert_multitask_tpu"))
            with open(ref) as f:
                theirs = {ln.strip() for ln in f}
            assert [ln for ln in lines if ln not in theirs] == [], path
            copied += len(lines)
    assert copied > 0
