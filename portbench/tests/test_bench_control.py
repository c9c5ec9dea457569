"""The control comes out not correct: each cell run on the card with its
answers given by the plain reference in fp8 compute (the precision below
the configuration's bf16) and, for uploads, the detector's convolutions in
TF32 (its own path below f32), at the cell's own size over a short window.
Needs the card; run there with ``python3 -m pytest portbench/tests -m
cuda``."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bf16-prepared", "upload-poisson",
                                      "upload-mixed"])
def test_the_control_is_not_correct(card, workload, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", "2718281828", "--seconds", "10", "--trace", "0",
         "--control"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
    assert any(float(c["value"]) > c["limit"]
               for c in line["checks"].values())
