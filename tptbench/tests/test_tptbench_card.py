"""The command on the card: a short run of each cell prints a result line
with the keys in order and `correct` true. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from tptbench import run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["fireplace_sweep.static",
                                  "fireplace_svgf.orbit"])
def test_cell_runs_correct(card, cell):
    proc = subprocess.run(
        [sys.executable, "-m", "tptbench.run", "--workload", cell,
         "--seed", "2147483905", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=run.ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
