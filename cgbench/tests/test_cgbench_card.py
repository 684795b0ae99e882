"""On the card: a short run of every cell comes out correct with its
metrics, and the control comes out not correct. Skips without CUDA."""
import json
import subprocess
import sys

import pytest

from cgbench.harness.spec import ROOT, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _last_json(args):
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.strip().splitlines()]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = _last_json(["cgbench/run.py", "--workload", cell, "--seed",
                      "4000000007", "--seconds", "3", "--trace",
                      str(trace)])[-1]
    assert out["correct"], out["checks"]
    assert out["metrics"] and out["device"]["platform"] == "gpu"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    rows = _last_json(["cgbench/control.py", "--workload", cell,
                       "--seconds", "2", "--seeds", "4000000011"])
    assert rows and not any(r["correct"] for r in rows)
