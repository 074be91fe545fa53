"""Every cell end to end on the card, at its own sizes: one short run of
``run.py`` each, whose result line is correct and holds the contract's
keys. Marked ``gpu``; skipped without a CUDA card."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import registry

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, str(registry.BENCH_DIR / "run.py"), "--workload",
                          cell, "--seed", str(2 ** 32 + 11), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert {"setup_s", registry.workload(cell)["rate"]["metric"]} <= set(res["metrics"])
