"""run.py's refusals: no result line, and a code other than 0, without a
CUDA card, and in a directory that holds only BENCHMARK.json and the
benchmark's own files (no port)."""

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import registry

ARGS = ["--workload", "merlot-base.pretrain", "--seed", str(2 ** 31 + 3), "--seconds", "1",
        "--trace", "0"]


def run(root):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run(registry.ROOT)
    assert out.returncode == 2 and out.stdout == "", out.stderr


def test_without_the_port(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout == "", out.stderr
