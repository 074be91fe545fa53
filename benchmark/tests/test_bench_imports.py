"""Nothing under benchmark/ imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole: merlot_tpu_torch begins with
merlot_tpu), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "merlot_tpu"}
FILES = sorted(p for p in registry.BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(registry.BENCH_DIR)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((registry.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not imported(path) & (FORBIDDEN | {"merlot_tpu_torch"})


def test_the_whole_name_is_compared():
    from benchmark.run import loaded_forbidden
    assert loaded_forbidden(["merlot_tpu_torch", "merlot_tpu_torch.ops", "jaxtyping"]) == []
    assert loaded_forbidden(["merlot_tpu.ops.masking", "jax._src", "flax"]) == [
        "flax", "jax", "merlot_tpu"]


def test_a_cells_modules_load_no_jax():
    """The harness, every traffic kind and reader and the port's modules
    they import, in a fresh interpreter: no JAX module appears."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import registry, measure\n"
        "import benchmark.reference.merlot, benchmark.reference.grover, benchmark.calibrate\n"
        "b = registry.benchmark()\n"
        "for w in b['workloads']:\n"
        "    registry.traffic(registry.workload(w['name'])['traffic'])\n"
        "for m in b['per_layer']:\n"
        "    registry.reader(m['name'])\n"
        "import merlot_tpu_torch.train.train_step, merlot_tpu_torch.tools.grover_train\n"
        "import merlot_tpu_torch.downstream.sort_story.zero_shot\n"
        "from benchmark.run import loaded_forbidden\n"
        "print(loaded_forbidden())\n" % str(registry.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
