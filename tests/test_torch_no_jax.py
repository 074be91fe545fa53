"""merlot_tpu_torch imports neither jax nor flax: every module is imported
in a fresh interpreter, which then must hold no jax or flax module."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, pkgutil, sys
import merlot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(merlot_tpu_torch.__path__,
                                                "merlot_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not bad, bad
assert len(names) >= 31, names
assert {"merlot_tpu_torch.models.grover", "merlot_tpu_torch.tools.denoise_server",
        "merlot_tpu_torch.core.tokenizer", "merlot_tpu_torch.ops.cuda_groupnorm",
        "merlot_tpu_torch.ops.cuda_ln_matmul"} <= set(names), names
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
