"""merlot_tpu_torch imports neither jax nor flax, nor the libraries the
card's machine may lack or that only some functions need (pyyaml, PIL,
orbax, h5py, sacremoses, cv2, tensorflow, tensorstore), nor
merlot_tpu: every module is imported in a fresh interpreter, which then
must hold none of them. Importing builds nothing: no native library
appears."""

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
bad = sorted(k for k in sys.modules if k.split(".")[0] in (
    "jax", "jaxlib", "flax", "yaml", "PIL", "orbax", "h5py", "sacremoses",
    "cv2", "merlot_tpu", "tensorflow", "tensorstore"))
assert not bad, bad
assert len(names) >= 67, names
assert {"merlot_tpu_torch.models.grover", "merlot_tpu_torch.tools.denoise_server",
        "merlot_tpu_torch.core.tokenizer", "merlot_tpu_torch.ops.cuda_groupnorm",
        "merlot_tpu_torch.ops.cuda_ln_matmul", "merlot_tpu_torch.core.config",
        "merlot_tpu_torch.data.tfrecord", "merlot_tpu_torch.data._native",
        "merlot_tpu_torch.data.image_ops", "merlot_tpu_torch.data.pretrain_loader",
        "merlot_tpu_torch.data.make_synthetic_tfrecord", "merlot_tpu_torch.train.metrics",
        "merlot_tpu_torch.train.checkpoint", "merlot_tpu_torch.train.harness",
        "merlot_tpu_torch.train.pretrain",
        "merlot_tpu_torch.downstream.sort_story.data",
        "merlot_tpu_torch.downstream.sort_story.dataloader",
        "merlot_tpu_torch.downstream.sort_story.download",
        "merlot_tpu_torch.downstream.sort_story.get_zero_shot_logits",
        "merlot_tpu_torch.downstream.sort_story.score_permutations",
        "merlot_tpu_torch.downstream.sort_story.zero_shot",
        "merlot_tpu_torch.downstream.vcr.data_prep",
        "merlot_tpu_torch.downstream.vcr.dataloader",
        "merlot_tpu_torch.downstream.vcr.modeling",
        "merlot_tpu_torch.downstream.vcr.train",
        "merlot_tpu_torch.downstream.vcr.validate",
        "merlot_tpu_torch.tools.grover_data", "merlot_tpu_torch.tools.grover_train",
        "merlot_tpu_torch.data.process", "merlot_tpu_torch.data.video",
        "merlot_tpu_torch.models.grover", "merlot_tpu_torch.parallel.mesh",
        "merlot_tpu_torch.tools.multiprocess_smoke",
        "merlot_tpu_torch.parallel.tensor_parallel",
        "merlot_tpu_torch.parallel.pipeline",
        "merlot_tpu_torch.tools.convert_tf_checkpoint",
        "merlot_tpu_torch.tools.download_checkpoint",
        "merlot_tpu_torch.tools.import_jax_checkpoint",
        "merlot_tpu_torch.ops.masks", "merlot_tpu_torch.ops.named_ops"} <= set(names), names
print(len(names))
"""


def test_port_imports_no_jax(tmp_path):
    import shutil
    # a copy of the package in an empty directory: what importing builds
    # would appear under its build/
    shutil.copytree(REPO / "merlot_tpu_torch", tmp_path / "merlot_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert not (tmp_path / "build").exists()
