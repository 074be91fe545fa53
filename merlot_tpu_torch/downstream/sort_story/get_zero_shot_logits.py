"""Zero-shot story-ordering CLI (counterpart of
merlot_tpu/downstream/sort_story/get_zero_shot_logits.py):

    python -m merlot_tpu_torch.downstream.sort_story.get_zero_shot_logits \
        config.yaml [--device cpu]
    torchrun --nproc_per_node N -m \
        merlot_tpu_torch.downstream.sort_story.get_zero_shot_logits config.yaml

Loads the latest checkpoint under ``device.output_dir/checkpoints`` (the
port's format), runs every story of ``data.val_file`` through the temporal
heads and writes ``logits_{split}.npz`` (``data.split_name``, default
``val``) in the working directory; score it with
``python -m merlot_tpu_torch.downstream.sort_story.score_permutations``.
One group is one story: the model's ``num_chunks_in_group``, when set,
must equal ``data.num_chunks`` (default 5), so a config derived from
``configs/pretrain_5seg.yaml`` (30 chunks in groups of 5) sets
``data.num_chunks: 5``. The run is on the CUDA device unless ``--device
cpu`` asks for the CPU.

A pretrain checkpoint roots its tree at ``merlot/`` (``MerlotPretrainModel``
holds the ``MerlotModel`` there); the CLI then loads that subtree. The JAX
package's CLI applies such a tree to a bare ``MerlotModel`` as it is and
fails to find its parameters.

Launched as N ranks (torchrun), the batches are spread over them whole
(``run_zero_shot`` with the mesh) and rank 0 writes the ``.npz``, which
equals one process's bit for bit.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.core.config import NeatConfig
from merlot_tpu_torch.downstream.sort_story.dataloader import story_batches
from merlot_tpu_torch.downstream.sort_story.zero_shot import run_zero_shot
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.parallel.mesh import join_from_env, leave, refuse_model_axis
from merlot_tpu_torch.train.checkpoint import CheckpointManager, load_params

PRETRAIN_ROOT = "merlot/"


def merlot_subtree(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A checkpoint's ``MerlotModel`` leaves by flax path: the ``merlot/``
    subtree when every leaf lies under it (a pretrain checkpoint), else the
    tree as it is (a bare model's)."""
    if flat and all(k.startswith(PRETRAIN_ROOT) for k in flat):
        return {k[len(PRETRAIN_ROOT):]: v for k, v in flat.items()}
    return dict(flat)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None). Returns the
    path written and the number of stories in it."""
    ap = argparse.ArgumentParser(description="Zero-shot story ordering")
    ap.add_argument("config_file", help="Path to the config.yaml")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    config = NeatConfig.from_yaml(args.config_file)
    refuse_model_axis(config.device.get("model_parallelism", 1), "zero-shot CLI",
                      "merlot_tpu/downstream/sort_story/zero_shot.py:118")
    device, mesh = join_from_env(args.device)
    try:
        return _run(config, device, mesh)
    finally:
        leave(mesh)


def _run(config: NeatConfig, device, mesh) -> Dict[str, object]:
    num_chunks = config.data.get("num_chunks", 5)
    cfg = MerlotConfig.from_dict(config.model)
    if (cfg.num_chunks_in_group or num_chunks) != num_chunks:
        raise ValueError(f"model.num_chunks_in_group {cfg.num_chunks_in_group} != "
                         f"data.num_chunks {num_chunks}: zero-shot takes one group "
                         f"per story (set data.num_chunks: {cfg.num_chunks_in_group})")

    ckpt = CheckpointManager(os.path.join(config.device["output_dir"], "checkpoints"))
    latest = ckpt.latest_step()
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt.directory}")
    model = MerlotModel(cfg.eval_mode(), device=device).eval()
    load_flax_params(model, merlot_subtree(load_params(ckpt.path(latest))))

    files = config.data.get("val_file_expanded") or []
    if not files:
        raise ValueError("data.val_file matched no files")
    batch_size = config.device.get("val_batch_size", 8)
    merged = {"num_chunks": num_chunks, "image_size": list(cfg.image_size)}
    out_path = f"logits_{config.data.get('split_name', 'val')}.npz"
    n = run_zero_shot(model, story_batches(files, merged, batch_size), out_path,
                      batch_size=batch_size, num_chunks=num_chunks, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(f"wrote {n} stories to {out_path}")
    return {"path": out_path, "stories": n}


if __name__ == "__main__":
    main()
