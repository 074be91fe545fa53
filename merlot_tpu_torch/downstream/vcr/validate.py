"""VCR evaluation sidecar (counterpart of
merlot_tpu/downstream/vcr/validate.py):

    python -m merlot_tpu_torch.downstream.vcr.validate config.yaml [--device cpu]
    torchrun --nproc_per_node N -m merlot_tpu_torch.downstream.vcr.validate config.yaml

Polls ``device.output_dir/checkpoints`` for new checkpoints until
``validate.eval_timeout`` seconds (default 72000) have passed; each new one
is evaluated on ``data.val_file`` in ``downstream.mode`` ('answer' or
'rationale'), at most ``validate.eval_samples`` examples, and its accuracy
logged under ``output_dir/eval``. A checkpoint deleted or unreadable when
its turn comes is skipped.

Launched as N ranks (torchrun), the evaluation is spread over them as the
JAX sidecar spreads it over its devices: every rank reads the eval stream,
batch i is evaluated by rank i mod N, and the ranks' logits are gathered
so that every rank computes the accuracy of the whole set and rank 0 writes
the metrics and predictions. Rank 0 decides which checkpoints to evaluate
and when the poll ends. The results equal one process's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zipfile
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.core.config import NeatConfig
from merlot_tpu_torch.downstream.vcr.dataloader import vcr_eval_batches
from merlot_tpu_torch.downstream.vcr.modeling import VCRModel
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.parallel.mesh import Mesh, join_from_env, leave, refuse_model_axis
from merlot_tpu_torch.train.checkpoint import CheckpointManager, load_params
from merlot_tpu_torch.train.metrics import MetricsLogger
from merlot_tpu_torch.train.train_step import _device

# what reading a checkpoint that is deleted or half-written can raise
UNREADABLE = (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile)


def log_probs(logits: np.ndarray) -> np.ndarray:
    """The log-softmax the predictions file holds, computed as the JAX
    sidecar computes it."""
    m = logits.max(-1, keepdims=True)
    return logits - np.log(np.exp(logits - m).sum(-1, keepdims=True)) - m


@torch.no_grad()
def evaluate_checkpoint(model: VCRModel, files, config: Dict[str, Any], batch_size: int,
                        mode: str, max_examples: Optional[int] = None,
                        predictions_path: Optional[str] = None,
                        mesh: Optional[Mesh] = None) -> float:
    """The accuracy of ``model`` (its parameters as they are, on its
    device) over the eval set; with ``predictions_path``, one JSON line per
    example with its annot_id, prediction, label and log-probs (the
    reference's PREDICT-mode export for leaderboard submissions). With
    ``mesh``, rank i mod N evaluates batch i, every rank returns the
    accuracy of the whole set and rank 0 writes the predictions."""
    device = next(model.parameters()).device
    metas, logits = [], {}
    n_total = 0
    for i, batch in enumerate(vcr_eval_batches(files, config, batch_size, mode=mode)):
        metas.append((batch["annot_id"], batch["lm_targets"]))
        if mesh is None or i % mesh.data == mesh.rank:
            logits[i] = model(torch.from_numpy(batch["images"]).to(device),
                              torch.from_numpy(batch["lm_input"]).to(device),
                              mode=mode).cpu().numpy()
        n_total += len(batch["lm_targets"])
        if max_examples and n_total >= max_examples:
            break
    if mesh is not None:
        logits = {i: lg for part in mesh.all_gather_object(logits) for i, lg in part.items()}
    n_correct = n_total = 0
    write = predictions_path is not None and (mesh is None or mesh.rank == 0)
    pred_f = open(predictions_path, "w") if write else None
    try:
        for i, (annot_ids, labels) in enumerate(metas):
            pred = np.argmax(logits[i], -1)
            if pred_f is not None:
                logp = log_probs(logits[i])
                for j in range(len(pred)):
                    pred_f.write(json.dumps({
                        "annot_id": annot_ids[j].decode(),
                        "prediction": int(pred[j]),
                        "label": int(labels[j]),
                        "log_probs": [float(x) for x in logp[j]]}) + "\n")
            n_correct += int((pred == labels).sum())
            n_total += len(pred)
    finally:
        if pred_f is not None:
            pred_f.close()
    return n_correct / max(n_total, 1)


def watch_and_validate(config: NeatConfig, poll_seconds: float = 60.0,
                       device="cuda", mesh: Optional[Mesh] = None) -> Dict[int, float]:
    """Evaluate every checkpoint that appears until the timeout; returns
    the accuracy of each step evaluated. With ``mesh`` (``device`` is then
    this rank's), rank 0's listing and clock decide for every rank."""
    model = VCRModel(MerlotConfig.from_dict(config.model).eval_mode(),
                     device=_device(device)).eval()
    agree = (lambda x: x) if mesh is None else mesh.broadcast_object
    chief = mesh is None or mesh.rank == 0
    mode = config.downstream.get("mode", "answer")
    merged = config.merged_data_model()
    merged.update(config.downstream)
    files = config.data.get("val_file_expanded") or []
    timeout = config.validate.get("eval_timeout", 72000)
    max_examples = config.validate.get("eval_samples")
    batch_size = config.device.get("val_batch_size", 8)

    ckpt = CheckpointManager(os.path.join(config.device["output_dir"], "checkpoints"))
    logger = (MetricsLogger(os.path.join(config.device["output_dir"], "eval"), name="eval")
              if chief else None)
    seen: Dict[int, float] = {}
    skipped = set()
    t0 = time.time()
    try:
        while agree(time.time() - t0 < timeout):
            new_steps = agree([s for s in ckpt.all_steps()
                               if s not in seen and s not in skipped])
            for step in new_steps:
                try:
                    params = load_params(ckpt.path(step))
                    failed = None
                except UNREADABLE as e:      # gone or half-written: skip it
                    failed = str(e)
                if mesh is not None:  # skipped by all if unreadable on any rank
                    failed = next((f for f in mesh.all_gather_object(failed) if f), None)
                if failed is not None:
                    print(f"skipping step {step}: {failed}")
                    skipped.add(step)
                    continue
                load_flax_params(model, params)
                seen[step] = evaluate_checkpoint(model, files, merged, batch_size, mode,
                                                 max_examples, mesh=mesh)
                if logger is not None:
                    logger.log(step, {f"{mode}_accuracy": seen[step]})
            if not new_steps:
                time.sleep(poll_seconds)
    finally:
        if logger is not None:
            logger.close()
    return seen


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, float]:
    ap = argparse.ArgumentParser(description="VCR validation sidecar")
    ap.add_argument("config_file", help="Path to the config.yaml")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    config = NeatConfig.from_yaml(args.config_file)
    refuse_model_axis(config.device.get("model_parallelism", 1), "VCR validation",
                      "merlot_tpu/downstream/vcr/validate.py:53")
    device, mesh = join_from_env(args.device)
    try:
        return watch_and_validate(config, device=device, mesh=mesh)
    finally:
        leave(mesh)


if __name__ == "__main__":
    main()
