"""VCR finetuning (counterpart of merlot_tpu/downstream/vcr/train.py):

    python -m merlot_tpu_torch.downstream.vcr.train config.yaml [--device cpu]
    torchrun --nproc_per_node N -m merlot_tpu_torch.downstream.vcr.train config.yaml

Joint answer+rationale training on the Trainer: the YAML's model block
builds a ``VCRModel``, its optimizer block the AdamW; the ``data`` section
merged with ``model`` and ``downstream`` configures the loader
(``vcr_joint_batches``), whose batches reach the card through
``device_iterator`` (images in bf16 when ``model.use_bfloat16``, the
default). A fresh run warm-starts from ``model.init_checkpoint`` (a port
checkpoint directory or a flax-path ``.npz``; a pretrain checkpoint roots
at ``merlot/`` as this model does, and leaves whose shape differs, such as
a position table for another image size, are skipped with a message); a
run with a checkpoint in ``device.output_dir`` resumes from it instead and
its data stream starts at the checkpoint's batch. Checkpoints every
``device.iterations_per_loop`` steps (default 2500), metrics every
``device.log_every`` (default 50). The run is on the CUDA device unless
``--device cpu`` asks for the CPU.

Launched as N ranks (torchrun), the run is data-parallel over the process
group, as the JAX CLI is over its devices: the JAX package's VCR loader has
no per-host slice, so every rank reads the same global stream of
``train_batch_size`` examples a batch and keeps its rows (each rank decodes
every batch); the loss is written over the global batch
(``vcr_loss_and_metrics`` with the mesh) and ``device.use_zero1`` splits
the Adam moments over the ranks. The world-N run trains on the batches of
the one-process run. ``model_parallelism > 1`` raises: JAX's VCR CLI runs
at model=1 whatever its config says (no tensor parallelism).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Sequence

from merlot_tpu_torch.core.config import NeatConfig
from merlot_tpu_torch.data.pretrain_loader import device_iterator
from merlot_tpu_torch.downstream.vcr.dataloader import vcr_joint_batches
from merlot_tpu_torch.downstream.vcr.modeling import VCRModel, vcr_loss_and_metrics
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.parallel.mesh import (Mesh, join_from_env, leave,
                                            refuse_model_axis, shard_batch)
from merlot_tpu_torch.train.harness import Trainer
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import _device, make_loss_train_step


def _refuse_model_axis(config: NeatConfig) -> None:
    refuse_model_axis(config.device.get("model_parallelism", 1), "VCR CLI",
                      "merlot_tpu/downstream/vcr/train.py:42")


def build_vcr_train(config: NeatConfig, device="cuda", mesh: Optional[Mesh] = None):
    """(model, optimizer, loss_fn) from a NeatConfig; ``loss_fn(model,
    batch, generator)`` is the training forward with dropout drawn from
    ``generator`` (this rank's share of the global loss with ``mesh``)."""
    _refuse_model_axis(config)
    model = VCRModel(MerlotConfig.from_dict(config.model), device=_device(device))
    optimizer = MerlotAdamW(AdamWConfig.from_config(config.optimizer))

    def loss_fn(model, batch, generator):
        logits = model(batch["images"], batch["lm_input"], deterministic=False,
                       generator=generator)
        return vcr_loss_and_metrics(logits, batch["lm_targets"], mesh)

    return model, optimizer, loss_fn


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None). Returns the
    trainer (its model holds the trained parameters) and the optimizer
    state."""
    ap = argparse.ArgumentParser(description="VCR finetuning")
    ap.add_argument("config_file", help="Path to the config.yaml")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    config = NeatConfig.from_yaml(args.config_file)
    _refuse_model_axis(config)
    device, mesh = join_from_env(args.device)
    try:
        return _run(config, device, mesh)
    finally:
        leave(mesh)


def _run(config: NeatConfig, device, mesh: Optional[Mesh]) -> Dict[str, Any]:
    model, optimizer, loss_fn = build_vcr_train(config, device, mesh)

    merged = config.merged_data_model()
    merged.update(config.downstream)
    files = config.data.get("train_file_expanded") or []
    if not files:
        raise ValueError("data.train_file matched no files")

    trainer = Trainer(model, optimizer, output_dir=config.device["output_dir"],
                      log_every=config.device.get("log_every", 50),
                      checkpoint_every=config.device.get("iterations_per_loop", 2500),
                      device=device, mesh=mesh, zero1=config.device.get("use_zero1", False))
    trainer.step_fn = make_loss_train_step(loss_fn, optimizer, device=device, mesh=mesh,
                                           zero1=trainer.zero1)
    # a fresh run warm-starts; a resumed one keeps its own weights
    opt_state = trainer.init_state(init_checkpoint=config.model.get("init_checkpoint"))
    host = vcr_joint_batches(files, merged, batch_size=config.device["train_batch_size"],
                             start=int(opt_state["step"]))
    if mesh is not None:
        host = (shard_batch(b, mesh) for b in host)
    batches = device_iterator(host, device,
                              images_bf16=config.model.get("use_bfloat16", True))
    opt_state = trainer.run(opt_state, batches,
                            num_steps=config.optimizer["num_train_steps"])
    return {"trainer": trainer, "opt_state": opt_state}


if __name__ == "__main__":
    main()
