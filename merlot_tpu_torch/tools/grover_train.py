"""Grover denoiser LM training (counterpart of
merlot_tpu/tools/grover_train.py):

    python -m merlot_tpu_torch.tools.grover_train --config medium.json \\
        --train_files 'shards/*.tfrecord' --output_dir out [--device cpu]

Next-token training on fixed-length tfrecord sequences
(``tools/grover_data.lm_batches``) with the x``target_bonus`` weighting on
denoise targets (``grover_lm_loss`` over ``input_ids[:, :-1]`` and
``is_target[:, 1:]``), the hidden dropout drawn per step from the Trainer's
generator, and the JAX package's AdamW block: weight decay 0.01 (none on
``embed_norm``, ``mlp_ln``, biases and LayerNorm scales), beta_2 0.98,
global-norm clipping at 1.0, linear warmup then decay. Checkpoints every
``--checkpoint_every`` steps into ``output_dir/checkpoints``; a run whose
output directory holds one resumes from the latest, its data stream
starting at the checkpoint's batch. A checkpoint's ``params.npz`` is what
``tools/denoise_server.py --ckpt`` serves.

The run is on the CUDA device unless ``--device cpu`` asks for the CPU; on
a card the attention is K1 forward and K2 backward.

Pipeline parallelism, ``--pp N`` (> 1) with ``--microbatches M`` (4 N by
default), one process per stage under torchrun:

    torchrun --nproc_per_node N -m merlot_tpu_torch.tools.grover_train \
        --config medium.json ... --pp N [--dist_backend gloo] [--device cpu]

The layer stack splits into N contiguous stages (``models.grover.
GroverStage``), one per rank, and each batch streams through the GPipe
schedule of ``parallel/pipeline.py`` in M microbatches of batch_size / M
rows, the hidden dropout keyed per (layer, microbatch). As in JAX's CLI
the world is the stages alone (the world size must equal N: no data axis),
num_hidden_layers must divide by N and batch_size by M. The weights are
the ``--pp 1`` run's (the whole model drawn from the seed); checkpoints
hold JAX's ``--pp`` form (``stages/<leaf>`` [N, L/N, ...]), which the
denoise server unstacks, and restore at the same N. Every rank reads the
batches; stage 0 embeds them, the last stage computes the loss, and global
rank 0 logs and writes. ``--dist_backend gloo`` lets the ranks share one
card (NCCL refuses two ranks on one device; gloo moves the hops through
the host).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Any, Dict, Optional, Sequence

import torch

from merlot_tpu_torch.models.grover import (GroverConfig, GroverLM, GroverStage,
                                            grover_lm_loss, grover_pipeline_forward)
from merlot_tpu_torch.parallel.mesh import join_from_env, launched_distributed, leave
from merlot_tpu_torch.tools.grover_data import lm_batches
from merlot_tpu_torch.train.harness import Trainer
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import (_device, make_loss_train_step,
                                               make_pipeline_loss_train_step)

NO_DECAY = ("embed_norm", "mlp_ln", "bias", "gamma", "beta")


def grover_optimizer(learning_rate: float, num_train_steps: int,
                     num_warmup_steps: int) -> MerlotAdamW:
    """The JAX CLI's AdamW block."""
    return MerlotAdamW(AdamWConfig(
        learning_rate=learning_rate, num_train_steps=num_train_steps,
        num_warmup_steps=num_warmup_steps, weight_decay_rate=0.01, beta_2=0.98,
        clip_norm=1.0, param_overrides=((NO_DECAY, {"weight_decay_rate": 0.0}),)))


def make_grover_loss(cfg: GroverConfig, target_bonus: float):
    """``loss_fn(model, batch, generator) -> (loss, metrics)``: the training
    forward on input_ids[:, :-1] and the weighted loss against
    is_target[:, 1:]."""
    def loss_fn(model, batch, generator):
        ids = batch["input_ids"][:, :-1]
        logits, _ = model(ids, deterministic=False, generator=generator)
        return grover_lm_loss(logits, ids, batch["is_target"][:, 1:],
                              pad_token_id=cfg.pad_token_id, target_bonus=target_bonus)
    return loss_fn


def make_grover_pipeline_loss(cfg: GroverConfig, target_bonus: float, mesh,
                              num_microbatches: int):
    """``loss_fn(stage, batch, generator) -> (loss, metrics, pipeline)``: the
    pipeline-parallel forward on input_ids[:, :-1] (dropout keyed per
    (layer, microbatch) from the generator) and, on the last stage, the
    weighted loss against is_target[:, 1:] over the whole batch; (None,
    None, pipeline) on the other stages."""
    def loss_fn(stage, batch, generator):
        ids = batch["input_ids"][:, :-1]
        logits, pipe = grover_pipeline_forward(stage, ids, mesh=mesh,
                                               num_microbatches=num_microbatches,
                                               generator=generator)
        if logits is None:
            return None, None, pipe
        loss, metrics = grover_lm_loss(logits, ids, batch["is_target"][:, 1:],
                                       pad_token_id=cfg.pad_token_id,
                                       target_bonus=target_bonus)
        return loss, metrics, pipe
    return loss_fn


def check_pipeline_args(cfg: GroverConfig, pp: int, batch_size: int, microbatches: int) -> int:
    """JAX's CLI's asserts on ``--pp`` and ``--microbatches``, raised with
    the reason; returns the microbatch count (4 pp by default). The world
    must be the stages alone."""
    if cfg.num_hidden_layers % pp:
        raise ValueError(f"--pp {pp}: {cfg.num_hidden_layers} layers do not split into {pp} "
                         f"stages (num_hidden_layers % pp must be 0)")
    m = microbatches or 4 * pp
    if batch_size % m:
        raise ValueError(f"--batch_size {batch_size} does not split into {m} microbatches "
                         f"(batch_size % microbatches must be 0)")
    world = int(os.environ["WORLD_SIZE"]) if launched_distributed() else 1
    if world != pp:
        raise ValueError(f"--pp {pp} with a world of {world} process(es): the world size must "
                         f"equal pp (JAX's CLI has no data axis and takes the first pp "
                         f"devices); launch pp ranks under torchrun "
                         f"(torchrun --nproc_per_node {pp} ...)")
    return m


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None). Returns the
    trainer (its model holds the trained parameters) and the optimizer
    state."""
    ap = argparse.ArgumentParser(description="Grover denoiser LM training")
    ap.add_argument("--config", required=True, help="GroverConfig json")
    ap.add_argument("--train_files", required=True, help="glob of LM tfrecord shards")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--seq_length", type=int, default=1536)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--learning_rate", type=float, default=1e-5)
    ap.add_argument("--num_train_steps", type=int, default=80000)
    ap.add_argument("--num_warmup_steps", type=int, default=1000)
    ap.add_argument("--target_bonus", type=float, default=4.0)
    ap.add_argument("--checkpoint_every", type=int, default=5000)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages, one rank each under torchrun (the world "
                         "size must equal it): the layer stack splits into contiguous "
                         "stages and microbatches stream through a GPipe schedule; dropout "
                         "is keyed per (layer, microbatch)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="GPipe microbatches (default 4*pp; batch_size must divide by it)")
    ap.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                    help="with --pp > 1: the process group's backend (default NCCL on "
                         "CUDA, gloo on the CPU; gloo lets the ranks share one card)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    files = sorted(glob.glob(args.train_files))
    if not files:
        raise ValueError(f"no files match {args.train_files}")
    cfg = GroverConfig.from_json_file(args.config)
    optimizer = grover_optimizer(args.learning_rate, args.num_train_steps,
                                 args.num_warmup_steps)
    mesh = None
    if args.pp > 1:
        num_mb = check_pipeline_args(cfg, args.pp, args.batch_size, args.microbatches)
        device, mesh = join_from_env(args.device, stage=args.pp, backend=args.dist_backend)
    else:
        device = _device(args.device)
    try:
        if mesh is None:
            model = GroverLM(cfg, device=device)
            step_fn = make_loss_train_step(make_grover_loss(cfg, args.target_bonus),
                                           optimizer, device=device)
        else:
            model = GroverStage(cfg, args.pp, mesh.stage_rank, device=device)
            step_fn = make_pipeline_loss_train_step(
                make_grover_pipeline_loss(cfg, args.target_bonus, mesh, num_mb), optimizer,
                mesh=mesh, device=device)
        trainer = Trainer(model, optimizer, output_dir=args.output_dir,
                          log_every=args.log_every, checkpoint_every=args.checkpoint_every,
                          device=device, mesh=mesh)
        trainer.step_fn = step_fn
        # a resumed run continues the data stream where the checkpoint left it
        opt_state = trainer.init_state()
        batches = ({k: torch.from_numpy(v) for k, v in b.items()}
                   for b in lm_batches(files, args.seq_length, args.batch_size,
                                       start=int(opt_state["step"])))
        opt_state = trainer.run(opt_state, batches, num_steps=args.num_train_steps)
    finally:
        leave(mesh)
    return {"trainer": trainer, "opt_state": opt_state}


if __name__ == "__main__":
    main()
