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
a card the attention is K1 forward and K2 backward. ``--pp > 1``
(pipeline-parallel stages) is not ported.
"""

from __future__ import annotations

import argparse
import glob
import sys
from typing import Any, Dict, Optional, Sequence

import torch

from merlot_tpu_torch.models.grover import GroverConfig, GroverLM, grover_lm_loss
from merlot_tpu_torch.tools.grover_data import lm_batches
from merlot_tpu_torch.train.harness import Trainer
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import _device, make_loss_train_step

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
                    help="pipeline-parallel stages (not ported: only 1)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="GPipe microbatches (with --pp > 1 only)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.pp > 1:
        raise NotImplementedError("pipeline-parallel training (--pp > 1) needs a device "
                                  "mesh and the GPipe schedule (M7b), which this package "
                                  "does not have yet")
    device = _device(args.device)
    files = sorted(glob.glob(args.train_files))
    if not files:
        raise ValueError(f"no files match {args.train_files}")

    cfg = GroverConfig.from_json_file(args.config)
    model = GroverLM(cfg, device=device)
    optimizer = grover_optimizer(args.learning_rate, args.num_train_steps,
                                 args.num_warmup_steps)
    trainer = Trainer(model, optimizer, output_dir=args.output_dir,
                      log_every=args.log_every, checkpoint_every=args.checkpoint_every,
                      device=device)
    trainer.step_fn = make_loss_train_step(make_grover_loss(cfg, args.target_bonus),
                                           optimizer, device=device)
    # a resumed run continues the data stream where the checkpoint left it
    opt_state = trainer.init_state()
    batches = ({k: torch.from_numpy(v) for k, v in b.items()}
               for b in lm_batches(files, args.seq_length, args.batch_size,
                                   start=int(opt_state["step"])))
    opt_state = trainer.run(opt_state, batches, num_steps=args.num_train_steps)
    return {"trainer": trainer, "opt_state": opt_state}


if __name__ == "__main__":
    main()
