"""Grover denoiser training steps, back to back (a closed loop).

Each step is the one ``tools/grover_train.py`` builds:
``make_loss_train_step(make_grover_loss(cfg, target_bonus),
grover_optimizer(lr, steps, warmup))``, the full float32 step with the
hidden dropout drawn from the step's generator. Parameters:

    batch, seq      rows a step and tokens a row (the rows hold seq + 1
                    ids, in ``lm_batches``' layout)
    fill_min        the shortest row before its padding, as a share of
                    seq + 1; the rest is id 0
    distinct        distinct batches, made from the seed (the first
                    ``check_steps`` steps all differ)
    check_steps     steps the reference follows

A row is a context then its denoise target: ids drawn from 1..vocab-1 on
the card, ``is_target`` 1 from a cut point drawn in the middle third of
the row's filled part to its end, as ``tools/grover_data.py`` lays out
the denoiser's examples.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.harness import counts
from benchmark.harness.cell import TrainingCell, generator, step_seed


def lm_batches(dev, seed: int, *, n: int, batch: int, seq: int, vocab: int,
               fill_min: float) -> List[Dict[str, torch.Tensor]]:
    out = []
    width = seq + 1
    pos = torch.arange(width, device=dev)
    for k in range(n):
        g = generator(dev, step_seed(seed, k, salt=2))
        ids = torch.randint(1, vocab, (batch, width), generator=g, device=dev)
        filled = torch.randint(int(fill_min * width), width + 1, (batch, 1), generator=g,
                               device=dev)
        u = torch.rand((batch, 1), generator=g, device=dev)
        cut = (filled.float() * (1.0 + u) / 3.0).long()
        ids = torch.where(pos < filled, ids, torch.zeros_like(ids))
        is_target = ((pos >= cut) & (pos < filled)).int()
        out.append({"input_ids": ids.int(), "is_target": is_target})
    return out


class Cell(TrainingCell):
    causal_attention = True
    control = "tf32"

    def build_program(self):
        from merlot_tpu_torch.models.grover import GroverConfig, GroverLM
        from merlot_tpu_torch.tools.grover_train import grover_optimizer, make_grover_loss
        from merlot_tpu_torch.train.train_step import make_loss_train_step
        c, p = self.ctx.config, self.ctx.params
        names = set(GroverConfig.__dataclass_fields__)
        cfg = GroverConfig(**{k: v for k, v in c["model"].items() if k in names})
        o = c["optimizer"]
        opt = grover_optimizer(o["learning_rate"], o["num_train_steps"], o["num_warmup_steps"])
        self.beta_1 = opt.cfg.beta_1
        self.work_per_step = p["batch"] * p["seq"]
        model = GroverLM(cfg, device=self.dev)
        step = make_loss_train_step(make_grover_loss(cfg, c["target_bonus"]), opt,
                                    device=self.dev)
        return model, opt, step

    def make_batches(self):
        p, m = self.ctx.params, self.ctx.config["model"]
        return lm_batches(self.dev, self.ctx.seed, n=p["distinct"], batch=p["batch"],
                          seq=p["seq"], vocab=m["vocab_size"], fill_min=p["fill_min"])

    def half_batch(self, batch):
        half = self.ctx.params["batch"] // 2
        return {k: v[:half] for k, v in batch.items()}

    def build_reference(self, precision: str):
        from benchmark.reference.grover import GroverLM
        if precision != "fp32":
            raise ValueError("grover-medium computes in float32 throughout: its control "
                             "is TF32")
        return GroverLM(self.ctx.config["model"], device=self.dev)

    def reference_loss(self, model, batch, g):
        from benchmark.reference.grover import grover_loss
        return grover_loss(model, batch, g, remat=True,
                           target_bonus=self.ctx.config["target_bonus"]), {}

    def flops_per_step(self) -> float:
        p = self.ctx.params
        return 3.0 * counts.grover_forward_flops(self.ctx.config["model"], p["batch"], p["seq"])

    def peak_flops(self) -> float:
        return counts.peak_flops("fp32")
