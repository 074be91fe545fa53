"""MERLOT pretraining steps, back to back (a closed loop).

Each step is the port's ``train.train_step.make_train_step`` over
``MerlotPretrainModel`` and ``MerlotAdamW``: the forward with all three
objectives, hidden dropout and attention-guided masking drawn from the
step's generator, the backward, the AdamW update. Parameters:

    cell            the configuration's per-cell block (image size, group)
    examples        examples a step
    chunks          frame+caption segments an example
    tokens          caption tokens a segment
    pad_min         the shortest caption; each is padded with id 0 after a
                    length drawn from [pad_min, tokens]
    distinct        distinct batches, made from the seed; the steps cycle
                    through them (the first ``check_steps`` all differ)
    check_steps     steps the reference follows

A batch is ``chip_smoke.py``'s ``pretrain_batch`` layout made on the card
from the seed: frames uniform in [0, 1], ids from 100..50356, each group
of segments one video (``video_src_ids``) in order (``shuffled_idx_img``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from benchmark.harness import counts
from benchmark.harness.cell import TrainingCell, generator, step_seed


def model_keys(config: Dict[str, Any], cell: str) -> Dict[str, Any]:
    return {**config["model"], **config["per_cell"][cell]}


def pretrain_batches(dev, seed: int, *, n: int, examples: int, chunks: int, tokens: int,
                     pad_min: int, image_size, group: int) -> List[Dict[str, torch.Tensor]]:
    out = []
    for k in range(n):
        g = generator(dev, step_seed(seed, k, salt=1))
        n_img = examples * chunks
        h, w = image_size
        ids = torch.randint(100, 50357, (examples, chunks, tokens), generator=g, device=dev)
        keep = torch.randint(pad_min, tokens + 1, (examples, chunks, 1), generator=g, device=dev)
        ids = torch.where(torch.arange(tokens, device=dev) < keep, ids, torch.zeros_like(ids))
        out.append({
            "images": torch.rand((n_img, h, w, 3), generator=g, device=dev),
            "input_ids": ids,
            "shuffled_idx_img": torch.arange(group, device=dev).repeat(n_img // group),
            "video_src_ids": torch.arange(n_img // group, device=dev)
            .repeat_interleave(group).reshape(examples, chunks),
        })
    return out


class Cell(TrainingCell):
    def build_program(self):
        from merlot_tpu_torch.models.config import MerlotConfig
        from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
        from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
        from merlot_tpu_torch.train.train_step import make_train_step
        p = self.ctx.params
        self.keys = model_keys(self.ctx.config, p["cell"])
        cfg = MerlotConfig.from_dict(self.keys)
        model = MerlotPretrainModel(cfg, device=self.dev)
        opt = MerlotAdamW(AdamWConfig.from_config(self.ctx.config["optimizer"]))
        self.beta_1 = opt.cfg.beta_1
        self.work_per_step = p["examples"] * p["chunks"]
        return model, opt, make_train_step(model, opt, device=self.dev)

    def make_batches(self):
        p = self.ctx.params
        return pretrain_batches(self.dev, self.ctx.seed, n=p["distinct"],
                                examples=p["examples"], chunks=p["chunks"],
                                tokens=p["tokens"], pad_min=p["pad_min"],
                                image_size=self.keys["image_size"],
                                group=self.keys["num_chunks_in_group"])

    def half_batch(self, batch):
        e = self.ctx.params["examples"] // 2
        n_img = e * self.ctx.params["chunks"]
        return {"images": batch["images"][:n_img], "input_ids": batch["input_ids"][:e],
                "shuffled_idx_img": batch["shuffled_idx_img"][:n_img],
                "video_src_ids": batch["video_src_ids"][:e]}

    def build_reference(self, precision: str):
        from benchmark.reference.merlot import MerlotPretrainModel, reference_config
        return MerlotPretrainModel(reference_config(self.keys, precision=precision,
                                                    remat=True), device=self.dev)

    def reference_loss(self, model, batch, g):
        return model(batch, g)

    # the contrastive losses read the language-only tower and the ViT alone,
    # before the masking: numbers the masked positions cannot move
    parts = ("contr/lang_to_viz", "contr/viz_to_lang")

    def flops_per_step(self) -> float:
        p = self.ctx.params
        return 3.0 * counts.merlot_forward_flops(
            self.keys, examples=p["examples"], chunks=p["chunks"], tokens=p["tokens"],
            image_size=self.keys["image_size"], group=self.keys["num_chunks_in_group"],
            pretrain=True)

    def peak_flops(self) -> float:
        return counts.peak_flops("bf16" if self.keys.get("use_bfloat16", True) else "fp32")
