"""Zero-shot story ordering over a dataset, batch after batch (a closed
loop).

Each call is the port's ``downstream.sort_story.zero_shot.make_zero_shot_fn``
on ``MerlotModel`` in its eval configuration: the stories tiled x2 with
the method's fixed frame permutations, one forward without masking, the
two temporal heads' probabilities. Parameters:

    cell            the configuration's per-cell block (image size, group)
    stories         stories a batch
    frames          frames (and captions) a story
    tokens          caption tokens
    pad_min         the shortest caption; each is padded with id 0 after a
                    length drawn from [pad_min, tokens]
    distinct        distinct batches made from the seed, cycled
    sampled         window outputs judged against the reference, drawn
                    from the seed (each distinct batch's first one always)

A batch is ``chip_smoke.py``'s ``synthetic_stories`` layout made on the
card from the seed: frames uniform in [0, 1], ids from 100..50356.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import compare, counts
from benchmark.harness.cell import Cell as BaseCell, free_cuda, generator, step_seed, tf32
from benchmark.harness.weights import load_into, make_weights, param_shapes


def story_batches(dev, seed: int, *, n: int, stories: int, frames: int, tokens: int,
                  pad_min: int, image_size) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    out = []
    for k in range(n):
        g = generator(dev, step_seed(seed, k, salt=3))
        images = torch.rand((stories, frames, *image_size, 3), generator=g, device=dev)
        ids = torch.randint(100, 50357, (stories, frames, tokens), generator=g, device=dev)
        keep = torch.randint(pad_min, tokens + 1, (stories, frames, 1), generator=g, device=dev)
        ids = torch.where(torch.arange(tokens, device=dev) < keep, ids, torch.zeros_like(ids))
        out.append((images, ids))
    return out


class Cell(BaseCell):
    def setup(self) -> None:
        from merlot_tpu_torch.downstream.sort_story.zero_shot import make_zero_shot_fn
        from merlot_tpu_torch.models.config import MerlotConfig
        from merlot_tpu_torch.models.merlot import MerlotModel
        p, c = self.ctx.params, self.ctx.config
        self.keys = {**c["model"], **c["per_cell"][p["cell"]]}
        self.model = MerlotModel(MerlotConfig.from_dict(self.keys).eval_mode(),
                                 device=self.dev).eval()
        self.shapes = param_shapes(self.model)
        load_into(self.model, make_weights(self.shapes, self.ctx.seed, self.dev))
        self.fn = make_zero_shot_fn(p["stories"], p["frames"])
        self.batches = story_batches(self.dev, self.ctx.seed, n=p["distinct"],
                                     stories=p["stories"], frames=p["frames"],
                                     tokens=p["tokens"], pad_min=p["pad_min"],
                                     image_size=self.keys["image_size"])
        self.i = 0
        for batch in self.batches:
            self.fn(self.model, *batch)

    def step(self):
        k = self.i % len(self.batches)
        out = self.fn(self.model, *self.batches[k])
        self.i += 1
        return self.ctx.params["stories"], (k, out)

    def failed(self, outs) -> int:
        return super().failed([o for _, o in outs])

    def release(self) -> None:
        self.model = self.fn = None
        free_cuda()

    def judged(self, n_outs: int) -> List[int]:
        """The window outputs judged: each distinct batch's first, and
        ``sampled`` more drawn from the seed."""
        first = list(range(min(n_outs, len(self.batches))))
        rng = np.random.default_rng(step_seed(self.ctx.seed, 0, salt=4))
        more = rng.choice(n_outs, size=min(n_outs, self.ctx.params["sampled"]), replace=False)
        return sorted(set(first) | {int(i) for i in more})

    def reference_probs(self, precision: str = "fp32", fault: Optional[str] = None
                        ) -> Dict[int, Dict[str, torch.Tensor]]:
        """The reference's probabilities for each distinct batch; the sites
        the configuration computes in bf16 rounded to ``precision``.
        ``fault``: 'half_batch' scores the first half of each batch's
        stories and gives the rest their mean."""
        from benchmark.reference.merlot import (MerlotModel, reference_config,
                                                zero_shot_logits, zero_shot_probs)
        p = self.ctx.params
        model = MerlotModel(reference_config({**self.keys, "hidden_dropout_prob": 0.0},
                                             precision=precision), device=self.dev).eval()
        load_into(model, make_weights(self.shapes, self.ctx.seed, self.dev))
        out = {}
        for k, (images, ids) in enumerate(self.batches):
            if fault == "half_batch":
                h = p["stories"] // 2
                half = zero_shot_probs(zero_shot_logits(model, images[:h], ids[:h]), h,
                                       p["frames"])
                out[k] = {n: torch.cat([v, v.mean(0, keepdim=True).expand(
                    p["stories"] - h, *v.shape[1:])]) for n, v in half.items()}
            else:
                out[k] = zero_shot_probs(zero_shot_logits(model, images, ids), p["stories"],
                                         p["frames"])
        del model
        free_cuda()
        return out

    def control_run(self) -> Dict[int, Dict[str, torch.Tensor]]:
        with tf32(False):
            return self.reference_probs("fp8")

    def check(self, outs) -> Dict[str, Dict[str, float]]:
        picked = self.judged(len(outs))
        with tf32(False):
            ref = self.reference_probs()
        got = [outs[i][1] for i in picked]
        want = [ref[outs[i][0]] for i in picked]
        gap = compare.rows_max_gap(got, want) if picked else float("inf")
        return {"prob_gap": {"value": gap, "limit": self.ctx.limits["prob_gap"]}}

    def flops_per_step(self) -> float:
        p = self.ctx.params
        return counts.merlot_forward_flops(
            self.keys, examples=2 * p["stories"], chunks=p["frames"], tokens=p["tokens"],
            image_size=self.keys["image_size"], group=self.keys["num_chunks_in_group"],
            pretrain=False)

    def peak_flops(self) -> float:
        return counts.peak_flops("bf16" if self.keys.get("use_bfloat16", True) else "fp32")
