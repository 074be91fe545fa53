"""Plain AdamW of the configurations' optimizer blocks, in float32.

Per parameter (flax path: the torch name with '.' as '/' and a trailing
``weight`` as ``kernel``, so the blocks' regexes select what they select
in the JAX package): linear warmup then linear decay, bias correction
folded into the learning rate, decoupled weight decay, optional
global-norm clipping. The moments stay float32 whatever the block says
about bf16 state: that storage is the program's rounding, not the method.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict

import torch


def flax_path(name: str) -> str:
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


class AdamW:
    def __init__(self, block: Dict[str, Any]):
        self.lr = block.get("learning_rate", 3e-4)
        self.steps = block.get("num_train_steps", 100000)
        self.warmup = block.get("num_warmup_steps", 0)
        self.wd = block.get("weight_decay_rate", 1e-4)
        self.b1 = block.get("beta_1", 0.9)
        self.b2 = block.get("beta_2", 0.98)
        self.eps = block.get("epsilon", 1e-6)
        self.clip = block.get("clip_norm", 1.0)
        self.overrides = [(tuple(rx), dict(o)) for rx, o in block.get("param_overrides") or ()]
        self.step = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def hyper(self, name: str) -> Dict[str, float]:
        hp = {"learning_rate": self.lr, "weight_decay_rate": self.wd, "beta_1": self.b1,
              "beta_2": self.b2, "epsilon": self.eps}
        path = flax_path(name)
        for regexes, over in self.overrides:
            if any(re.search(rx, path) for rx in regexes):
                hp.update(over)
        return hp

    def lr_scale(self, t: float) -> float:
        T, W = float(self.steps), float(self.warmup)
        if self.warmup and t < W:
            return t / W
        base = T / (T - W + 1.0) if self.warmup else 1.0
        return base * max(0.0, 1.0 - min(t, T) / T)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """One step in place; returns the gradients as the update used
        them (after the clip)."""
        if self.clip > 0:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
            clip = torch.clamp(self.clip / torch.clamp(norm, min=1e-12), max=1.0)
            grads = {n: g * clip for n, g in grads.items()}
        scale = self.lr_scale(float(self.step))
        t = self.step + 1.0
        for n, p in params.items():
            hp = self.hyper(n)
            if hp["learning_rate"] == 0.0:
                continue
            b1, b2 = hp["beta_1"], hp["beta_2"]
            lr = hp["learning_rate"] * scale * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            g = grads[n].float()
            m = b1 * self.m.get(n, torch.zeros_like(g)) + (1.0 - b1) * g
            v = b2 * self.v.get(n, torch.zeros_like(g)) + (1.0 - b2) * (g.square() + 1e-30)
            upd = m / (torch.sqrt(v) + hp["epsilon"])
            if hp["weight_decay_rate"] > 0:
                upd = upd + hp["weight_decay_rate"] * p.float()
            p.copy_(p.float() - lr * upd)
            self.m[n], self.v[n] = m, v
        self.step += 1
        return grads
