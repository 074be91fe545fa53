"""AdamW with warmup -> linear decay, regex param overrides and bf16 Adam
state (counterpart of merlot_tpu/train/optimizer.py).

  * linear warmup to the peak LR then linear decay to 0, pre-scaled so the
    peak equals ``learning_rate`` right after warmup;
  * bias correction folded into the LR;
  * decoupled weight decay;
  * regex -> hyperparameter ``param_overrides``, matched against each
    parameter's flax path (``convert.flax_path``: "merlot/encoder/layer00/
    attn_ln/gamma", ".../query/kernel"), so the yaml's patterns ("/ln",
    "/gn", "bias", ...) select what they select in the JAX package;
    ``learning_rate: 0`` freezes a parameter;
  * optional global-norm clipping;
  * bf16 optimizer state with the sign-bit trick for the second moment
    (``encode_v``/``decode_v``): v >= 0, so a negative stored value means
    "multiply by 1.00390625 on decode".

State: {'step': int, 'm': {name: tensor}, 'v': {name: tensor}}. ``update``
writes the new parameters and state in place (the JAX package returns new
trees; in place, the step holds one copy of each).
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Tuple

import torch

from merlot_tpu_torch.convert import flax_path

MISSING_PRECISION = 1.00390625  # 1 + 2^-8
GRADNORM_DEPTH = 2  # ``verbose`` groups grad norms by this many path levels


def encode_v(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 with the sign bit recording a x1.00390625 correction."""
    b = v.to(torch.bfloat16)
    bf = b.float()
    err0 = (bf - v).abs()
    err1 = (bf * MISSING_PRECISION - v).abs()
    return torch.where(err0 <= err1, b, -b)


def decode_v(stored: torch.Tensor) -> torch.Tensor:
    v_abs = stored.abs().float()
    return torch.where(stored.float() > 0, v_abs, v_abs * MISSING_PRECISION)


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    num_train_steps: int = 100000
    num_warmup_steps: int = 0
    weight_decay_rate: float = 1e-4
    beta_1: float = 0.9
    beta_2: float = 0.98
    epsilon: float = 1e-6
    clip_norm: float = 1.0          # <= 0 disables
    use_bfloat16_adam: bool = False
    verbose: bool = False           # per-scope gradnorm telemetry
    # list of [regex_list, {hyperparam: value}]
    param_overrides: Tuple = ()

    @classmethod
    def from_config(cls, optimizer_section: Dict[str, Any]) -> "AdamWConfig":
        if optimizer_section.get("type", "adam_optimizer") != "adam_optimizer":
            raise ValueError(f"unsupported optimizer {optimizer_section.get('type')}")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in optimizer_section.items() if k in names}
        if kw.get("param_overrides") is not None:
            kw["param_overrides"] = tuple(
                (tuple(regexes), dict(over)) for regexes, over in kw["param_overrides"])
        else:
            kw["param_overrides"] = ()
        return cls(**kw)


_OVERRIDABLE = ("learning_rate", "weight_decay_rate", "beta_1", "beta_2", "epsilon")


def _path_key(name: str) -> Tuple[str, ...]:
    """The order the JAX package visits leaves in (sorted dict keys, level
    by level)."""
    return tuple(flax_path(name).split("/"))


class MerlotAdamW:
    """Per-parameter-hyperparameter AdamW over named parameters."""

    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg
        self._plan_names: Tuple[str, ...] = ()
        self._plan: List[Tuple[str, str, Dict[str, float]]] = []

    def _resolve(self, path: str) -> Dict[str, float]:
        """Hyperparameters of the parameter at flax path ``path``."""
        c = self.cfg
        hp = {"learning_rate": c.learning_rate,
              "weight_decay_rate": c.weight_decay_rate,
              "beta_1": c.beta_1, "beta_2": c.beta_2, "epsilon": c.epsilon}
        for regexes, over in c.param_overrides:
            for k in over:
                if k not in _OVERRIDABLE:
                    raise ValueError(f"{k} is not an overridable hyperparameter")
            if any(re.search(rx, path) for rx in regexes):
                hp.update(over)
        return hp

    def _params_plan(self, names: Tuple[str, ...]
                     ) -> List[Tuple[str, str, Dict[str, float]]]:
        """(name, flax path, hyperparameters) of each parameter, in the
        JAX package's leaf order; resolved once for a set of names."""
        if names != self._plan_names:
            self._plan = [(n, flax_path(n), self._resolve(flax_path(n)))
                          for n in sorted(names, key=_path_key)]
            self._plan_names = names
        return self._plan

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        dtype = torch.bfloat16 if self.cfg.use_bfloat16_adam else torch.float32
        return {"step": 0,
                "m": {n: torch.zeros_like(p, dtype=dtype) for n, p in params.items()},
                "v": {n: torch.zeros_like(p, dtype=dtype) for n, p in params.items()}}

    def lr_scale(self, step: int) -> float:
        """Warmup then linear decay; peak = 1.0 right after warmup."""
        c = self.cfg
        t = float(step)
        T = float(c.num_train_steps)
        W = float(c.num_warmup_steps)
        base = T / (T - W + 1.0) if c.num_warmup_steps else 1.0
        decay = base * max(0.0, 1.0 - min(t, T) / T)
        if c.num_warmup_steps and t < W:
            return t / W
        return decay

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """One step: writes the new params and state in place and returns
        the metrics. Frozen params (lr == 0) and their state are left as
        they are."""
        c = self.cfg
        plan = self._params_plan(tuple(params))
        names = [n for n, _, _ in plan]
        step = state["step"]
        scale = self.lr_scale(step)

        # global-norm clip
        global_norm = torch.sqrt(sum(grads[n].float().square().sum() for n in names))
        g_all = {n: grads[n] for n in names}
        if c.clip_norm > 0.0:
            clip = torch.clamp(c.clip_norm / torch.clamp(global_norm, min=1e-12), max=1.0)
            g_all = {n: g * clip.to(g.dtype) for n, g in g_all.items()}

        metrics: Dict[str, Any] = {"learning_rate": c.learning_rate * scale,
                                   "gradnorms/_overall": global_norm}
        if c.verbose:
            # per-scope gradient norms + the decoupled weight-decay "loss"
            # of the parameters before this step
            groups: Dict[str, Any] = {}
            wd_loss = 0.0
            for n, path, hp in plan:
                scope = "/".join(path.split("/")[:GRADNORM_DEPTH])
                groups[scope] = groups.get(scope, 0.0) + g_all[n].float().square().sum()
                wd = hp["weight_decay_rate"]
                wd_loss = wd_loss + wd * 0.5 * params[n].float().square().sum()
            for scope, sq in groups.items():
                metrics[f"gradnorms/{scope}"] = torch.sqrt(sq)
            metrics["weight_decay_loss"] = wd_loss

        t = step + 1.0
        for n, _, hp in plan:
            if hp["learning_rate"] == 0.0:  # frozen
                continue
            p, m0, v0 = params[n], state["m"][n], state["v"][n]
            b1, b2, eps = hp["beta_1"], hp["beta_2"], hp["epsilon"]
            lr = hp["learning_rate"] * scale
            lr = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)  # bias correction

            g32 = g_all[n].float()
            m = m0.float() if c.use_bfloat16_adam else m0
            v = decode_v(v0) if c.use_bfloat16_adam else v0
            m = b1 * m + (1.0 - b1) * g32
            v = b2 * v + (1.0 - b2) * (g32.square() + 1e-30)
            upd = m / (torch.sqrt(v) + eps)
            if hp["weight_decay_rate"] > 0:
                upd = upd + hp["weight_decay_rate"] * p.float()
            p.copy_(p.float() - lr * upd)
            if c.use_bfloat16_adam:
                m0.copy_(m.to(torch.bfloat16))
                v0.copy_(encode_v(v))
            else:
                m0.copy_(m)
                v0.copy_(v)

        state["step"] = step + 1
        return metrics
