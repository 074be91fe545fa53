"""The life of one cell's run, shared by the traffic kinds.

A ``Cell`` builds the program and its inputs in ``setup`` (counted as
set-up: the weights from the seed, the batches, every shape of the window
run once), runs one unit of the window in ``step``, gives up the program's
state in ``release`` and then judges what the timed path produced against
the plain reference in ``check``.

``TrainingCell`` is the training steps' form: set-up builds one step
object with its model and optimizer state and drives it from the seed
through its first ``check_steps`` steps, each on a batch of its own,
through the window's own call; the window goes on with the same object.
From those steps it keeps each loss, the first gradient as the optimizer
got it (worked out from the first moment after one step) and the
parameters' change after them; the reference follows the same steps.
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.weights import load_into, make_weights, param_shapes


@dataclass
class Context:
    config: Dict[str, Any]          # configs/<config>.json
    params: Dict[str, Any]          # the workload's traffic parameters
    limits: Dict[str, float]        # the workload's check limits
    seed: int
    device: torch.device


def step_seed(seed: int, step: int, salt: int = 0) -> int:
    """A 63-bit seed of (seed, step, salt) alone."""
    (mixed,) = np.random.SeedSequence([seed, step, salt]).generate_state(1, np.uint64)
    return int(mixed) >> 1


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Cell:
    causal_attention = False

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.dev = ctx.device

    # the program -------------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def step(self) -> Tuple[int, Any]:
        """One unit of the window: (work done, an output kept for the
        checks, or None)."""
        raise NotImplementedError

    def failed(self, outs: List[Any]) -> int:
        """How many of the window's outputs are not finite."""
        bad = 0
        for o in outs:
            if o is None:
                continue
            vals = o.values() if isinstance(o, dict) else [o]
            if not all(bool(torch.isfinite(v).all()) for v in vals):
                bad += 1
        return bad

    def optimizer(self) -> Optional[Any]:
        """The object whose ``update`` the optimizer's span wraps."""
        return None

    def flops_per_step(self) -> float:
        raise NotImplementedError

    def peak_flops(self) -> float:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def check(self, outs: List[Any]) -> Dict[str, Dict[str, float]]:
        raise NotImplementedError


@contextlib.contextmanager
def tf32(enabled: bool):
    """float32 products and convolutions in TF32 or not, inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class TrainingCell(Cell):
    """Subclasses give ``build_program() -> (model, optimizer, step_fn)``,
    ``make_batches() -> [batch]``, ``work_per_step``, ``beta_1`` and the
    reference's ``build_reference(precision) -> model`` and
    ``reference_loss(model, batch, generator) -> (loss, {part: value})``;
    ``control`` names the precision below the configuration's ('fp8' or
    'tf32'); ``parts`` names the loss parts the checks read (the
    reference's part and the program step's metric of that name)."""
    control = "fp8"
    parts: Tuple[str, ...] = ()

    def setup(self) -> None:
        p = self.ctx.params
        self.check_steps = p.get("check_steps", 3)
        self.model, self.opt, self.step_fn = self.build_program()
        self.shapes = param_shapes(self.model)
        load_into(self.model, make_weights(self.shapes, self.ctx.seed, self.dev))
        params = dict(self.model.named_parameters())
        self.opt_state = self.opt.init(params)
        self.batches = self.make_batches()
        self.i = 0
        losses, parts = [], []
        for _ in range(self.check_steps):
            losses.append(self.step()[1])
            parts.append({k: self.last_metrics[k].detach() for k in self.parts})
            if self.i == 1:
                grad = {n: m.float() / (1.0 - self.beta_1)
                        for n, m in self.opt_state["m"].items()}
                self.prog_grad = compare.leaf_norms(grad)
                del grad
        w0 = make_weights(self.shapes, self.ctx.seed, self.dev)
        with torch.no_grad():
            self.prog_change = compare.leaf_norms({n: p.float() - w0[n]
                                                   for n, p in params.items()})
        del w0
        self.prog_losses = [float(x) for x in losses]
        self.prog_parts = [{k: float(v) for k, v in p.items()} for p in parts]

    def step(self) -> Tuple[int, Any]:
        batch = self.batches[self.i % len(self.batches)]
        g = generator(self.dev, step_seed(self.ctx.seed, self.i))
        metrics = self.step_fn(self.model, self.opt_state, batch, g)
        self.i += 1
        self.last_metrics = metrics
        return self.work_per_step, metrics["loss"].detach()

    def optimizer(self):
        return self.opt

    def release(self) -> None:
        self.model = self.opt = self.step_fn = self.opt_state = None
        free_cuda()

    def reference_run(self, precision: str = "fp32", fault: Optional[str] = None
                      ) -> Dict[str, Any]:
        """The reference's first ``check_steps`` steps from the same weights,
        batches and dropout seeds: its losses, the first gradient as its
        optimizer got it, and the parameters' change. ``precision``: what
        the sites the configuration computes in bf16 are rounded to
        ('fp32': none; 'bf16'; 'fp8', the control of a bf16
        configuration); ``fault``: 'half_batch' takes the loss over the
        first half of each batch."""
        from benchmark.reference.adamw import AdamW
        model = self.build_reference(precision)
        w0 = make_weights(self.shapes, self.ctx.seed, self.dev)
        load_into(model, w0)
        params = dict(model.named_parameters())
        opt = AdamW(self.ctx.config["optimizer"])
        losses, parts, grad = [], [], None
        for i in range(self.check_steps):
            batch = self.batches[i % len(self.batches)]
            if fault == "half_batch":
                batch = self.half_batch(batch)
            g = generator(self.dev, step_seed(self.ctx.seed, i))
            loss, part = self.reference_loss(model, batch, g)
            parts.append({k: float(v.detach()) for k, v in part.items()})
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                         allow_unused=True)))
            grads = {n: torch.zeros_like(params[n]) if v is None else v
                     for n, v in grads.items()}
            used = opt.update(params, grads)
            if i == 0:
                grad = compare.leaf_norms(used)
            losses.append(float(loss.detach()))
            del grads, used, loss
        with torch.no_grad():
            change = compare.leaf_norms({n: p - w0[n] for n, p in params.items()})
        del model, params, opt, w0
        free_cuda()
        return {"losses": losses, "parts": parts, "grad": grad, "change": change}

    def control_run(self) -> Dict[str, Any]:
        """The reference in the precision below the configuration's: float8
        (e4m3 values, e5m2 gradients) where a bf16 configuration computes in
        bf16, TF32 for a float32 one."""
        if self.control == "tf32":
            with tf32(True):
                return self.reference_run()
        with tf32(False):
            return self.reference_run("fp8")

    def program_readings(self) -> Dict[str, Any]:
        return {"losses": self.prog_losses, "parts": self.prog_parts, "grad": self.prog_grad,
                "change": self.prog_change}

    def check(self, outs: List[Any]) -> Dict[str, Dict[str, float]]:
        with tf32(False):
            ref = self.reference_run()
        return compare.training_checks(self.program_readings(), ref, self.ctx.limits)
