"""The pretraining step (counterpart of merlot_tpu/train/train_step.py):
forward with all three objectives, backward, AdamW update.

``make_train_step`` returns ``step(model, opt_state, batch, generator)``,
which leaves the gradients in each parameter's ``.grad``, updates the
parameters and the optimizer state in place, and returns the metrics
(tensors on the step's device, plus ``learning_rate`` as a float). The
generator draws the masking and the dropout masks; ``masking_draws`` may
give the masking draws instead (``ops.masking.masking_draws``). The step
runs on CUDA unless the caller asks for the CPU, with the training
attention backend of its device (``ops.attention.training_backend``):
the forward and backward kernels on a card, the plain path on the CPU.

``step_generator(seed, step)`` is the counterpart of JAX's
``fold_in(root_key, step)``: the harness draws each step's masking and
dropout from a generator seeded from (seed, step), so a resumed run draws
what an uninterrupted one draws (the draws are torch's, not JAX's).
``make_loss_train_step`` builds the same kind of step from any
``loss_fn(model, batch, generator) -> (loss, metrics)`` (downstream
finetuning swaps it into the Trainer).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.nn.layers import init_params
from merlot_tpu_torch.ops.attention import training_backend
from merlot_tpu_torch.train.optimizer import MerlotAdamW


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the train step was asked for CUDA but no CUDA device "
                           "is present (pass device='cpu' to run on the CPU)")
    return dev


def step_generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step) alone."""
    (mixed,) = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed))


def _apply_update(optimizer: MerlotAdamW, opt_state: Dict[str, Any],
                  params: Dict[str, torch.nn.Parameter], loss: torch.Tensor,
                  metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Backward from ``loss``, the AdamW update in place, the metrics."""
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in params.items()}
    opt_metrics = optimizer.update(grads, opt_state, params)
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    metrics.update(opt_metrics)
    metrics["loss"] = loss.detach()
    return metrics


def init_train_state(model: MerlotPretrainModel, optimizer: MerlotAdamW,
                     seed: int = 0) -> Dict[str, Any]:
    """Initialise the model's parameters from ``seed`` (on the device they
    live on) and return a fresh optimizer state."""
    dev = next(model.parameters()).device
    init_params(model, torch.Generator(device=dev).manual_seed(seed))
    return optimizer.init(dict(model.named_parameters()))


def make_train_step(model: MerlotPretrainModel, optimizer: MerlotAdamW, *,
                    device="cuda") -> Callable:
    """Build ``step(model, opt_state, batch, generator, masking_draws=None)
    -> metrics`` for ``device`` ('cuda' by default; raises without a card)."""
    dev = _device(device)
    backend = training_backend(dev)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"the model is not on {dev}")

    def step(model: MerlotPretrainModel, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             masking_draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, Any]:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss, metrics, _ = model(batch, deterministic=False, attn_backend=backend,
                                 generator=generator, masking_draws=masking_draws)
        return _apply_update(optimizer, opt_state, params, loss, metrics)

    return step


def make_loss_train_step(loss_fn: Callable, optimizer: MerlotAdamW, *,
                         device="cuda") -> Callable:
    """Build ``step(model, opt_state, batch, generator) -> metrics`` from
    ``loss_fn(model, batch, generator) -> (loss, metrics)``, with the batch
    moved to ``device`` ('cuda' by default; raises without a card)."""
    dev = _device(device)

    def step(model: torch.nn.Module, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]
             ) -> Dict[str, Any]:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss, metrics = loss_fn(model, batch, generator)
        return _apply_update(optimizer, opt_state, params, loss, dict(metrics))

    return step
