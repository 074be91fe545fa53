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

Data parallelism (``mesh``, counterpart of the JAX step's mesh): the batch
is this rank's rows of the global batch (the ranks' batches in rank
order), the loss and the model's metrics are this rank's shares of the
global ones (``models/pretrain.py``), and the step sums the gradients and
the shares over the ranks (one all-reduce per flat bucket) before the
update, so every rank updates with the global gradients and logs the
global metrics. At world size > 1 the masking draws are made from the
step's generator for the whole global batch and cut to this rank's rows,
and the dropout masks come from a generator of this rank's own, seeded
from the step's; so with dropout off a world-N step is a one-process step
on the concatenated batch. At world size 1 the step draws as without a
mesh. ``zero1=True`` keeps the optimizer state in ZeRO-1's slices
(``MerlotAdamW.init(params, mesh)``).

Tensor parallelism (a mesh with a model axis; the model cut by
``parallel.mesh.shard_params``, as ``init_train_state`` does after the
seeded init of the whole model): "rank" above means the data index, so the
model ranks of one data index take the same rows, the same masking draws
and the same dropout generator. The gradients and metrics are summed over
the data group only: a cut leaf's gradient is this model rank's slice, and
a replicated one's is the same on every model rank by construction (the
model axis's collectives sit inside the forward and backward). The
update's clip and norms count the cut leaves over the model group.

Pipeline parallelism (a mesh with a stage axis; ``make_pipeline_loss_train_step``):
``loss_fn`` runs the GPipe forward (``parallel/pipeline.py``) and returns
the loss on the last stage only. The step backwards from it there, then
runs the reverse schedule on every stage, which leaves each stage's layer
gradients in place and stage 0's embedding gradients. The replicated
leaves (the tied ``word_embed``, whose gradient comes from stage 0's
lookup and the last stage's head, ``pos_embed`` and ``embed_norm``) are
summed over the stage group, so every stage holds the same gradient and
makes the same update of its copy; with a data axis every gradient is then
summed over the data group. The last stage's loss and metrics go to every
stage. The update's clip counts each stage's layers once over the stage
group and the replicated leaves once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from merlot_tpu_torch.convert import stage_leaf
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.nn.layers import init_params
from merlot_tpu_torch.ops.attention import training_backend
from merlot_tpu_torch.ops.masking import masking_draws as draw_masking
from merlot_tpu_torch.parallel.mesh import Mesh, shard_params
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


def rank_generator(generator: Optional[torch.Generator], mesh: Mesh
                   ) -> Optional[torch.Generator]:
    """A generator of this rank's own, seeded by the rank's draw from
    ``generator`` (each rank draws the same ``mesh.data`` seeds)."""
    if generator is None:
        return None
    seeds = torch.randint(0, 2 ** 62, (mesh.data,), generator=generator,
                          device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(int(seeds[mesh.rank]))


def rank_draws(cfg, input_ids: torch.Tensor, generator: Optional[torch.Generator],
               mesh: Mesh) -> Tuple[Optional[torch.Generator],
                                    Optional[Dict[str, torch.Tensor]]]:
    """(dropout generator, masking draws) of this rank's rows at world size
    > 1: the masking draws of the global batch from ``generator``, cut to
    this rank's rows, then ``rank_generator``. At world size 1: (generator,
    None), so the model draws as without a mesh."""
    if mesh.data == 1:
        return generator, None
    b, chunks, chunk_len = input_ids.shape
    group = cfg.num_chunks_in_group or chunks
    rows, length = b * (chunks // group), chunk_len * group
    draws = draw_masking(rows * mesh.data, length, vocab_size=cfg.vocab_size,
                         masking_rate=cfg.masking_rate,
                         spanbert_len_probs=cfg.masking_spanbert_len_probs,
                         generator=generator, device=input_ids.device)
    lo = mesh.rank * rows
    mine = {}
    for k, v in draws.items():
        per_row = v.numel() // (rows * mesh.data)  # option and random_ids are flat
        mine[k] = v[lo * per_row:(lo + rows) * per_row] if v.dim() == 1 else v[lo:lo + rows]
    return rank_generator(generator, mesh), mine


def global_metrics(loss: torch.Tensor, metrics: Dict[str, Any], mesh: Mesh
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The loss and the tensor metrics summed over the ranks (one
    all-reduce): this rank's shares -> the global values."""
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    vals = [metrics[k] for k in keys] + [loss]
    summed = mesh.all_reduce_sum(torch.stack([v.detach().float() for v in vals]))
    out = dict(metrics)
    for k, v, t in zip(keys, vals, summed):
        out[k] = t.to(v.dtype)
    return summed[-1].to(loss.dtype), out


def _apply_update(optimizer: MerlotAdamW, opt_state: Dict[str, Any],
                  params: Dict[str, torch.nn.Parameter], loss: torch.Tensor,
                  metrics: Dict[str, Any], mesh: Optional[Mesh] = None,
                  zero1: bool = False) -> Dict[str, Any]:
    """Backward from ``loss``, the gradients summed over ``mesh``'s ranks,
    the AdamW update in place (ZeRO-1's with ``zero1``), the metrics."""
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in params.items()}
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    loss = loss.detach()
    if mesh is not None:
        mesh.all_reduce_(list(grads.values()))
        loss, metrics = global_metrics(loss, metrics, mesh)
    opt_metrics = optimizer.update(grads, opt_state, params,
                                   mesh=mesh if zero1 else None,
                                   tp=mesh if mesh is not None and mesh.model > 1 else None)
    metrics.update(opt_metrics)
    metrics["loss"] = loss
    return metrics


def init_train_state(model: MerlotPretrainModel, optimizer: MerlotAdamW,
                     seed: int = 0, mesh: Optional[Mesh] = None,
                     tp: Optional[Mesh] = None) -> Dict[str, Any]:
    """Initialise the model's whole parameters from ``seed`` (on the device
    they live on; the same on every rank), cut them over ``tp``'s model
    axis (``shard_params``: a one-process run's weights, sliced), and
    return a fresh optimizer state (ZeRO-1's slices with ``mesh``)."""
    dev = next(model.parameters()).device
    init_params(model, torch.Generator(device=dev).manual_seed(seed))
    shard_params(model, tp)
    return optimizer.init(dict(model.named_parameters()), mesh)


def _check_zero1(mesh: Optional[Mesh], zero1: bool) -> None:
    if zero1 and mesh is None:
        raise ValueError("zero1 sharding needs a mesh")


def make_train_step(model: MerlotPretrainModel, optimizer: MerlotAdamW, *,
                    device="cuda", mesh: Optional[Mesh] = None,
                    zero1: bool = False) -> Callable:
    """Build ``step(model, opt_state, batch, generator, masking_draws=None)
    -> metrics`` for ``device`` ('cuda' by default; raises without a card).
    With ``mesh``, ``masking_draws`` (when given) are this rank's rows."""
    _check_zero1(mesh, zero1)
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
        if mesh is not None and masking_draws is None:
            generator, masking_draws = rank_draws(model.cfg, batch["input_ids"],
                                                  generator, mesh)
        loss, metrics, _ = model(batch, deterministic=False, attn_backend=backend,
                                 generator=generator, masking_draws=masking_draws,
                                 mesh=mesh)
        return _apply_update(optimizer, opt_state, params, loss, metrics, mesh, zero1)

    return step


def make_loss_train_step(loss_fn: Callable, optimizer: MerlotAdamW, *,
                         device="cuda", mesh: Optional[Mesh] = None,
                         zero1: bool = False) -> Callable:
    """Build ``step(model, opt_state, batch, generator) -> metrics`` from
    ``loss_fn(model, batch, generator) -> (loss, metrics)``, with the batch
    moved to ``device`` ('cuda' by default; raises without a card). With
    ``mesh``, ``loss_fn`` returns this rank's shares of the global loss and
    metrics, and at world size > 1 it is given ``rank_generator``'s."""
    _check_zero1(mesh, zero1)
    dev = _device(device)

    def step(model: torch.nn.Module, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]
             ) -> Dict[str, Any]:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        batch = {k: v.to(dev) for k, v in batch.items()}
        if mesh is not None and mesh.data > 1:
            generator = rank_generator(generator, mesh)
        loss, metrics = loss_fn(model, batch, generator)
        return _apply_update(optimizer, opt_state, params, loss, dict(metrics), mesh, zero1)

    return step


def _last_stage_metrics(loss: Optional[torch.Tensor], metrics: Optional[Dict[str, Any]],
                        mesh: Mesh, device) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The last stage's loss and tensor metrics on every stage of its data
    index (the keys by one object broadcast, the values by one sum over
    the stage group, zeros elsewhere)."""
    keys = mesh.from_last_stage(
        sorted(k for k, v in metrics.items() if torch.is_tensor(v)) if mesh.is_last_stage
        else None)
    if mesh.is_last_stage:
        vals = torch.stack([metrics[k].detach().float() for k in keys] + [loss.detach().float()])
    else:
        vals = torch.zeros((len(keys) + 1,), device=device)
    vals = mesh.stage_all_reduce_sum(vals)
    return vals[-1], {k: vals[i] for i, k in enumerate(keys)}


def make_pipeline_loss_train_step(loss_fn: Callable, optimizer: MerlotAdamW, *, mesh: Mesh,
                                  device="cuda") -> Callable:
    """Build ``step(stage_model, opt_state, batch, generator) -> metrics`` for
    a mesh with a stage axis (module docstring) from ``loss_fn(stage_model,
    batch, generator) -> (loss, metrics, pipeline)``, loss and metrics None
    on all but the last stage. Every stage returns the global metrics."""
    dev = _device(device)

    def step(model: torch.nn.Module, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]
             ) -> Dict[str, Any]:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        batch = {k: v.to(dev) for k, v in batch.items()}
        if mesh.data > 1:
            generator = rank_generator(generator, mesh)
        loss, metrics, pipe = loss_fn(model, batch, generator)
        if loss is not None:
            loss.backward()
        pipe.backward()
        for p in params.values():  # a leaf no stage's graph reached (the last
            if p.grad is None:      # stage's pos_embed) sums as zeros
                p.grad = torch.zeros_like(p)
        grads = {n: p.grad for n, p in params.items()}
        mesh.stage_all_reduce_([g for n, g in grads.items() if stage_leaf(n) is None])
        loss, metrics = _last_stage_metrics(loss, metrics, mesh, dev)
        if mesh.data > 1:
            mesh.all_reduce_(list(grads.values()))
            loss, metrics = global_metrics(loss, metrics, mesh)
        metrics.update(optimizer.update(grads, opt_state, params, pp=mesh))
        metrics["loss"] = loss
        return metrics

    return step
