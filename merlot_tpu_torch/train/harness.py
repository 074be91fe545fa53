"""Training harness (counterpart of merlot_tpu/train/harness.py): the
TPUEstimator.train replacement.

Owns the loop around the train step: init-or-restore, warm start, the
host data iteration, metrics copied to the host every ``log_every`` steps
(the outfeed analogue; beside them ``perf/steps_per_sec`` and
``perf/data_wait_s``, the host's seconds waiting on the batches since the
last log, inside a ``data.wait`` span), step-numbered checkpoints
every ``checkpoint_every`` steps (``iterations_per_loop``, like the
reference), an optional ``torch.profiler`` window, and a NaN guard on
logging and on saving (a poisoned state is never checkpointed).

The model's parameters are the training state and the step updates them in
place, so ``init_state``, ``resume_or`` and ``run`` return only the
optimizer state. Each step draws its masking and dropout from
``step_generator(seed, step)``: a run resumed from a checkpoint draws what
an uninterrupted run draws.

Data parallelism (``mesh``, ``parallel.mesh.make_mesh``) and ZeRO-1
(``zero1``, with a mesh), as the JAX Trainer takes them: every rank runs
the loop on its rows of the global batch and logs the global metrics;
rank 0 alone writes metrics and checkpoints, and the other ranks meet it
at a barrier after each save. A checkpoint holds whole moments (ZeRO-1's
slices gathered from the ranks) in the one format, and a restore cuts them
to this rank's slices: a checkpoint written at one world size restores at
another, with or without ZeRO-1. ``evaluate`` gives the means of the global
batches' metrics, as one process on the concatenated batches does.

Tensor parallelism (a mesh with a model axis): ``init_state`` initialises
the whole model from the seed and cuts it (``shard_params``), so a run at
any model size starts from the weights of a one-process run; a checkpoint
holds whole leaves, gathered over the model group (and over the data group
for ZeRO-1's moments), in the same format, and a restore or a warm start
cuts them again: a checkpoint written at any (data, model) restores at any
other. Global rank 0 writes.

Pipeline parallelism (a mesh with a stage axis; the model a
``models.grover.GroverStage`` and the step ``make_pipeline_loss_train_step``):
``init_state`` draws the whole model's weights from the seed and keeps
this stage's; a checkpoint holds JAX's ``--pp`` form, whole
``stages/<leaf>`` arrays [pp, L/pp, ...] of the parameters and moments
gathered onto stage 0 (``Mesh.gather_stages``) and the replicated
leaves once; a restore gives each stage its slice, and a checkpoint of
another ``pp`` is refused by name. ZeRO-1 beside a stage axis is refused
(JAX's pipeline-parallel CLI has no data axis).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from merlot_tpu_torch.core import trace
from merlot_tpu_torch.ops.attention import inference_backend
from merlot_tpu_torch.parallel.mesh import Mesh
from merlot_tpu_torch.train.checkpoint import CheckpointManager, warm_start
from merlot_tpu_torch.train.metrics import MetricsLogger
from merlot_tpu_torch.train.optimizer import MerlotAdamW
from merlot_tpu_torch.train.train_step import (_device, global_metrics, init_train_state,
                                               make_train_step, rank_draws, step_generator)


class Trainer:
    def __init__(self, model, optimizer: MerlotAdamW, output_dir: str,
                 log_every: int = 50, checkpoint_every: int = 1000,
                 profile_dir: Optional[str] = None,
                 profile_steps: Optional[range] = None,
                 seed: int = 0, device="cuda", mesh: Optional[Mesh] = None,
                 zero1: bool = False):
        self.device = _device(device)
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        # ZeRO-1 slices of the optimizer state over the mesh's data ranks
        # (parallel.mesh.zero1_axes); needs a mesh, as in the JAX Trainer
        self.zero1 = zero1 and mesh is not None
        self.opt_mesh = mesh if self.zero1 else None
        # the model axis the parameters are cut over, if any
        self.tp = mesh if mesh is not None and mesh.model > 1 else None
        # the stage axis the layers are split over, if any
        self.pp = mesh if mesh is not None and mesh.stage > 1 else None
        if self.pp is not None and self.zero1:
            raise ValueError("ZeRO-1 beside a stage axis is not ported: JAX's "
                             "pipeline-parallel CLI has no data axis")
        self.is_chief = mesh is None or mesh.is_chief
        self.log_every = log_every
        self.checkpoint_every = checkpoint_every
        self.ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"))
        self.logger = MetricsLogger(output_dir) if self.is_chief else None
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.seed = seed
        # step(model, opt_state, batch, generator) -> metrics; downstream
        # finetuning replaces it with make_loss_train_step(...)
        self.step_fn = make_train_step(model, optimizer, device=self.device, mesh=mesh,
                                       zero1=self.zero1)

    # ------------------------------------------------------------------
    def init_state(self, init_checkpoint: Optional[str] = None) -> Dict[str, Any]:
        """Restore the latest checkpoint, else a fresh init from ``seed``
        (+ a warm start from ``init_checkpoint``, a checkpoint directory or
        a flax-path .npz). Returns the optimizer state."""
        opt_state = init_train_state(self.model, self.optimizer, seed=self.seed,
                                     mesh=self.opt_mesh, tp=self.tp)
        if self.ckpt.latest_step() is not None:
            opt_state = self.resume_or(opt_state)
        elif init_checkpoint:
            print(f"warm starting from {init_checkpoint}")
            warm_start(self.model, init_checkpoint, mesh=self.tp)
        return opt_state

    def resume_or(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """Restore the latest checkpoint into the model and ``opt_state`` if
        one exists, else leave both as they are: the crash/preemption
        recovery hook for callers that build their own init state. Callers
        applying a warm start must skip it when ``self.ckpt.latest_step()``
        is not None (resume wins)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return opt_state
        print(f"restoring checkpoint at step {latest}")
        params = dict(self.model.named_parameters())
        whole = self.optimizer.init(params) if self.zero1 else opt_state
        self.ckpt.restore(latest, self.model, whole, mesh=self.tp or self.pp)
        return self.optimizer.shard_state(whole, params, self.opt_mesh)

    def save(self, step: int, opt_state: Dict[str, Any]) -> None:
        """Checkpoint the model and the whole optimizer state at ``step``:
        every rank gathers, rank 0 writes, all meet after the write."""
        params = dict(self.model.named_parameters())
        whole = self.optimizer.full_state(opt_state, params, self.opt_mesh)
        if self.tp is not None:  # whole leaves from the model ranks' slices
            params = self.tp.gather_model(params)
            whole = {"step": whole["step"],
                     **{g: self.tp.gather_model(whole[g]) for g in ("m", "v")}}
        if self.pp is not None:  # stacked leaves from the stages' layers, on stage 0
            params = self.pp.gather_stages(params)
            whole = {"step": whole["step"],
                     **{g: self.pp.gather_stages(whole[g]) for g in ("m", "v")}}
        if self.is_chief:
            # the persistent buffers (the expert layers' correction biases)
            # beside the parameters: the restore loads the state dict whole
            own = self.model.state_dict()
            params = {**params, **{n: b for n, b in self.model.named_buffers()
                                   if n in own and n not in params}}
            self.ckpt.save(step, params, whole)
        if self.mesh is not None:
            self.mesh.barrier()

    def _log(self, step: int, metrics: Dict[str, float], echo: bool = False) -> None:
        if self.logger is not None:
            self.logger.log(step, metrics, echo=echo)

    # ------------------------------------------------------------------
    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def _guard(self, step: int, metrics: Dict[str, Any], what: str) -> None:
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            self._log(step, {k: float(v) for k, v in metrics.items()})
            raise FloatingPointError(f"non-finite loss {loss} at step {step}{what}")

    def run(self, opt_state: Dict[str, Any], batches: Iterator[Dict[str, Any]],
            num_steps: int) -> Dict[str, Any]:
        start_step = int(opt_state["step"])
        step = start_step
        t_start = time.time()
        # the throughput window starts here: time spent between runs
        # (train -> eval -> resume) never enters perf/steps_per_sec
        tp_step, tp_time = start_step, t_start
        prof = None
        wait_s = 0.0  # the host's seconds in next(batches) since the last log
        batches = iter(batches)
        while step < num_steps:  # no batch is fetched past the last step
            t_wait = time.perf_counter()
            with trace.span("data.wait"):
                batch = next(batches, None)
            wait_s += time.perf_counter() - t_wait
            if batch is None:
                break
            if (self.profile_dir and self.profile_steps and self.is_chief
                    and step == self.profile_steps.start):
                prof = self._profiler()
                prof.start()
            metrics = self.step_fn(self.model, opt_state, batch,
                                   step_generator(self.seed, step, self.device))
            step += 1
            if prof is not None and step == self.profile_steps.stop:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                prof.stop()
                os.makedirs(self.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    self.profile_dir, f"trace_steps_{self.profile_steps.start}"
                                      f"_{self.profile_steps.stop}.json"))
                prof = None

            if step % self.log_every == 0 or step == num_steps:
                host_metrics = {k: float(v) for k, v in metrics.items()}  # the sync
                self._guard(step, host_metrics, "")
                now = time.time()
                if step > tp_step:
                    host_metrics["perf/steps_per_sec"] = (step - tp_step) / (now - tp_time)
                    host_metrics["perf/data_wait_s"] = wait_s
                tp_step, tp_time, wait_s = step, now, 0.0
                self._log(step, host_metrics)

            if step % self.checkpoint_every == 0 or step == num_steps:
                # guard the write even when checkpoint_every < log_every
                self._guard(step, metrics, "; refusing to checkpoint")
                self.save(step, opt_state)
        if prof is not None:
            prof.stop()

        dt = time.time() - t_start
        if step > start_step and self.is_chief:
            print(f"trained {step - start_step} steps in {dt:.1f}s "
                  f"({(step - start_step) / dt:.3f} steps/s)")
        return opt_state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, batches: Iterator[Dict[str, Any]],
                 max_batches: Optional[int] = None,
                 log_step: Optional[int] = None) -> Dict[str, float]:
        """Held-out evaluation: the mean of every scalar metric over the
        batches (the reference EVAL mode's tf.metrics.mean wrapping). A
        deterministic forward; every batch masks from the same generator,
        seeded 0 (JAX's fixed PRNGKey(0)). With a mesh each batch is this
        rank's rows of a global batch, and its metrics the global ones."""
        backend = inference_backend(self.device)
        sums: Dict[str, float] = {}
        n = 0
        for i, batch in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            batch = {k: v.to(self.device) for k, v in batch.items()}
            gen, draws = torch.Generator(device=self.device).manual_seed(0), None
            if self.mesh is not None:
                gen, draws = rank_draws(self.model.cfg, batch["input_ids"], gen, self.mesh)
            loss, metrics, _ = self.model(
                batch, deterministic=True, attn_backend=backend, generator=gen,
                masking_draws=draws, mesh=self.mesh)
            if self.mesh is not None:
                loss, metrics = global_metrics(loss, metrics, self.mesh)
            metrics = dict(metrics)
            metrics["loss"] = loss
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        means = {k: v / max(n, 1) for k, v in sums.items()}
        if log_step is not None and n:
            self._log(log_step, {f"eval/{k}": v for k, v in means.items()}, echo=True)
        return means
