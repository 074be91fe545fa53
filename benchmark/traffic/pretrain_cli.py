"""MERLOT pretraining through the CLI's loop and host loader, on tfrecord
shards of JPEG frames (a closed loop).

The program is ``train/pretrain.py``'s: ``build_pretrain_setup`` (the
model, AdamW and the ``PretrainLoader`` over the shards' glob), its
``Trainer`` and ``device_iterator``, and each step one pass of
``Trainer.run``'s loop: the wait on the loader (``data.wait``), the step
with the trainer's generator, the logging and checkpointing every so many
steps. A unit of the window is one call of ``Trainer.run`` over an
iterator of one batch, with the CLI's ``num_train_steps``: the loop's body
runs once and the loop ends on the iterator's end, so it logs and saves
only at the CLI's own steps. The loader's threads parse the next batches
while the card runs the step, as in the CLI. Parameters:

    cell            the configuration's per-cell block (image size, group)
    examples        examples a step (``train_batch_size``)
    chunks          frame+caption segments an example (``num_chunks``)
    tokens          caption tokens a segment (``chunk_text_len``)
    frame           [height, width] of the shards' JPEGs
    shards          tfrecord files; they hold ``distinct`` x ``examples``
                    examples in all, and the loader reads them again and
                    again
    distinct        batches' worth of examples in the shards
    data            the CLI's ``data`` block (transcripts, scales,
                    augmentation, shuffles, threads)
    check_steps     steps the reference follows

The shards are made in set-up from the seed by the port's
``data/make_synthetic_tfrecord.py`` under the checkout's ``build/``, and
removed after the check. The weights are the seed's, loaded over the
trainer's initialisation. The reference (``traffic/pretrain.py``'s) is fed
the batches ``reference/pretrain_data.py`` reads from the same shards with
PIL, independently of the loader, and draws its masking and dropout from
the trainer's generator of each step. Beside the pretrain cell's checks,
``batch_gap``: the largest gap between the images the program's first
``check_steps`` steps got and the reference's, inf where an id, a video
index or a frame-shuffle index differs. The program's images are bf16:
half an ulp is 2^-9 below 1 and 2^-8 from 1 to 2, where the bicubic
resize overshoots on frames left unaugmented.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import math
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List

import torch

from benchmark.harness import compare, registry
from benchmark.harness.cell import free_cuda, step_seed, tf32
from benchmark.harness.weights import load_into, make_weights, param_shapes

PretrainCell = registry.traffic("pretrain").Cell
model_keys = registry.traffic("pretrain").model_keys
DATA_DIR = registry.ROOT / "build" / "bench_pretrain_cli"
INT_KEYS = ("input_ids", "video_src_ids", "shuffled_idx_img")


def write_shards(out: Path, seed: int, *, shards: int, examples: int, chunks: int,
                 frame) -> List[str]:
    """``shards`` files of ``examples`` examples each, each shard's content
    from (seed, shard) alone."""
    from merlot_tpu_torch.data.make_synthetic_tfrecord import write_synthetic_shard
    out.mkdir(parents=True, exist_ok=True)
    paths = [str(out / f"train-{s:05d}-of-{shards:05d}.tfrecord") for s in range(shards)]
    with ThreadPoolExecutor(min(shards, os.cpu_count() or 1)) as pool:
        list(pool.map(lambda s: write_synthetic_shard(
            paths[s], examples, chunks, seed=step_seed(seed, s, salt=4),
            img_hw=tuple(frame), max_tokens=28), range(shards)))
    return paths


class Cell(PretrainCell):
    def setup(self) -> None:
        from merlot_tpu_torch.core.config import NeatConfig
        from merlot_tpu_torch.data.pretrain_loader import device_iterator
        from merlot_tpu_torch.train.harness import Trainer
        from merlot_tpu_torch.train.pretrain import build_pretrain_setup
        p, c = self.ctx.params, self.ctx.config
        self.check_steps = p.get("check_steps", 3)
        self.keys = model_keys(c, p["cell"])
        self.dir = DATA_DIR / f"{self.ctx.seed}-{os.getpid()}"
        atexit.register(shutil.rmtree, self.dir, True)   # where no check removes them
        self.files = write_shards(self.dir / "shards", self.ctx.seed, shards=p["shards"],
                                  examples=p["distinct"] * p["examples"] // p["shards"],
                                  chunks=p["chunks"], frame=p["frame"])
        self.config = NeatConfig.from_dict({
            "data": {**p["data"], "train_file": str(self.dir / "shards" / "train-*.tfrecord"),
                     "num_chunks": p["chunks"], "chunk_text_len": p["tokens"]},
            "model": self.keys, "optimizer": c["optimizer"],
            "device": {"output_dir": str(self.dir / "out"), "train_batch_size": p["examples"],
                       "iterations_per_loop": p["iterations_per_loop"],
                       "log_every": p["log_every"]}})
        cfg = self.config
        self.model, self.opt, loader = build_pretrain_setup(cfg, self.dev)
        self.beta_1 = self.opt.cfg.beta_1
        self.work_per_step = p["examples"] * p["chunks"]
        self.trainer = Trainer(self.model, self.opt, output_dir=cfg.device["output_dir"],
                               log_every=cfg.device["log_every"],
                               checkpoint_every=cfg.device["iterations_per_loop"],
                               device=self.dev)
        run_step = self.trainer.step_fn

        def step_fn(*a):
            self.last_metrics = run_step(*a)
            return self.last_metrics
        self.trainer.step_fn = step_fn
        self.opt_state = self.trainer.init_state()
        self.shapes = param_shapes(self.model)
        load_into(self.model, make_weights(self.shapes, self.ctx.seed, self.dev))
        self.feed = device_iterator(loader.batches(0), self.dev,
                                    images_bf16=self.keys.get("use_bfloat16", True),
                                    images_u8=cfg.data.get("infeed_u8", False))
        self.i = 0
        self.prog_batches = []
        losses, parts = [], []
        for _ in range(self.check_steps):
            losses.append(self.step()[1])
            parts.append({k: self.last_metrics[k].detach() for k in self.parts})
            if self.i == 1:
                grad = {n: m.float() / (1.0 - self.beta_1)
                        for n, m in self.opt_state["m"].items()}
                self.prog_grad = compare.leaf_norms(grad)
                del grad
        params = dict(self.model.named_parameters())
        w0 = make_weights(self.shapes, self.ctx.seed, self.dev)
        with torch.no_grad():
            self.prog_change = compare.leaf_norms({n: q.float() - w0[n]
                                                   for n, q in params.items()})
        del w0
        self.prog_losses = [float(x) for x in losses]
        self.prog_parts = [{k: float(v) for k, v in q.items()} for q in parts]

    def _batch(self):
        batch = next(self.feed)
        if len(self.prog_batches) < self.check_steps:
            self.prog_batches.append({k: batch[k] for k in ("images",) + INT_KEYS})
        yield batch

    def step(self):
        with contextlib.redirect_stdout(io.StringIO()):   # the loop's "trained 1 steps"
            self.opt_state = self.trainer.run(self.opt_state, self._batch(),
                                              self.config.optimizer["num_train_steps"])
        self.i += 1
        return self.work_per_step, self.last_metrics["loss"].detach()

    def release(self) -> None:
        self.feed.close()
        self.model = self.opt = self.trainer = self.opt_state = self.feed = None
        free_cuda()

    def reference_batches(self) -> List[Dict[str, torch.Tensor]]:
        from benchmark.reference import pretrain_data
        if not hasattr(self, "ref_batches"):
            cfg = self.config.merged_data_model()
            got = pretrain_data.batches(self.files, cfg, self.ctx.params["examples"],
                                        self.check_steps,
                                        shuffle_buffer=cfg.get("shuffle_buffer_size", 256))
            self.ref_batches = [{k: torch.from_numpy(v).to(self.dev) for k, v in b.items()}
                                for b in got]
        return self.ref_batches

    def reference_run(self, precision: str = "fp32", fault=None) -> Dict[str, Any]:
        """``TrainingCell.reference_run`` on the batches read from the shards
        and the trainer's generators."""
        from benchmark.reference.adamw import AdamW
        from merlot_tpu_torch.train.train_step import step_generator
        model = self.build_reference(precision)
        w0 = make_weights(self.shapes, self.ctx.seed, self.dev)
        load_into(model, w0)
        params = dict(model.named_parameters())
        opt = AdamW(self.ctx.config["optimizer"])
        losses, parts, grad = [], [], None
        for i, batch in enumerate(self.reference_batches()):
            if fault == "half_batch":
                batch = self.half_batch(batch)
            loss, part = self.reference_loss(model, batch, step_generator(0, i, self.dev))
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
            change = compare.leaf_norms({n: q - w0[n] for n, q in params.items()})
        del model, params, opt, w0
        free_cuda()
        return {"losses": losses, "parts": parts, "grad": grad, "change": change}

    def batch_gap(self) -> float:
        ref = self.reference_batches()
        if len(self.prog_batches) != len(ref):
            return math.inf
        worst = 0.0
        for got, want in zip(self.prog_batches, ref):
            for k in INT_KEYS:
                if got[k].shape != want[k].shape or not torch.equal(got[k].long(),
                                                                    want[k].long()):
                    return math.inf
            d = (got["images"].float() - want["images"].float()).abs().max()
            worst = max(worst, float(d) if torch.isfinite(d) else math.inf)
        return worst

    def check(self, outs) -> Dict[str, Dict[str, float]]:
        try:
            with tf32(False):
                ref = self.reference_run()
            checks = compare.training_checks(self.program_readings(), ref, self.ctx.limits)
            checks["batch_gap"] = {"value": self.batch_gap(),
                                   "limit": self.ctx.limits["batch_gap"]}
            return checks
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)

    def half_batch(self, batch):
        e = batch["input_ids"].shape[0] // 2
        n_img = e * batch["input_ids"].shape[1]
        return {"images": batch["images"][:n_img], "input_ids": batch["input_ids"][:e],
                "shuffled_idx_img": batch["shuffled_idx_img"][:n_img],
                "video_src_ids": batch["video_src_ids"][:e]}

