"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a
run (``measure.run_cell``: set-up, a window, the release, the check with
the cell's own limits) at a CPU size, with one fault planted in the
program: a step that leaves its state unchanged, half of the batch left
out (the mean taken over the rest), an answer altered where it is made.
The cells run on one chip, so no exchange between chips can be left out.
The training cells run their configuration in float32 here (at a CPU
size bf16's rounding is not the full size's; the limits are), zero-shot
keeps its bf16 at the published width (768) with 16 stories, four layers
a tower.
"""

import time

import pytest
import torch

from benchmark.harness import registry
from benchmark.harness.measure import run_cell
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(4)
BENCH = registry.benchmark()


SIZES = {"merlot-base.pretrain": dict(fp32=True), "grover-medium.train": {},
         "merlot-base.zeroshot": dict(width=768, layers=4)}


def run(workload):
    cell = tiny_cell(workload, **SIZES[workload])
    if "zeroshot" in workload:
        cell.ctx.params["stories"] = 16
    wl = registry.workload(workload)
    return run_cell(cell, wl, registry.cell_metrics(BENCH, workload), seconds=0.5,
                    trace=False, t_start=time.perf_counter())


@pytest.mark.parametrize("workload", ["merlot-base.pretrain", "grover-medium.train",
                                      "merlot-base.zeroshot"])
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", ["merlot-base.pretrain", "grover-medium.train"])
def test_state_left_unchanged(workload, monkeypatch):
    from merlot_tpu_torch.train import optimizer
    monkeypatch.setattr(optimizer.MerlotAdamW, "update", lambda self, *a, **kw: {})
    res = run(workload)
    assert not res["correct"], res["checks"]


def test_pretrain_half_batch(monkeypatch):
    from merlot_tpu_torch.models import pretrain
    forward = pretrain.MerlotPretrainModel.forward

    def half(self, batch, **kw):
        e = batch["input_ids"].shape[0] // 2
        n = e * batch["input_ids"].shape[1]
        return forward(self, {"images": batch["images"][:n],
                              "input_ids": batch["input_ids"][:e],
                              "shuffled_idx_img": batch["shuffled_idx_img"][:n],
                              "video_src_ids": batch["video_src_ids"][:e]}, **kw)
    monkeypatch.setattr(pretrain.MerlotPretrainModel, "forward", half)
    res = run("merlot-base.pretrain")
    assert not res["correct"], res["checks"]


def test_grover_half_batch(monkeypatch):
    from merlot_tpu_torch.tools import grover_train
    make = grover_train.make_grover_loss

    def half_loss(cfg, bonus):
        fn = make(cfg, bonus)
        return lambda model, batch, g: fn(
            model, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, g)
    monkeypatch.setattr(grover_train, "make_grover_loss", half_loss)
    res = run("grover-medium.train")
    assert not res["correct"], res["checks"]


def _broken_zero_shot(monkeypatch, alter):
    from merlot_tpu_torch.downstream.sort_story import zero_shot
    make = zero_shot.make_zero_shot_fn

    def made(stories, frames, *a, **kw):
        fn = make(stories, frames, *a, **kw)
        half = make(stories // 2, frames, *a, **kw)
        return lambda model, images, sents: alter(fn, half, model, images, sents)
    monkeypatch.setattr(zero_shot, "make_zero_shot_fn", made)


def test_zero_shot_answer_altered(monkeypatch):
    def alter(fn, half, model, images, sents):
        out = fn(model, images, sents)
        out["lang_viz_probs"][0, 0, 1, 0] += 0.05
        return out
    _broken_zero_shot(monkeypatch, alter)
    res = run("merlot-base.zeroshot")
    assert not res["correct"], res["checks"]


def test_zero_shot_half_batch(monkeypatch):
    def alter(fn, half, model, images, sents):
        n = images.shape[0] // 2
        out = half(model, images[:n], sents[:n])
        return {k: torch.cat([v, v.mean(dim=0, keepdim=True).expand_as(v)]) for k, v in out.items()}
    _broken_zero_shot(monkeypatch, alter)
    res = run("merlot-base.zeroshot")
    assert not res["correct"], res["checks"]
