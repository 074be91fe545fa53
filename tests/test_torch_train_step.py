"""One merlot_tpu_torch train step vs one merlot_tpu train step on the CPU.

The tiny flagship config (fp32, dropout 0) with the yaml's optimizer
(bf16 Adam state, weight decay 0.1 with its overrides, no clipping; no
warmup, so that the first step moves the weights), JAX's
``make_train_step`` with XLA attention against the port's
``make_train_step(device='cpu')`` (the plain path), from the same weights,
batch and masking draws (JAX's, re-derived from its step key).

Tolerances: those of the step checks in ``torch_port_helpers``.
"""

import dataclasses

import pytest
import torch

from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW
from merlot_tpu_torch.train.train_step import init_train_state, make_train_step
from torch_port_helpers import (OPT, check_step_grads, check_step_loss_and_metrics,
                                check_step_params_and_state, step_both, tiny_config)


@pytest.fixture(scope="module")
def stepped():
    return step_both(tiny_config())


def test_step_loss_and_metrics_match_jax(stepped):
    check_step_loss_and_metrics(stepped)


def test_step_grads_match_jax(stepped):
    check_step_grads(stepped)


def test_step_params_and_state_match_jax(stepped):
    check_step_params_and_state(stepped)


def test_step_refuses_cuda_without_a_card(monkeypatch):
    cfg = tiny_config(num_hidden_layers=1, num_vision_transformer_hidden_layers=1,
                      num_lang_transformer_hidden_layers=1)
    tm = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg)))
    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    init_train_state(tm, opt, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(tm, opt)
