"""One merlot_tpu_torch train step vs one merlot_tpu train step on the CPU.

The tiny flagship config (fp32, dropout 0) with the yaml's optimizer
(bf16 Adam state, weight decay 0.1 with its overrides, no clipping; no
warmup, so that the first step moves the weights), JAX's
``make_train_step`` with XLA attention against the port's
``make_train_step(device='cpu')`` (the plain path), from the same weights,
batch and masking draws (JAX's, re-derived from its step key).

Tolerances: the loss rtol 1e-5; each gradient within 2e-4 of its
tensor's largest |grad| plus 1e-6 of the largest |grad| of all (some
gradients are 0 analytically, e.g. the key biases', and hold only
rounding noise on both sides); the new params within 1e-6 of their tensor's
largest |param| plus 1e-3 of the step size (Adam's first step moves an
element by about lr*sqrt(1-b2)/(1-b1) whatever its gradient, and a
gradient near epsilon passes more than its own error to the update); the
bf16 moments within one bf16 step (2^-7 relative) plus 2e-4 of their
tensor's largest value and 1e-6 of the largest of all (they carry the
gradients' differences).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from merlot_tpu.train.optimizer import AdamWConfig as JaxConfig
from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
from merlot_tpu.train.optimizer import decode_v as jax_decode_v
from merlot_tpu.train.train_step import make_train_step as jax_make_train_step
from merlot_tpu_torch.convert import flax_path
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW, decode_v
from merlot_tpu_torch.train.train_step import init_train_state, make_train_step
from torch_port_helpers import (build_pair, flat_params, pretrain_masking_draws,
                                tiny_batch, tiny_config, to_torch)

OPT = {"type": "adam_optimizer", "learning_rate": 0.0003, "num_train_steps": 460000,
       "num_warmup_steps": 0, "weight_decay_rate": 0.1, "beta_2": 0.98,
       "clip_norm": 0.0, "use_bfloat16_adam": True, "verbose": True,
       "param_overrides": [[["attn_ln", "mlp_ln", "final_ln", "embed_norm",
                             "patches_pre_ln", "viz_final_ln", "/ln", "/gn",
                             "proj_gn", "bias", "gamma", "beta"],
                            {"weight_decay_rate": 0}]]}


# the first step's size per element: lr with the bias correction folded in
STEP = OPT["learning_rate"] * (1 - OPT["beta_2"]) ** 0.5 / (1 - 0.9)


def _close_to_scale(got, want, tol, name, atol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale + atol + 1e-12, f"{name}: {err} > {tol} x {scale} + {atol}"


def _layout(name, a):
    """A port tensor in the flax layout (kernels transposed back)."""
    if a.ndim == 2 and name.endswith("weight"):
        return a.T
    if a.ndim == 4 and name.endswith("weight"):
        return a.transpose(2, 3, 1, 0)
    return a


@pytest.fixture(scope="module")
def stepped():
    cfg = tiny_config()
    batch = tiny_batch(cfg)
    jm, variables, tm = build_pair(cfg, batch)
    root = jax.random.PRNGKey(3)
    # the keys JAX's step draws at step 0
    k_mask, _ = jax.random.split(jax.random.fold_in(root, 0))
    draws = pretrain_masking_draws(jm, variables, k_mask, cfg, batch)

    jopt = JaxAdamW(JaxConfig.from_config(OPT))
    params = variables["params"]
    jstate = jopt.init(params)

    def loss_fn(p):
        loss, _, _ = jm.apply({"params": p}, batch, deterministic=False,
                              rngs={"masking": k_mask, "dropout": k_mask})
        return loss

    jgrads = jax.jit(jax.grad(loss_fn))(params)
    jstep = jax_make_train_step(jm, jopt, donate=False)
    new_params, new_state, jmetrics = jstep(params, jstate, batch, root)

    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    state = opt.init(dict(tm.named_parameters()))
    step = make_train_step(tm, opt, device="cpu")
    metrics = step(tm, state, to_torch(batch), None, masking_draws=draws)
    return (tm, state, metrics, flat_params(jgrads), flat_params(new_params),
            {k: flat_params(new_state[k]) for k in ("m", "v")}, jmetrics)


def test_step_loss_and_metrics_match_jax(stepped):
    _, state, metrics, _, _, _, jmetrics = stepped
    assert state["step"] == 1
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    for k in sorted(jmetrics):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def test_step_grads_match_jax(stepped):
    tm, _, _, jgrads, _, _, _ = stepped
    floor = 1e-6 * max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in tm.named_parameters():
        _close_to_scale(_layout(name, p.grad.numpy()), jgrads[flax_path(name)],
                        2e-4, name, atol=floor)


def test_step_params_and_state_match_jax(stepped):
    tm, state, _, _, jparams, jstate, _ = stepped
    floor = {k: 1e-6 * max(float(np.abs(np.asarray(a, np.float32)).max())
                           for a in jstate[k].values()) for k in ("m", "v")}
    for name, p in tm.named_parameters():
        path = flax_path(name)
        _close_to_scale(_layout(name, p.detach().numpy()), jparams[path], 1e-6, name,
                        atol=1e-3 * STEP)
        m = _layout(name, state["m"][name].float().numpy())
        v = _layout(name, decode_v(state["v"][name]).numpy())
        jm_ = jstate["m"][path].astype(np.float32)
        jv = np.asarray(jax_decode_v(jstate["v"][path]))
        for key, got, want in (("m", m, jm_), ("v", v, jv)):
            err = np.abs(got - want)
            bound = 2.0 ** -7 * np.abs(want) + 2e-4 * np.abs(want).max() + floor[key]
            assert (err <= bound).all(), f"{key} {name}: {err.max()}"


def test_step_refuses_cuda_without_a_card(monkeypatch):
    cfg = tiny_config(num_hidden_layers=1, num_vision_transformer_hidden_layers=1,
                      num_lang_transformer_hidden_layers=1)
    tm = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg)))
    opt = MerlotAdamW(AdamWConfig.from_config(OPT))
    init_train_state(tm, opt, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(tm, opt)
