"""Helpers shared by the tests that hold merlot_tpu_torch against
merlot_tpu: the JAX package's masking draws re-derived from its key, flax
parameter trees flattened for ``convert.load_flax_params``, the tiny
flagship pretrain config with a batch and a model pair, and one train step
of both packages with its checks.

The step's tolerances: the loss rtol 1e-5; each gradient within 2e-4 of its
tensor's largest |grad| plus 1e-6 of the largest |grad| of all (some
gradients are 0 analytically, e.g. the key biases', and hold only rounding
noise on both sides); the new params within 1e-6 of their tensor's largest
|param| plus 1e-3 of the step size (Adam's first step moves an element by
about lr*sqrt(1-b2)/(1-b1) whatever its gradient, and a gradient near
epsilon passes more than its own error to the update); the bf16 moments
within one bf16 step (2^-7 relative) plus 2e-4 of their tensor's largest
value and 1e-6 of the largest of all (they carry the gradients'
differences)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

import __graft_entry__ as graft
from merlot_tpu.models.pretrain import MerlotPretrainModel as JaxPretrain
from merlot_tpu.train.optimizer import AdamWConfig as JaxConfig
from merlot_tpu.train.optimizer import MerlotAdamW as JaxAdamW
from merlot_tpu.train.optimizer import decode_v as jax_decode_v
from merlot_tpu.train.train_step import make_train_step as jax_make_train_step
from merlot_tpu_torch.convert import flax_path, load_flax_params
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel
from merlot_tpu_torch.train.optimizer import AdamWConfig, MerlotAdamW, decode_v
from merlot_tpu_torch.train.train_step import make_train_step

# the yaml's optimizer (bf16 Adam state, weight decay 0.1 with its
# overrides, no clipping) with no warmup, so that the first step moves the
# weights
OPT = {"type": "adam_optimizer", "learning_rate": 0.0003, "num_train_steps": 460000,
       "num_warmup_steps": 0, "weight_decay_rate": 0.1, "beta_2": 0.98,
       "clip_norm": 0.0, "use_bfloat16_adam": True, "verbose": True,
       "param_overrides": [[["attn_ln", "mlp_ln", "final_ln", "embed_norm",
                             "patches_pre_ln", "viz_final_ln", "/ln", "/gn",
                             "proj_gn", "bias", "gamma", "beta"],
                            {"weight_decay_rate": 0}]]}

# the first step's size per element: lr with the bias correction folded in
STEP = OPT["learning_rate"] * (1 - OPT["beta_2"]) ** 0.5 / (1 - 0.9)


def jax_masking_draws(key, batch, length, *, vocab_size, masking_rate=0.2,
                      spanbert_len_probs=(0.625, 0.25, 0.125)):
    """The five draws ``merlot_tpu.ops.masking.attention_guided_span_mask``
    makes from ``key``, in its order, as torch tensors (the port's
    ``masking_draws`` layout)."""
    m = int(length * masking_rate)
    k_anchor, k_lo, k_hi, k_opt, k_rand = jax.random.split(key, 5)
    len_logp = jnp.log(jnp.asarray(spanbert_len_probs, jnp.float32))
    draws = {
        "gumbel": jax.random.gumbel(k_anchor, (batch, length), dtype=jnp.float32),
        "lo": jax.random.categorical(k_lo, len_logp, shape=(batch, m)),
        "hi": jax.random.categorical(k_hi, len_logp, shape=(batch, m)),
        "option": jax.random.categorical(
            k_opt, jnp.log(jnp.asarray([0.1, 0.8, 0.1], jnp.float32)),
            shape=(batch * length,)),
        "random_ids": jax.random.randint(k_rand, (batch * length,), 100,
                                         vocab_size, dtype=jnp.int32),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def flax_model_masking_key(pretrain_model, variables, key):
    """The key ``MerlotModel`` gets from ``make_rng('masking')`` when the
    pretrain model is applied with ``rngs={'masking': key}``: its first
    draw of that stream in the 'merlot' scope."""
    return jax.jit(lambda v, k: pretrain_model.apply(
        v, method=lambda mdl: mdl.model.make_rng("masking"),
        rngs={"masking": k}))(variables, key)


def flat_params(params):
    """numpy leaves keyed by '/'-joined flax path."""
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def tiny_config(**kw):
    return dataclasses.replace(graft._flagship_config(tiny=True),
                               use_bfloat16=False, hidden_dropout_prob=0.0, **kw)


def tiny_batch(cfg, seed=0, image_seed=None):
    """__graft_entry__._make_batch (2 examples x 4 chunks x 8 tokens) with
    tail padding, so that the lang towers see fully masked rows; with
    ``image_seed``, the frames are drawn from that numpy seed instead."""
    batch = graft._make_batch(cfg, batch=2, num_chunks=4, text_len=8)
    if image_seed is not None:
        shape = batch["images"].shape
        batch["images"] = jnp.asarray(
            np.random.default_rng(image_seed).uniform(0, 1, shape), jnp.float32)
    ids = np.array(batch["input_ids"])
    rng = np.random.default_rng(seed)
    for b in range(ids.shape[0]):
        for n in range(ids.shape[1]):
            ids[b, n, rng.integers(2, 9):] = 0
    batch["input_ids"] = jnp.asarray(ids)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def build_pair(cfg, batch):
    """(flax pretrain model, its variables, the port with the same weights)."""
    jm = JaxPretrain(cfg)
    variables = jax.jit(lambda b: jm.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        b, deterministic=True))(batch)
    tm = MerlotPretrainModel(MerlotConfig(**dataclasses.asdict(cfg)))
    load_flax_params(tm, flat_params(variables["params"]))
    return jm, variables, tm


def pretrain_masking_draws(jm, variables, key, cfg, batch):
    """The masking draws the flax pretrain model makes when applied with
    ``rngs={'masking': key}`` to ``batch``."""
    b, n, length = batch["input_ids"].shape
    group = cfg.num_chunks_in_group
    return jax_masking_draws(flax_model_masking_key(jm, variables, key),
                             b * n // group, length * group,
                             vocab_size=cfg.vocab_size,
                             masking_rate=cfg.masking_rate,
                             spanbert_len_probs=cfg.masking_spanbert_len_probs)


def close_to_scale(got, want, tol, name, atol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale + atol + 1e-12, f"{name}: {err} > {tol} x {scale} + {atol}"


def flax_layout(name, a):
    """A port tensor in the flax layout (kernels transposed back)."""
    if a.ndim == 2 and name.endswith("weight"):
        return a.T
    if a.ndim == 4 and name.endswith("weight"):
        return a.transpose(2, 3, 1, 0)
    return a


def step_both(cfg, image_seed=None, before_step=None):
    """One train step of each package from the same weights, batch
    (``tiny_batch``) and masking draws (JAX's, re-derived from its step
    key): JAX's ``make_train_step`` and the port's
    ``make_train_step(device='cpu')`` with OPT; ``before_step(port model,
    batch)`` runs first. Returns (port model, port optimizer state, port
    metrics, JAX grads, JAX new params, JAX moments, JAX metrics), the JAX
    trees flattened by flax path."""
    batch = tiny_batch(cfg, image_seed=image_seed)
    jm, variables, tm = build_pair(cfg, batch)
    if before_step is not None:
        before_step(tm, batch)
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


def check_step_loss_and_metrics(stepped):
    _, state, metrics, _, _, _, jmetrics = stepped
    assert state["step"] == 1
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    for k in sorted(jmetrics):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def check_step_grads(stepped):
    tm, _, _, jgrads, _, _, _ = stepped
    floor = 1e-6 * max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in tm.named_parameters():
        close_to_scale(flax_layout(name, p.grad.numpy()), jgrads[flax_path(name)],
                       2e-4, name, atol=floor)


def check_step_params_and_state(stepped, grad_noise=0.0):
    """``grad_noise``: a share of each tensor's largest |grad| by which the
    two packages' grads may differ. Adam's first step moves an element whose
    |grad| is far below epsilon by STEP * (1 - b1) / epsilon times its grad,
    so such an element's new value may carry that share of the tensor's
    largest |grad| times this slope."""
    tm, state, _, jgrads, jparams, jstate, _ = stepped
    floor = {k: 1e-6 * max(float(np.abs(np.asarray(a, np.float32)).max())
                           for a in jstate[k].values()) for k in ("m", "v")}
    slope = STEP * (1 - 0.9) / 1e-6
    for name, p in tm.named_parameters():
        path = flax_path(name)
        noise = grad_noise * slope * float(np.abs(jgrads[path]).max())
        close_to_scale(flax_layout(name, p.detach().numpy()), jparams[path], 1e-6, name,
                       atol=1e-3 * STEP + noise)
        m = flax_layout(name, state["m"][name].float().numpy())
        v = flax_layout(name, decode_v(state["v"][name]).numpy())
        jm_ = jstate["m"][path].astype(np.float32)
        jv = np.asarray(jax_decode_v(jstate["v"][path]))
        for key, got, want in (("m", m, jm_), ("v", v, jv)):
            err = np.abs(got - want)
            bound = 2.0 ** -7 * np.abs(want) + 2e-4 * np.abs(want).max() + floor[key]
            assert (err <= bound).all(), f"{key} {name}: {err.max()}"
