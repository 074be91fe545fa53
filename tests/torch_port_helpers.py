"""Helpers shared by the tests that hold merlot_tpu_torch against
merlot_tpu: the JAX package's masking draws re-derived from its key, flax
parameter trees flattened for ``convert.load_flax_params``, and the tiny
flagship pretrain config with a batch and a model pair."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

import __graft_entry__ as graft
from merlot_tpu.models.pretrain import MerlotPretrainModel as JaxPretrain
from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.pretrain import MerlotPretrainModel


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


def tiny_batch(cfg, seed=0):
    """__graft_entry__._make_batch (2 examples x 4 chunks x 8 tokens) with
    tail padding, so that the lang towers see fully masked rows."""
    batch = graft._make_batch(cfg, batch=2, num_chunks=4, text_len=8)
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
