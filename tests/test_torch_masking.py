"""merlot_tpu_torch masking, sampling and losses vs merlot_tpu on the CPU.

Masking: the JAX function's five draws are re-derived from its key and
handed to the port, which must then pick the same positions and ids
exactly (top-k ties break by the lower index in both). The port's own
draws (from a torch.Generator) are checked by distribution, as
tests/test_masking_distribution.py checks the JAX ones.
Losses: fp32, rtol/atol 1e-6 (log-softmax summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlot_tpu.ops.losses import cross_entropy_with_logits as jax_ce
from merlot_tpu.ops.masking import attention_guided_span_mask as jax_mask
from merlot_tpu_torch.ops.losses import cross_entropy_with_logits
from merlot_tpu_torch.ops.masking import attention_guided_span_mask
from merlot_tpu_torch.ops.sampling import (gumbel_topk_without_replacement,
                                           sample_categorical, top_k_indices)
from torch_port_helpers import jax_masking_draws

VOCAB = 50370


def _ids(seed, b, length, pad=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(100, VOCAB - 13, (b, length)).astype(np.int32)
    ids[:, 0] = rng.integers(2, 100, b)              # special tokens
    if pad:                                          # tail padding (id 0)
        for r in range(b):
            ids[r, rng.integers(length // 4, length + 1):] = 0
    return ids


MASK_CASES = {
    "flagship": dict(length=128),
    "no_attn": dict(length=64, use_attn=False),
    "no_span": dict(length=64, do_spanbert=False),
    "coarse_mass": dict(length=96, coarse=True),     # many ties in the mass
    "mostly_padding": dict(length=64, short=True),   # anchors land on specials
}


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_masking_matches_jax_with_jax_draws(name):
    case = dict(MASK_CASES[name])
    length = case.pop("length")
    coarse, short = case.pop("coarse", False), case.pop("short", False)
    b = 8
    ids = _ids(sorted(MASK_CASES).index(name), b, length)
    if short:
        ids[:, 6:] = 0
    rng = np.random.default_rng(1)
    mass = rng.random((b, length)).astype(np.float32)
    if coarse:
        mass = np.round(mass * 3) / 3
    key = jax.random.PRNGKey(7)
    fn = jax.jit(lambda k, i, m: jax_mask(k, i, m, vocab_size=VOCAB, **case))
    want_ids, want_idx = fn(key, jnp.asarray(ids), jnp.asarray(mass))
    draws = jax_masking_draws(key, b, length, vocab_size=VOCAB)
    got_ids, got_idx = attention_guided_span_mask(
        torch.from_numpy(ids), torch.from_numpy(mass), vocab_size=VOCAB,
        draws=draws, **case)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert got_ids.dtype == torch.int32


def _torch_mask(seed, ids, mass=None, **kw):
    g = torch.Generator().manual_seed(seed)
    ids_t = torch.from_numpy(ids)
    mass_t = torch.ones(ids.shape) if mass is None else torch.from_numpy(mass)
    masked, idx = attention_guided_span_mask(ids_t, mass_t, vocab_size=VOCAB,
                                             generator=g, **kw)
    return masked.numpy(), idx.numpy()


def _runs(idx):
    runs = []
    for row in idx:
        row = np.unique(row)
        breaks = np.where(np.diff(row) > 1)[0]
        runs.extend(np.diff(np.concatenate([[-1], breaks, [len(row) - 1]])))
    return np.mean(runs)


def test_torch_draws_distribution():
    b, length = 64, 128
    rng = np.random.default_rng(0)
    ids = rng.integers(100, VOCAB, (b, length)).astype(np.int32)
    ids[:, ::8] = rng.integers(0, 100, (b, length // 8))
    masked, idx = _torch_mask(0, ids)
    assert idx.shape == (b, int(length * 0.2))
    assert (np.diff(idx, axis=1) > 0).all()                  # sorted, distinct
    sel = np.zeros((b, length), bool)
    np.put_along_axis(sel, idx, True, axis=1)
    assert not (sel & (ids < 100)).any()                      # specials never
    assert (masked[~sel] == ids[~sel]).all()
    new, old = masked[sel], ids[sel]
    frac_mask = (new == 1).mean()
    frac_keep = (new == old).mean()
    assert 0.74 < frac_mask < 0.86
    assert 0.06 < frac_keep < 0.15
    assert 0.05 < 1 - frac_mask - frac_keep < 0.15
    # SpanBERT spans cluster, more than independent anchors do
    assert _runs(idx) > 1.3
    assert _runs(idx) > _runs(_torch_mask(0, ids, do_spanbert=False)[1])


def test_torch_draws_follow_attention():
    """Half of the anchors land in the top-20% attention set
    (choose_topk_prob=0.5), against 20% by chance."""
    b, length = 64, 128
    rng = np.random.default_rng(2)
    ids = rng.integers(100, VOCAB, (b, length)).astype(np.int32)
    mass = rng.random((b, length)).astype(np.float32)
    top = np.argsort(-mass, axis=1)[:, :int(length * 0.2)]
    is_top = np.zeros((b, length), bool)
    np.put_along_axis(is_top, top, True, axis=1)
    _, idx = _torch_mask(3, ids, mass, do_spanbert=False)
    frac = np.take_along_axis(is_top, idx, axis=1).mean()
    assert 0.42 < frac < 0.58


def test_top_k_breaks_ties_by_lower_index():
    v = torch.tensor([[0.0, 1.0, 0.0, 1.0, 0.5, 0.0]])
    assert top_k_indices(v, 5).tolist() == [[1, 3, 4, 0, 2]]
    want = jax.lax.top_k(jnp.asarray(v.numpy()), 5)[1]
    np.testing.assert_array_equal(top_k_indices(v, 5).numpy(), np.asarray(want))


def test_gumbel_topk_and_categorical_distributions():
    g = torch.Generator().manual_seed(0)
    logits = torch.log(torch.tensor([0.5, 0.3, 0.15, 0.05]))
    first = gumbel_topk_without_replacement(logits.expand(20000, 4), 2, generator=g)
    assert (first[:, 0] != first[:, 1]).all()
    freq = torch.bincount(first[:, 0], minlength=4).float() / 20000
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.15, 0.05], atol=0.015)
    draws = sample_categorical(torch.log(torch.tensor([0.625, 0.25, 0.125])),
                               (100, 200), generator=g)
    assert draws.shape == (100, 200)
    freq = torch.bincount(draws.reshape(-1), minlength=3).float() / 20000
    np.testing.assert_allclose(freq.numpy(), [0.625, 0.25, 0.125], atol=0.015)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((6, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (6, 5)).astype(np.int32)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy_with_logits(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
