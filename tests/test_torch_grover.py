"""The port's Grover (merlot_tpu_torch.models.grover) against the JAX
package's on the CPU, with the same weights (moved by
``convert.load_flax_params``) and numpy-made inputs.

Tolerances:
  * fp32 logits 1e-4 abs/rel: the same formulas, sums in another order;
  * bf16 logits 5e-2 abs/rel, at logits of |x| ~ 1 on the tiny model: each
    bf16 matmul and LN output may round one ulp (2^-8 relative) the other
    way when the fp32 sums before it differ in their last bits, and those
    flips pass through two layers;
  * ``flash_attention_stacked_plain`` vs the Pallas kernel in interpret
    mode: fp32 1e-5, bf16 ctx 2e-2 (one bf16 prob flip moves ctx ~1e-2);
  * the sampler with p tiny (argmax sampling): tokens identical, context
    and token probs 1e-5 abs (fp32);
  * distribution tests: the TV bound of tests/test_grover.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlot_tpu.models import grover as jg
from merlot_tpu.ops.pallas_attention import \
    flash_attention_stacked as jax_flash_stacked
from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.models import grover as tg
from merlot_tpu_torch.ops import cuda_attention
from torch_port_helpers import flat_params

TINY = dict(vocab_size=503, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
LOGIT_TOL = {False: 1e-4, True: 5e-2}


@pytest.fixture(scope="module")
def base():
    """JAX variables of the unfused fp32 tiny model, and the ids."""
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 500, (2, 9)).astype(np.int32)
    model = jg.GroverLM(jg.GroverConfig(**TINY))
    variables = jax.jit(lambda i: model.init(jax.random.PRNGKey(0), i))(jnp.asarray(ids))
    return variables, ids


def _pair(variables, *, bf16=False, fused=False, stacked=False, cast=False):
    """(JAX model, its variables, port model) with the same weights."""
    kw = dict(TINY, use_bfloat16=bf16, fused_qkv=fused, stacked_kv=stacked)
    jm = jg.GroverLM(jg.GroverConfig(**kw))
    tm = tg.GroverLM(tg.GroverConfig(**kw)).eval()
    flat = flat_params(variables["params"])
    if fused:
        variables = jg.fuse_qkv_for_serving(variables)
        flat = tg.fuse_qkv_for_serving(flat)
    load_flax_params(tm, flat)
    if cast:
        variables = jg.cast_params_for_serving(variables)
        tg.cast_params_for_serving(tm)
    return jm, variables, tm


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_full_forward_logits_match_jax(base, bf16):
    variables, ids = base
    jm, jv, tm = _pair(variables, bf16=bf16)
    j_logits, _ = jax.jit(lambda v, i: jm.apply(v, i))(jv, jnp.asarray(ids))
    with torch.no_grad():
        t_logits, cache = tm(torch.from_numpy(ids).long())
    assert cache is None and t_logits.dtype == torch.float32
    _close(t_logits, j_logits, LOGIT_TOL[bf16])


def test_fuse_qkv_tree_matches_jax(base):
    variables, _ = base
    want = flat_params(jg.fuse_qkv_for_serving(variables)["params"])
    got = tg.fuse_qkv_for_serving(flat_params(variables["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tg.fuse_qkv_for_serving(got).keys() == got.keys()   # no-op when fused


@pytest.mark.parametrize("layout", ["flat", "stacked", "fused_stacked"])
@pytest.mark.parametrize("serving_bf16", [False, True])
def test_cached_prefill_and_decode_match_jax(base, layout, serving_bf16):
    """Prefill of 6 tokens, then 3 single-token steps, through each cache
    layout; with ``serving_bf16`` the weights go through
    ``cast_params_for_serving`` and the model (activations, cache) is bf16."""
    variables, ids = base
    jm, jv, tm = _pair(variables, bf16=serving_bf16, cast=serving_bf16,
                       fused=layout == "fused_stacked", stacked=layout != "flat")
    jcache = jm.empty_cache(2, 16)
    tcache = tm.empty_cache(2, 16)
    assert sorted(tcache) == sorted(jcache)
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert tcache[k].dtype == (torch.bfloat16 if serving_bf16 else torch.float32)
    step = jax.jit(lambda v, i, c, o: jm.apply(v, i, cache=c, position_offset=o),
                   static_argnums=3)
    tol = LOGIT_TOL[serving_bf16]
    with torch.no_grad():
        for start, end in [(0, 6), (6, 7), (7, 8), (8, 9)]:
            j_out, jcache = step(jv, jnp.asarray(ids[:, start:end]), jcache, start)
            t_out, tcache = tm(torch.from_numpy(ids[:, start:end]).long(),
                               cache=tcache, position_offset=start)
            _close(t_out, j_out, tol)
    # the caches hold the same keys and values
    for k in jcache:
        _close(tcache[k], jcache[k], 1e-4 if not serving_bf16 else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 6])
def test_stacked_plain_matches_pallas_interpret(dtype, sq):
    """K3's plain version against the TPU kernel in interpret mode, causal
    masks over cache positions, zero cache rows past the position."""
    b, sk, h, d = 2, 16, 2, 32
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kv = rng.standard_normal((b, sk, 2 * h * d)).astype(np.float32)
    pos0 = 9 - sq                                   # first query's position
    kv[:, pos0 + sq:] = 0.0
    mask = (np.arange(sk)[None] <= pos0 + np.arange(sq)[:, None]).astype(np.float32)
    mask_b = np.broadcast_to(mask, (b, sq, sk)).copy()
    with pltpu.force_tpu_interpret_mode():
        j_ctx = jax_flash_stacked(jnp.asarray(q, dtype), jnp.asarray(kv, dtype),
                                  jnp.asarray(mask_b), softmax_fp32=True)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = 1e-5 if dtype == "float32" else 2e-2
    cuda_attention.stacked_launches = 0
    for m in (mask_b, mask[None]):                  # per-row and shared masks
        t_ctx = cuda_attention.flash_attention_stacked(
            torch.from_numpy(q).to(tdt), torch.from_numpy(kv).to(tdt),
            torch.from_numpy(np.ascontiguousarray(m)), softmax_fp32=True)
        assert t_ctx.dtype == tdt and tuple(t_ctx.shape) == (b, sq, h, d)
        _close(t_ctx, j_ctx, tol)
    assert cuda_attention.stacked_launches == 0   # CPU tensors never reach K3


# ----------------------------------------------------------------------
# sampling
# ----------------------------------------------------------------------
def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_top_p_and_top_k_kept_sets():
    """tests/test_grover.py::test_top_p_semantics on the port."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]] * 2000))
    assert set(tg.top_p_sample(_gen(0), logits, p=0.6).tolist()) == {0}
    assert set(tg.top_p_sample(_gen(1), logits, p=0.81).tolist()) == {0, 1}
    ign = torch.tensor([1, 0, 0, 0], dtype=torch.bool)
    assert 0 not in set(tg.top_p_sample(_gen(2), logits, p=0.999, ignore_ids=ign).tolist())
    assert set(tg.top_k_sample(_gen(3), logits, k=2).tolist()) == {0, 1}
    # the prefilter's fast path, and its fallback when the nucleus fills k
    assert set(tg.top_p_sample(_gen(4), logits, p=0.6, k_prefilter=2).tolist()) == {0}
    assert set(tg.top_p_sample(_gen(5), logits, p=0.81, k_prefilter=2).tolist()) == {0, 1}
    assert set(tg._top_p_full_sort(_gen(6), logits, p=0.81).tolist()) == {0, 1}


def test_top_p_prefilter_kept_set_on_wide_logits():
    rng = np.random.default_rng(0)
    wide = rng.normal(0, 2, (4, 300)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(wide), -1))
    for seed in range(20):
        toks = tg.top_p_sample(_gen(seed), torch.from_numpy(wide), p=0.9,
                               k_prefilter=128).tolist()
        for row, tok in enumerate(toks):
            order = np.argsort(-probs[row])
            csum = np.cumsum(probs[row][order])
            assert tok in set(order[csum < 0.9]) | {order[0]}


def test_top_p_per_row_mixed_entropy():
    """tests/test_grover.py::test_top_p_per_row_mixed_entropy on the port:
    rows served by the k, 8k and full-sort stages each stay in their
    reference kept set and follow its renormalized distribution."""
    V, k1, p = 256, 8, 0.9
    probs = np.full((3, V), 1e-9)
    probs[0, :6] = 0.5 ** np.arange(1, 7)
    probs[1, :32] = 1.0 / 32
    probs[2, :] = 1.0 / V
    probs /= probs.sum(-1, keepdims=True)
    kept_sets, ref_dists = [], []
    for row in range(3):
        order = np.argsort(-probs[row], kind="stable")
        keep = np.cumsum(probs[row][order]) < p
        keep[0] = True
        kept = order[keep]
        kept_sets.append(set(int(t) for t in kept))
        d = np.zeros(V)
        d[kept] = probs[row][kept] / probs[row][kept].sum()
        ref_dists.append(d)
    assert len(kept_sets[0]) <= k1 < len(kept_sets[1]) <= 8 * k1 < len(kept_sets[2])

    n = 1500
    logits = torch.from_numpy(np.log(probs).astype(np.float32)).repeat(n, 1)
    samples = tg.top_p_sample(_gen(7), logits, p=p, k_prefilter=k1).reshape(n, 3).numpy()
    for row in range(3):
        got = samples[:, row]
        assert set(int(t) for t in np.unique(got)) <= kept_sets[row]
        emp = np.bincount(got, minlength=V) / n
        tv = 0.5 * np.abs(emp - ref_dists[row]).sum()
        tol = 0.75 * np.sqrt(2 * len(kept_sets[row]) / (np.pi * n)) + 0.02
        assert tv < tol, f"row {row}: TV {tv:.3f} >= tol {tol:.3f}"


@pytest.mark.parametrize("report_probs", [True, False])
def test_seq2seq_sampler_matches_jax(base, report_probs):
    """p tiny makes sampling the argmax, so both samplers must give the same
    tokens: a 6-token prefill, force-fed tokens at 7 (both rows: eos, so
    the loop stops after it) and past it on row 0, pads elsewhere."""
    variables, _ = base
    jm, jv, tm = _pair(variables, fused=True, stacked=True)
    rng = np.random.default_rng(3)
    eos = 7
    ctx = np.zeros((2, 12), np.int32)
    ctx[:, :6] = rng.integers(10, 500, (2, 6))
    ctx[0, 6] = 321
    for row_eos, max_len in [(False, 16), (True, 16)]:
        c = ctx.copy()
        if row_eos:
            c[:, 7] = eos
        kw = dict(max_len=max_len, prefix_len=6, p_for_topp=1e-6, eos_token=eos,
                  report_probs=report_probs)
        j_tok, j_probs = jg.make_seq2seq_sampler(jm, **kw)(
            jv, jnp.asarray(c), jax.random.PRNGKey(1))
        t_tok, t_probs = tg.make_seq2seq_sampler(tm, **kw)(c, _gen(1))
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), atol=1e-5)
        assert t_tok[0, 6] == 321
        if row_eos:                                 # stopped after position 7
            assert (t_tok[:, 8:] == 0).all() and (t_tok[:, 7] == eos).all()
        if not report_probs:
            assert (t_probs == 0).all()


def test_report_probs_false_keeps_the_tokens(base):
    """At p=0.95 (real sampling), the same generator seed gives the same
    tokens with and without the probability chain."""
    variables, _ = base
    _, _, tm = _pair(variables, fused=True, stacked=True)
    ctx = np.random.default_rng(4).integers(10, 500, (2, 6)).astype(np.int32)
    outs = [tg.make_seq2seq_sampler(tm, max_len=16, prefix_len=6, eos_token=-1,
                                    report_probs=rp)(ctx, _gen(5)) for rp in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert (outs[0][1][:, 1:] > 0).all() and (outs[1][1] == 0).all()


def test_lm_head_is_fp32_of_bf16_operands():
    """bf16 config: the logits are the fp32 product of the bf16-rounded
    table and h, not rounded to bf16 (tests/test_grover.py::test_bf16_head_delta)."""
    rng = np.random.default_rng(0)
    table = rng.normal(0, 0.02, (503, 32)).astype(np.float32)
    h = rng.normal(0, 1.0, (4, 7, 32)).astype(np.float32)
    cfg = dict(vocab_size=503, hidden_size=32, num_hidden_layers=1,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=16, use_bfloat16=True)
    want = jg.lm_logits_for_hidden({"params": {"word_embed": jnp.asarray(table)}},
                                   jg.GroverConfig(**cfg), jnp.asarray(h, jnp.bfloat16))
    got = tg.lm_logits_for_hidden(torch.from_numpy(table), tg.GroverConfig(**cfg),
                                  torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_pooled_hidden_takes_first_clf(base):
    hidden = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    ids = torch.tensor([[1, 9, 2, 9, 0], [9, 1, 1, 1, 9]])
    want = jg.pooled_hidden(jnp.asarray(hidden.numpy()), jnp.asarray(ids.numpy()), 9)
    np.testing.assert_array_equal(tg.pooled_hidden(hidden, ids, 9).numpy(), np.asarray(want))


def test_unstack_pp_params_matches_jax(base):
    variables, _ = base
    pp = jg.stack_grover_params(variables, 2)
    got = tg.unstack_grover_params(flat_params(pp["params"]), 2)
    want = flat_params(jg.unstack_grover_params(pp, 2)["params"])
    assert sorted(got) == sorted(want) == sorted(flat_params(variables["params"]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
