"""The rest of the MERLOT transformer in merlot_tpu_torch against merlot_tpu
on the CPU: ``ops/masks.py``, cross-attention, the encoder KV cache,
per-layer remat under each of its policies, attention-prob dropout and the
two sampling helpers.

Each flax module is initialised by JAX and its parameters moved into the
port by ``convert.load_flax_params``; both run the same numpy-made inputs
in fp32. Tolerances: hidden states and grads within 1e-4 (atol and rtol; the
sums run in another order in each framework); the cached decode against
the full causal forward within JAX's own 2e-4. A remat run equals the port
without remat bit for bit (outputs, every grad, and the dropout
generator's state after the step), with hidden dropout on. Random draws
cannot match JAX's, so dropout and the samplers are held by their
distributions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from merlot_tpu.nn import transformer as jt
from merlot_tpu.ops import masks as jmasks
from merlot_tpu.ops import sampling as jsampling
from merlot_tpu.ops.attention import attention_core as jax_attention_core
from merlot_tpu_torch.convert import flax_path, load_flax_params
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.nn import transformer as tt
from merlot_tpu_torch.nn.layers import init_params
from merlot_tpu_torch.ops import cuda_attention, masks, sampling
from merlot_tpu_torch.ops.attention import attention_core

FP32 = dict(atol=1e-4, rtol=1e-4)
HP = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
          hidden_dropout_prob=0.0)
POLICIES = [None, "dots", "dots_no_batch", "probs", "probs_dots"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: test files may run side by side, and
    torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(variables):
    return {k: np.asarray(v) for k, v in flatten_dict(variables["params"], sep="/").items()}


def _pair(x, mask, seed=0, **kw):
    """(flax encoder, its variables, the port encoder with its weights), fp32."""
    jm = jt.TransformerEncoder(jt.TransformerHParams(**HP, dtype=jnp.float32))
    variables = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(seed), *a, **kw))(
        jnp.asarray(x), jnp.asarray(mask))
    tm = tt.TransformerEncoder(tt.TransformerHParams(**HP, dtype=torch.float32))
    load_flax_params(tm, _flat(variables))
    return jm, variables, tm


def _close(got, want, tol=FP32, name=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=name, **tol)


def _flax_grad(name, g):
    """A port gradient in the flax layout (dense kernels transposed)."""
    g = g.detach().numpy()
    return g.T if g.ndim == 2 and name.endswith("weight") else g


# --- ops/masks.py ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_hot_gather_matches_jax(dtype):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((10, 8)).astype(np.float32)
    idx = np.array([3, 0, 9, 3], np.int32)
    want = jmasks.one_hot_gather(jnp.asarray(table, getattr(jnp, dtype)), jnp.asarray(idx))
    got = masks.one_hot_gather(torch.from_numpy(table).to(getattr(torch, dtype)),
                               torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("nd,ns", [(3, 5), (4, 4), (1, 7)])
def test_ltr_mask_matches_jax(nd, ns):
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        got = masks.ltr_attention_mask(nd, ns, dtype=td)
        assert got.dtype == td and got.shape == (nd, ns)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(
            jmasks.ltr_attention_mask(nd, ns, jd), np.float32))


def test_unilm_mask_matches_jax():
    rng = np.random.default_rng(1)
    bidi = (rng.random((3, 7)) < 0.3).astype(np.float32)
    pad = rng.random((3, 7)) < 0.2
    for p in (None, pad):
        want = jmasks.unilm_attention_mask(jnp.asarray(bidi),
                                           None if p is None else jnp.asarray(p))
        got = masks.unilm_attention_mask(torch.from_numpy(bidi),
                                         None if p is None else torch.from_numpy(p))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- cross-attention ------------------------------------------------------

def _cross_inputs(seed=2, b=2, sq=5, sk=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, sq, 32)).astype(np.float32)
    x_enc = rng.standard_normal((b, sk, 32)).astype(np.float32)
    valid_q, valid_k = np.ones((b, sq), bool), np.ones((b, sk), bool)
    valid_q[0, 4:], valid_k[0, 6:], valid_k[1, 8:] = False, False, False
    mask = (valid_q[:, :, None] & valid_k[:, None]).astype(np.float32)   # rectangular
    # the loss reads no fully masked row: JAX's additive-bias mask passes
    # those rows' scores a gradient that the multiplicative form (the
    # port's, and JAX's colsum path's) does not, though the forwards agree
    r = rng.standard_normal((b, sq, 32)).astype(np.float32) * valid_q[:, :, None]
    return x, x_enc, mask, r


def test_cross_attention_matches_jax():
    """Keys and values from x_enc (Sq 5 != Sk 9, a rectangular validity mask
    with fully masked rows): hidden states and the grads of every weight, x
    and x_enc against JAX's; the kernel backend (its plain versions on CPU
    tensors, K1/K2's functions at Sq != Sk) against the plain one."""
    x, x_enc, mask, r = _cross_inputs()
    jm, variables, tm = _pair(x, mask, x_enc=jnp.asarray(x_enc))

    def jloss(p, x, x_enc):
        h = jm.apply({"params": p}, x, jnp.asarray(mask), x_enc=x_enc)["hidden_state"]
        return jnp.sum(h * r), h
    (_, jh), (jgp, jgx, jge) = jax.jit(jax.value_and_grad(jloss, (0, 1, 2), has_aux=True))(
        variables["params"], jnp.asarray(x), jnp.asarray(x_enc))
    jgp = {k: np.asarray(v) for k, v in flatten_dict(jgp, sep="/").items()}

    grads = {}
    for backend in ("plain", "cuda"):
        tm.zero_grad(set_to_none=True)
        tx, te = (torch.from_numpy(a).requires_grad_() for a in (x, x_enc))
        h = tm(tx, torch.from_numpy(mask), x_enc=te, attn_backend=backend)["hidden_state"]
        (h * torch.from_numpy(r)).sum().backward()
        grads[backend] = (h, tx.grad, te.grad,
                          {n: p.grad.clone() for n, p in tm.named_parameters()})
    h, gx, ge, gp = grads["plain"]
    assert h.shape == (2, 5, 32)
    _close(h, jh, name="hidden")
    _close(gx, jgx, name="dx")
    _close(ge, jge, name="dx_enc")
    for n, g in gp.items():
        np.testing.assert_allclose(_flax_grad(n, g), jgp[flax_path(n)], err_msg=n, **FP32)
    for a, b in zip(grads["cuda"][:3], grads["plain"][:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    for n in gp:
        torch.testing.assert_close(grads["cuda"][3][n], gp[n], atol=1e-5, rtol=1e-5)


# --- the encoder KV cache -------------------------------------------------

def test_init_cache_matches_jax():
    for dtype, jd, td in ((None, jnp.bfloat16, torch.bfloat16),
                          (torch.float32, jnp.float32, torch.float32)):
        jm = jt.TransformerEncoder(jt.TransformerHParams(**HP))
        tm = tt.TransformerEncoder(tt.TransformerHParams(**HP))
        want = jm.init_cache(3, 11, None if dtype is None else jd)
        got = tm.init_cache(3, 11, dtype)
        assert list(got) == list(want) == ["k00", "v00", "k01", "v01"]
        for k in want:
            assert tuple(got[k].shape) == want[k].shape == (3, 11, 2, 16)
            assert got[k].dtype == td and want[k].dtype == jd
            assert not got[k].any()


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_encoder_cache_decode_matches_jax_and_full_forward(backend):
    """A 3-token cached prefix, then one token at a time into max_len 8:
    each step writes its keys and values at cache_pos and attends over the
    whole buffer under a [B, Sq, 8] mask. The decoded hidden states equal
    JAX's decode and the port's full causal forward (2e-4); the cache
    returned is the one passed in, written in place; a cached call under
    remat does not checkpoint (a no-grad decode and a grad decode agree)."""
    b, s, max_len, prefix = 2, 6, 8, 3
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    causal = np.broadcast_to(np.tril(np.ones((s, s), np.float32)), (b, s, s)).copy()
    jm, variables, tm = _pair(x, causal)
    full = tm(torch.from_numpy(x), torch.from_numpy(causal),
              attn_backend=backend)["hidden_state"]

    def step_mask(t0, n):
        return (np.arange(max_len)[None, None] <= np.arange(t0, t0 + n)[None, :, None]
                ).astype(np.float32).repeat(b, 0)

    spans = [(0, prefix)] + [(t, 1) for t in range(prefix, s)]
    jcache = jm.init_cache(b, max_len)
    jouts = []
    for t0, n in spans:
        o = jax.jit(lambda v, xs, m, c, t0=t0: jm.apply(v, xs, m, cache=c, cache_pos=t0))(
            variables, jnp.asarray(x[:, t0:t0 + n]), jnp.asarray(step_mask(t0, n)), jcache)
        jcache = o["new_cache"]
        jouts.append(np.asarray(o["hidden_state"]))
    remat = tt.TransformerEncoder(tt.TransformerHParams(**HP, dtype=torch.float32,
                                                        remat=True))
    remat.load_state_dict(tm.state_dict())
    for enc in (tm, remat):
        cache = enc.init_cache(b, max_len)
        outs = []
        for t0, n in spans:
            o = enc(torch.from_numpy(x[:, t0:t0 + n]), torch.from_numpy(step_mask(t0, n)),
                    cache=cache, cache_pos=t0, attn_backend=backend)
            assert all(o["new_cache"][k] is cache[k] for k in cache)
            outs.append(o["hidden_state"])
        decoded = torch.cat(outs, dim=1)
        np.testing.assert_allclose(decoded.detach().numpy(), np.concatenate(jouts, axis=1),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(decoded.detach().numpy(), full.detach().numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(cache["k01"][:, :s].detach().numpy(),
                                   np.asarray(jcache["k01"])[:, :s], **FP32)
        assert not cache["v00"][:, s:].any()


# --- remat ----------------------------------------------------------------

def _remat_run(tm, policy, x, mask, backend, seed=5, remat=True, **hp_kw):
    hp = dataclasses.replace(tm.hp, remat=remat, remat_policy=policy, **hp_kw)
    enc = tt.TransformerEncoder(hp)
    enc.load_state_dict(tm.state_dict())
    tx = torch.from_numpy(x).requires_grad_()
    g = torch.Generator().manual_seed(seed)
    out = enc(tx, torch.from_numpy(mask), collect="colsum", attn_backend=backend,
              deterministic=False, generator=g)
    w = torch.arange(out["attn_colsum"].shape[1], dtype=torch.float32)
    loss = (out["hidden_state"] ** 2).sum() + (out["attn_colsum"] * w).sum()
    loss.backward()
    return ([out["hidden_state"], out["attn_colsum"], tx.grad]
            + [p.grad for p in enc.parameters()], g.get_state())


def _encoder_inputs(seed=4, b=2, s=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[0, 7:] = False                              # fully masked rows
    return x, (valid[:, None] & valid[:, :, None]).astype(np.float32)


@pytest.fixture(scope="module")
def port_encoder():
    tm = tt.TransformerEncoder(tt.TransformerHParams(**HP, dtype=torch.float32))
    init_params(tm, torch.Generator().manual_seed(0))
    return tm


@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_remat_bit_for_bit(port_encoder, monkeypatch, policy, backend):
    """Hidden dropout 0.1 (and attention-prob dropout on the plain path)
    from one generator seed: the colsum, hidden states, every grad and the
    generator's state after the backward equal the run without remat bit
    for bit. The kernel backend (its plain versions on CPU tensors) runs
    the attention forward again in the recompute, except under 'probs' and
    'probs_dots', which keep its outputs."""
    x, mask = _encoder_inputs()
    calls = []
    orig = cuda_attention.flash_attention_plain
    monkeypatch.setattr(cuda_attention, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    kw = dict(hidden_dropout_prob=0.1,
              attention_probs_dropout_prob=0.1 if backend == "plain" else 0.0)
    want, want_state = _remat_run(port_encoder, policy, x, mask, backend, remat=False, **kw)
    n_ref = len(calls)
    got, got_state = _remat_run(port_encoder, policy, x, mask, backend, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got_state, want_state)
    if backend == "cuda":
        layers = port_encoder.hp.num_layers
        assert n_ref == layers
        assert len(calls) - n_ref == (layers if policy in ("probs", "probs_dots")
                                      else 2 * layers)


def test_remat_sees_redrawn_dropout_masks(port_encoder, monkeypatch):
    """The bit-for-bit check above fails when the recompute draws new
    dropout masks (the generator's state not set back)."""
    x, mask = _encoder_inputs()
    want, _ = _remat_run(port_encoder, None, x, mask, "plain", remat=False,
                         hidden_dropout_prob=0.1)
    orig = tt._remat_contexts
    monkeypatch.setattr(tt, "_remat_contexts", lambda policy, gen: orig(policy, None))
    got, _ = _remat_run(port_encoder, None, x, mask, "plain", hidden_dropout_prob=0.1)
    assert torch.equal(got[0], want[0])
    assert not all(torch.equal(a, b) for a, b in zip(got[2:], want[2:]))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax(policy):
    """The port's remat encoder against JAX's ``remat=True`` encoder under
    the same policy (dropout off): hidden states, colsum and the grads of x
    and every weight through the colsum's cotangent too."""
    x, mask = _encoder_inputs(seed=6)
    jhp = jt.TransformerHParams(**HP, dtype=jnp.float32, remat=True, remat_policy=policy)
    jm = jt.TransformerEncoder(jhp)
    variables = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(1), *a))(
        jnp.asarray(x), jnp.asarray(mask))
    w = jnp.arange(x.shape[1], dtype=jnp.float32)

    def jloss(p, xx):
        o = jm.apply({"params": p}, xx, jnp.asarray(mask), collect="colsum")
        return (jnp.sum(o["hidden_state"] ** 2) + jnp.sum(o["attn_colsum"] * w),
                (o["hidden_state"], o["attn_colsum"]))
    (_, (jh, jc)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    jgp = {k: np.asarray(v) for k, v in flatten_dict(jgp, sep="/").items()}

    tm = tt.TransformerEncoder(tt.TransformerHParams(**HP, dtype=torch.float32))
    load_flax_params(tm, _flat(variables))
    got, _ = _remat_run(tm, policy, x, mask, "plain")
    h, colsum, gx = got[:3]
    enc = tt.TransformerEncoder(tm.hp)
    names = [n for n, _ in enc.named_parameters()]
    _close(h, jh, name="hidden")
    _close(colsum, jc, name="colsum")
    _close(gx, jgx, name="dx")
    for n, g in zip(names, got[3:]):
        np.testing.assert_allclose(_flax_grad(n, g), jgp[flax_path(n)], err_msg=n, **FP32)


@pytest.mark.parametrize("policy", ["dot", "all", "probs-dots"])
def test_unknown_remat_policy_raises(policy):
    with pytest.raises(ValueError, match=policy):
        tt.TransformerHParams(remat=True, remat_policy=policy)
    with pytest.raises(ValueError, match=policy):
        MerlotModel(MerlotConfig(hidden_size=32, num_attention_heads=2,
                                 intermediate_size=64, num_hidden_layers=1,
                                 remat=True, remat_policy=policy))


def test_remat_reaches_all_three_towers():
    cfg = MerlotConfig(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                       num_hidden_layers=2, num_vision_transformer_hidden_layers=1,
                       num_lang_transformer_hidden_layers=1, share_params=False,
                       vocab_size=100, remat=True, remat_policy="probs_dots")
    m = MerlotModel(cfg)
    for enc in (m.vision_backbone.encoder, m.encoder, m.langonly_encoder):
        assert enc.hp.remat and enc.hp.remat_policy == "probs_dots"


# --- attention-prob dropout -----------------------------------------------

def _uniform_probe(b=4, s=64, rate=0.2):
    """q = k = 0 (every prob 1/s) and v one-hot over the keys (head dim s):
    ctx rows are the dropped-out probs themselves."""
    q = torch.zeros(b, s, 1, s)
    v = torch.eye(s).expand(b, s, s)[:, :, None]
    return q, v


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_attention_prob_dropout_keep_rate(rate):
    """Each prob is kept with probability 1 - rate and scaled by 1/(1 -
    rate), as JAX's XLA path does it (its keep rate measured the same way);
    the colsum is taken before the dropout; the kernel backend takes the
    plain path at a nonzero rate (JAX's routing)."""
    b, s = 8, 64
    q, v = _uniform_probe(b, s)
    ctx, colsum = attention_core(q, q, v, None, collect="colsum", dropout_rate=rate,
                                 generator=torch.Generator().manual_seed(0), backend="cuda")
    kept = ctx != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    torch.testing.assert_close(ctx[kept], torch.full_like(ctx[kept], 1 / s / (1 - rate)))
    torch.testing.assert_close(colsum, torch.full((b, s), 1.0))
    jctx, _ = jax_attention_core(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()),
                                 jnp.asarray(v.numpy()), None, dropout_rate=rate,
                                 dropout_rng=jax.random.PRNGKey(0), backend="xla")
    jkept = np.asarray(jctx) != 0
    assert abs(jkept.mean() - (1 - rate)) < 0.01
    np.testing.assert_allclose(np.asarray(jctx)[jkept], 1 / s / (1 - rate), rtol=1e-6)


def test_attention_prob_dropout_rate_zero_is_the_plain_path():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 6, 2, 16)).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy((rng.random((2, 6, 6)) < 0.7).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    a, ca = attention_core(q, k, v, mask, collect="colsum", dropout_rate=0.0, generator=g)
    b, cb = attention_core(q, k, v, mask, collect="colsum")
    assert torch.equal(a, b) and torch.equal(ca, cb)
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(0).get_state())


def test_encoder_attention_prob_dropout():
    """In the encoder the probs' dropout acts only when not deterministic,
    and one generator seed gives one result."""
    x, mask = _encoder_inputs()
    tm = tt.TransformerEncoder(tt.TransformerHParams(**dict(HP, hidden_dropout_prob=0.0),
                                                     attention_probs_dropout_prob=0.2,
                                                     dtype=torch.float32))
    init_params(tm, torch.Generator().manual_seed(0))
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    det = tm(*args)["hidden_state"]
    runs = [tm(*args, deterministic=False,
               generator=torch.Generator().manual_seed(s))["hidden_state"] for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2]) and not torch.equal(runs[0], det)


# --- sampling ---------------------------------------------------------------

def test_sample_bernoulli_distribution():
    g = torch.Generator().manual_seed(0)
    for p in (0.1, 0.5, 0.8):
        got = sampling.sample_bernoulli(p, (20000,), generator=g)
        want = jsampling.sample_bernoulli(jax.random.PRNGKey(0), p, (20000,))
        assert got.dtype == torch.bool
        assert abs(got.float().mean().item() - p) < 0.015
        assert abs(float(jnp.mean(want)) - p) < 0.015
    probs = torch.tensor([0.0, 1.0])
    assert sampling.sample_bernoulli(probs, (2,), generator=g).tolist() == [False, True]


@pytest.mark.parametrize("n,p", [(10, 0.3), (40, 0.05)])
def test_binomial_sample_distribution(n, p):
    """5000 draws: the mean and variance of Binomial(n, p), and each count's
    frequency within 0.02 of its pmf, as JAX's draws give."""
    from math import comb
    g = torch.Generator().manual_seed(1)
    got = np.array([int(sampling.binomial_sample(n, p, generator=g)) for _ in range(5000)])
    keys = jax.random.split(jax.random.PRNGKey(1), 5000)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jsampling.binomial_sample(k, n, p)))(keys))
    pmf = np.array([comb(n, c) * p ** c * (1 - p) ** (n - c) for c in range(n + 1)])
    for draws in (got, want):
        assert draws.min() >= 0 and draws.max() <= n
        assert abs(draws.mean() - n * p) < 0.1 * max(1.0, n * p)
        assert abs(draws.var() - n * p * (1 - p)) < 0.15 * n * p * (1 - p)
        freq = np.bincount(draws, minlength=n + 1) / len(draws)
        assert np.abs(freq - pmf).max() < 0.02
