"""K5's plain version and ``LnMatmul`` (merlot_tpu_torch) against the fused
LayerNorm + matmul Pallas kernel of merlot_tpu, run in interpret mode on the
CPU (``pallas_ln_matmul.INTERPRET``, set through monkeypatch) at shapes its
sizer takes; one shape it refuses is held against JAX's unfused fallback.

Inputs come from numpy with a seed; the JAX W_j [K, N] is the port's [N, K]
transposed. Tolerances are the JAX tests': fp32 1e-6 forward and 1e-4
grads; bf16 2e-2 (z and every product rounded to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_tpu.ops.pallas_ln_matmul as plm
from merlot_tpu.nn.transformer import TransformerEncoder as JaxEncoder
from merlot_tpu.nn.transformer import TransformerHParams as JaxHParams
from merlot_tpu_torch.convert import flax_path, load_flax_params
from merlot_tpu_torch.nn.transformer import TransformerEncoder, TransformerHParams
from merlot_tpu_torch.ops import cuda_ln_matmul, norms
from torch_port_helpers import flat_params, flax_layout


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(plm, "INTERPRET", True)


def _inputs(seed, lead, k, n, j, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (*lead, k)).astype(np.float32)
    gamma = rng.normal(1, 0.1, (k,)).astype(np.float32)
    beta = rng.normal(0, 0.1, (k,)).astype(np.float32)
    ws = [rng.normal(0, 0.02, (k, n)).astype(np.float32) for _ in range(j)]
    bs = [rng.normal(0, 0.01, (n,)).astype(np.float32) for _ in range(j)]
    jax_args = (jnp.asarray(x, dtype), jnp.asarray(gamma), jnp.asarray(beta),
                [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    torch_args = (torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
                  torch.from_numpy(beta), [torch.from_numpy(w.T.copy()) for w in ws],
                  [torch.from_numpy(b) for b in bs])
    return jax_args, torch_args


def _np(a):
    return np.asarray(a.float().detach().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("m,k,n,j", [(256, 256, 384, 3), (96, 128, 256, 1)])
def test_forward_matches_pallas(interpret, m, k, n, j):
    jargs, targs = _inputs(0, (2, m // 2), k, n, j)
    assert plm.kernel_supported(m, k, n, 4, j=j) is not None
    want = plm.ln_matmul(*jargs)
    got = cuda_ln_matmul.ln_matmul(*targs)
    plain = norms.ln_matmul_plain(*targs)
    assert len(got) == j
    for y, p, w in zip(got, plain, want):
        assert y.shape == (2, m // 2, n) and y.dtype == torch.float32
        assert torch.equal(y, p)
        np.testing.assert_allclose(_np(y), _np(w), rtol=1e-6, atol=1e-6)


def test_forward_bf16_matches_pallas(interpret):
    jargs, targs = _inputs(1, (128,), 128, 128, 1, dtype=jnp.bfloat16)
    (want,) = plm.ln_matmul(*jargs)
    (got,) = cuda_ln_matmul.ln_matmul(*targs)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_grads_match_pallas(interpret):
    m, k, n, j = 128, 128, 256, 2
    jargs, targs = _inputs(2, (m,), k, n, j)
    assert plm.kernel_supported(m, k, n, 4, j=j) is not None

    def fused(x, gamma, beta, ws, bs):
        return sum(jnp.sum(jnp.sin(y)) for y in plm.ln_matmul(x, gamma, beta, ws, bs))

    want = jax.grad(fused, argnums=(0, 1, 2, 3, 4))(jargs[0], jargs[1], jargs[2],
                                                     tuple(jargs[3]), tuple(jargs[4]))
    x, gamma, beta, ws, bs = targs
    leaves = [x, gamma, beta, *ws, *bs]
    for t in leaves:
        t.requires_grad_()
    loss = sum(torch.sin(y).sum() for y in cuda_ln_matmul.ln_matmul(x, gamma, beta, ws, bs))
    got = torch.autograd.grad(loss, leaves)
    want_flat = [want[0], want[1], want[2], *(w.T for w in want[3]), *want[4]]
    for g, w in zip(got, want_flat):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)


def test_row_tail_matches_unfused_fallback(interpret):
    """M = 100 has no 16-row block: JAX takes its unfused path (the
    LayerNorm->DenseTN math); the port has no sizer and runs LnMatmul."""
    jargs, targs = _inputs(3, (25, 4), 256, 256, 2)
    assert plm.kernel_supported(100, 256, 256, 4, j=2) is None
    want = plm.ln_matmul(*jargs)
    got = cuda_ln_matmul.ln_matmul(*targs)
    for y, w in zip(got, want):
        np.testing.assert_allclose(_np(y), _np(w), rtol=1e-6, atol=1e-6)


def test_kernel_refusals():
    """fp32 is refused by the kernel (no config on the port's paths runs
    the fused LayerNorm in fp32), as are K not a multiple of 64 or above
    1024 and N not a multiple of 8; CPU tensors never reach the kernel."""
    assert cuda_ln_matmul.kernel_supported(768, 3072, torch.bfloat16)
    assert not cuda_ln_matmul.kernel_supported(768, 768, torch.float32)
    assert not cuda_ln_matmul.kernel_supported(96, 768, torch.bfloat16)
    assert not cuda_ln_matmul.kernel_supported(2048, 768, torch.bfloat16)
    assert not cuda_ln_matmul.kernel_supported(768, 100, torch.bfloat16)
    x = torch.zeros(64, 128, dtype=torch.bfloat16)
    w = torch.zeros(256, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ln_matmul.ln_matmul_cuda(x, torch.ones(128), torch.zeros(128), w,
                                      torch.zeros(256, dtype=torch.bfloat16),
                                      num_out=2, epsilon=1e-5)


def _encoders(fuse):
    kw = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
              hidden_dropout_prob=0.0, softmax_fp32=True)
    return (JaxEncoder(JaxHParams(dtype=jnp.float32, fuse_ln_matmul=fuse, **kw)),
            TransformerEncoder(TransformerHParams(dtype=torch.float32,
                                                  fuse_ln_matmul=fuse, **kw)))


def test_encoder_fused_matches_pallas(interpret):
    """The fused encoder (K5's plain version in every layer) against JAX's
    fused encoder (the Pallas kernel in interpret mode): hidden states and
    grads, with the unfused port's parameter tree loading unchanged."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 32, 128)).astype(np.float32)
    mask = np.ones((2, 32, 32), np.float32)
    jenc, tenc = _encoders(True)
    v = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    assert set(tenc.state_dict()) == set(_encoders(False)[1].state_dict())
    load_flax_params(tenc, flat_params(v["params"]))

    def loss(p):
        return jnp.sum(jenc.apply({"params": p}, jnp.asarray(x),
                                  jnp.asarray(mask))["hidden_state"] ** 2)

    want = jenc.apply(v, jnp.asarray(x), jnp.asarray(mask))["hidden_state"]
    want_g = flat_params(jax.grad(loss)(v["params"]))
    out = tenc(torch.from_numpy(x), torch.from_numpy(mask), attn_backend="plain")
    np.testing.assert_allclose(_np(out["hidden_state"]), _np(want), rtol=1e-5, atol=1e-5)
    (out["hidden_state"] ** 2).sum().backward()
    for name, p in tenc.named_parameters():
        np.testing.assert_allclose(flax_layout(name, p.grad.numpy()),
                                   want_g[flax_path(name)], rtol=2e-4, atol=2e-4,
                                   err_msg=name)
