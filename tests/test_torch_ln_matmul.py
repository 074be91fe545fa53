"""K5's plain version and ``LnMatmul`` (merlot_tpu_torch) against the fused
LayerNorm + matmul Pallas kernel of merlot_tpu, run in interpret mode on the
CPU (``pallas_ln_matmul.INTERPRET``, set through monkeypatch) at shapes its
sizer takes; one shape it refuses is held against JAX's unfused fallback.

Inputs come from numpy with a seed; the JAX W_j [K, N] is the port's [N, K]
transposed. Tolerances are the JAX tests': fp32 1e-6 forward and 1e-4
grads; bf16 2e-2 (z and every product rounded to bf16).
"""

import math

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


# K5's tile walk (cuda_ln_matmul.launch_plan), checked on the CPU at every
# LayerNorm+matmul site of the train step and zero-shot (K = 768) and at
# ragged edges: row tails, N not a multiple of 256, J = 1 and 3, K up to
# 1024 (a shallower W ring beside the larger z)
WALK_SHAPES = [  # m, k, n, j
    (34048, 768, 768, 3), (34048, 768, 3072, 1), (12672, 768, 768, 3),
    (12672, 768, 3072, 1), (4096, 768, 768, 3), (4096, 768, 3072, 1),
    (11560, 768, 768, 3), (11560, 768, 3072, 1), (3540, 768, 768, 3),
    (3540, 768, 3072, 1),
    (1, 64, 8, 1), (100, 768, 768, 3), (130, 256, 40, 2), (129, 832, 3072, 1),
    (5000, 1024, 96, 3), (63, 1024, 8, 1),
]


def _cluster_units(plan, cluster):
    """The flat (pair block * col_tiles + column tile) units that cluster
    `cluster` walks, in order: the [t0, t1) of ln_matmul.cu's kernel,
    emulated."""
    total = plan["pair_blocks"] * plan["col_tiles"]
    return range(total * cluster // plan["clusters"],
                 total * (cluster + 1) // plan["clusters"])


@pytest.mark.parametrize("m,k,n,j", WALK_SHAPES)
def test_launch_plan_covers_every_tile_once(m, k, n, j):
    plan = cuda_ln_matmul.launch_plan(m, k, n, j, max_clusters=66)
    assert plan["stages"] == (4 if k <= 512 else 3 if k <= 768 else 2)
    assert plan["smem_bytes"] <= cuda_ln_matmul.MAX_SMEM
    assert cuda_ln_matmul.smem_bytes(plan["stages"] + 1, k) > cuda_ln_matmul.MAX_SMEM \
        or plan["stages"] == cuda_ln_matmul.MAX_STAGES
    pair = cuda_ln_matmul.CLUSTER * cuda_ln_matmul.BLOCK_ROWS
    assert plan["pair_blocks"] * pair >= m > (plan["pair_blocks"] - 1) * pair
    assert plan["col_tiles"] * cuda_ln_matmul.TILE_N >= j * n
    units = plan["pair_blocks"] * plan["col_tiles"]
    assert 1 <= plan["clusters"] <= min(66, units)
    walked = [t for c in range(plan["clusters"]) for t in _cluster_units(plan, c)]
    # in cluster order the ranges tile [0, units) ascending: a fixed order,
    # and every (pair block, column tile) unit exactly once
    assert walked == list(range(units))
    sizes = [len(_cluster_units(plan, c)) for c in range(plan["clusters"])]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    # z is computed once per pair block a cluster visits
    for c in range(plan["clusters"]):
        pbs = {t // plan["col_tiles"] for t in _cluster_units(plan, c)}
        assert len(pbs) <= -(-max(sizes) // plan["col_tiles"]) + 1


@pytest.mark.parametrize("m,k,n,j", [(100, 128, 96, 3), (300, 64, 200, 2)])
def test_tile_walk_assembles_the_plain_output(m, k, n, j):
    """The kernel's walk emulated on the CPU: per cluster and pair block,
    each block's 64 rows normalized once (rows past m never written); per
    256-column tile of the J*N outputs, each of the block's two warpgroups'
    128 columns: the fp32 sums rounded, the bias added and rounded,
    scattered to [J, m, N]."""
    _, (x, gamma, beta, ws, bs) = _inputs(3, (m,), k, n, j, np.float32)
    x = x.to(torch.bfloat16)
    plan = cuda_ln_matmul.launch_plan(m, k, n, j, max_clusters=2)
    rows, tn = cuda_ln_matmul.BLOCK_ROWS, cuda_ln_matmul.TILE_N
    w = torch.cat(ws).to(torch.bfloat16).float()
    bias = torch.cat(bs).to(torch.bfloat16).float()
    out = torch.full((j, m, n), float("nan"))
    for c in range(plan["clusters"]):
        for rank in range(cuda_ln_matmul.CLUSTER):
            z_pb = None
            for t in _cluster_units(plan, c):
                pb, ct = divmod(t, plan["col_tiles"])
                m0 = (pb * cuda_ln_matmul.CLUSTER + rank) * rows
                if z_pb != pb:
                    xs = torch.zeros((rows, k), dtype=torch.bfloat16)
                    real = max(0, min(rows, m - m0))
                    xs[:real] = x[m0:m0 + real]
                    z = norms.layer_norm(xs.float(), gamma, beta, 1e-5).to(torch.bfloat16)
                    z_pb = pb
                for wg in range(2):
                    n0 = ct * tn + wg * tn // 2
                    if n0 >= j * n:
                        continue
                    cols = torch.arange(n0, min(n0 + tn // 2, j * n))
                    y = (z.float() @ w[cols].t()).to(torch.bfloat16).float() + bias[cols]
                    y = y.to(torch.bfloat16).float()[:real]
                    for i, col in enumerate(cols.tolist()):
                        out[col // n, m0:m0 + real, col % n] = y[:, i]
    want = torch.stack(norms.ln_matmul_plain(x, gamma, beta, ws, bs)).float()
    assert not out.isnan().any()
    # the same rounding points; the CPU's fp32 sums of a 128-column slice
    # may round an element to its bf16 neighbour: at most one bf16 ulp of
    # the largest |y|, rarely
    diff = (out - want).abs()
    assert diff.max().item() <= 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (diff > 0).float().mean().item() < 1e-3
