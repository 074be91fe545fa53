"""K4's plain version and ``GroupNormAct`` (merlot_tpu_torch) against the
fused GroupNorm Pallas kernel of merlot_tpu, run in interpret mode on the
CPU as tests/test_pallas_groupnorm.py runs it.

Inputs come from numpy with a seed. Tolerances are the JAX tests': fp32
2e-5 on the forward (the same fp32 steps, sums in another order) and 2e-4
on the grads; bf16 1e-2 (an fp32 difference of an ulp can move the bf16
rounding of an element by one bf16 ulp). mean and rstd fp32 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlot_tpu.ops import pallas_groupnorm as pgn
from merlot_tpu_torch.nn.layers import init_params
from merlot_tpu_torch.nn.transformer import TransformerHParams
from merlot_tpu_torch.nn.vit import LiteResNet, VisionBackbone
from merlot_tpu_torch.ops import cuda_groupnorm, norms

GROUPS, EPS = 32, 1e-4
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _inputs(seed, shape, dtype, residual):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    gamma = rng.normal(1, 0.1, (c,)).astype(np.float32)
    beta = rng.normal(0, 0.1, (c,)).astype(np.float32)
    res = rng.normal(0, 1, shape).astype(np.float32) if residual else None
    jx = jnp.asarray(x, dtype)
    jres = None if res is None else jnp.asarray(res, dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tx = torch.from_numpy(x).to(tdt)
    tres = None if res is None else torch.from_numpy(res).to(tdt)
    return (jx, jnp.asarray(gamma), jnp.asarray(beta), jres,
            tx, torch.from_numpy(gamma), torch.from_numpy(beta), tres)


def _np(a):
    return np.asarray(a.float().detach().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [256, 64, 32])
@pytest.mark.parametrize("mode", ["plain", "relu", "residual"])
def test_forward_and_stats_match_pallas(dtype, c, mode):
    jx, jg, jb, jres, tx, tg, tb, tres = _inputs(0, (2, 6, 11, c), dtype,
                                                 mode == "residual")
    relu = mode != "plain"
    with pltpu.force_tpu_interpret_mode():
        want, want_mean, want_rstd = pgn._fwd_impl(jx, jg, jb, jres, GROUPS, EPS, relu)
        want_api = pgn.group_norm_act(jx, jg, jb, residual=jres, num_groups=GROUPS,
                                      relu=relu, backend="pallas")
    got, mean, rstd = norms.group_norm_act_plain(tx, tg, tb, tres, GROUPS, EPS, relu)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert mean.shape == rstd.shape == (2, GROUPS) and mean.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_np(mean), _np(want_mean), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(rstd), _np(want_rstd), rtol=2e-5, atol=2e-5)
    # the autograd Function on CPU tensors runs the same plain version
    fn = cuda_groupnorm.group_norm_act(tx, tg, tb, residual=tres, num_groups=GROUPS,
                                       relu=relu, backend="cuda")
    assert torch.equal(fn, got)
    np.testing.assert_allclose(_np(fn), _np(want_api), **TOL[dtype])


@pytest.mark.parametrize("mode", ["plain", "relu", "residual"])
def test_grads_match_pallas(mode):
    jx, jg, jb, jres, tx, tg, tb, tres = _inputs(1, (2, 4, 7, 64), "float32",
                                                 mode == "residual")
    relu = mode != "plain"

    def loss(x, g, b, r):
        out = pgn.group_norm_act(x, g, b, residual=r, num_groups=GROUPS, relu=relu,
                                 backend="pallas")
        return jnp.sum(out * out)

    argnums = (0, 1, 2) if jres is None else (0, 1, 2, 3)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums)(jx, jg, jb, jres)
    leaves = [t.requires_grad_() for t in (tx, tg, tb, tres) if t is not None]
    out = cuda_groupnorm.group_norm_act(tx, tg, tb, residual=tres, num_groups=GROUPS,
                                        relu=relu, backend="cuda")
    got = torch.autograd.grad((out * out).sum(), leaves)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["plain", "relu", "residual"])
def test_saved_stats_backward_matches_unfused_autograd(mode):
    """The fused path's backward (``group_norm_act_bwd``) against autograd
    through the unfused composition, fp32."""
    *_, tx, tg, tb, tres = _inputs(2, (3, 5, 4, 64), "float32", mode == "residual")
    relu = mode != "plain"
    dy = torch.from_numpy(np.random.default_rng(3).normal(0, 1, tx.shape).astype(np.float32))
    grads = []
    for backend in ("plain", "cuda"):
        leaves = [t.detach().clone().requires_grad_() for t in (tx, tg, tb, tres)
                  if t is not None]
        out = cuda_groupnorm.group_norm_act(*leaves[:3], residual=(
            leaves[3] if tres is not None else None), relu=relu, backend=backend)
        grads.append(torch.autograd.grad(out, leaves, dy))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_backend_dispatch_and_defaults():
    assert cuda_groupnorm.BACKEND == cuda_groupnorm.TRAIN_BACKEND == "plain"
    *_, tx, tg, tb, _ = _inputs(4, (1, 3, 3, 32), "float32", False)
    with pytest.raises(ValueError, match="backend"):
        cuda_groupnorm.group_norm_act(tx, tg, tb, backend="pallas")
    # K4 itself takes CUDA tensors only: nothing falls back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        cuda_groupnorm.group_norm_act_cuda(tx, tg, tb, None, num_groups=GROUPS,
                                           epsilon=EPS, relu=False)
    assert cuda_groupnorm.kernel_supported(1024, 32, torch.bfloat16)
    assert not cuda_groupnorm.kernel_supported(4096, 32, torch.bfloat16)
    assert not cuda_groupnorm.kernel_supported(48, 32, torch.bfloat16)
    assert not cuda_groupnorm.kernel_supported(64, 32, torch.float16)


@pytest.mark.parametrize("deterministic", [True, False])
def test_vision_backbone_picks_the_path_backend(monkeypatch, deterministic):
    """VisionBackbone takes BACKEND on forward-only calls and TRAIN_BACKEND
    in training, for every one of the stem's GroupNorms; LiteResNet's
    channels-last GroupNorm inputs are contiguous, as K4 requires."""
    calls = []
    orig = cuda_groupnorm.GroupNormAct.apply

    def counting(x, *a):
        calls.append(x.is_contiguous())
        return orig(x, *a)

    monkeypatch.setattr(cuda_groupnorm.GroupNormAct, "apply", counting)
    monkeypatch.setattr(cuda_groupnorm, "BACKEND", "cuda" if deterministic else "plain")
    monkeypatch.setattr(cuda_groupnorm, "TRAIN_BACKEND",
                        "plain" if deterministic else "cuda")
    hp = TransformerHParams(hidden_size=64, num_layers=1, num_heads=4,
                            intermediate_size=128, dtype=torch.float32,
                            hidden_dropout_prob=0.0)
    vb = VisionBackbone(hidden_size=64, resnet_layers=(1, 1, 1), dtype=torch.float32,
                        vit_hp=hp)
    init_params(vb, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 32, 48, 3))
                           .astype(np.float32))
    with torch.no_grad():
        vb(img, attn_backend="plain", deterministic=deterministic)
    assert len(calls) == 3 + 4 * 3 and all(calls)     # stem + 3 blocks with projections
    calls.clear()
    with torch.no_grad():
        vb.resnet(img.to(torch.float32) - 0.5, gn_backend="plain")
    assert calls == []


def test_resnet_cuda_backend_matches_plain_on_cpu():
    """The whole LiteResNet, fused path (plain version of K4) against the
    unfused one, fp32: the same function up to the order of fp32 sums."""
    net = LiteResNet((1, 1, 1), dtype=torch.float32)
    init_params(net, torch.Generator().manual_seed(1))
    img = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 32, 48, 3))
                           .astype(np.float32))
    with torch.no_grad():
        a = net(img, gn_backend="cuda")
        b = net(img, gn_backend="plain")
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# K4's launch plan (cuda_groupnorm.launch_plan), checked on the CPU at every
# GroupNorm site of the train step (128 frames of 192x352) and of zero-shot
# (20 frames of 384x384), and at ragged edges: (hw, c, groups, bytes per
# element)
PLAN_SITES = [
    (16896, 32, 32, 2), (16896, 64, 32, 2), (4224, 256, 32, 2), (4224, 64, 32, 2),
    (4224, 128, 32, 2), (1056, 512, 32, 2), (1056, 128, 32, 2), (1056, 256, 32, 2),
    (264, 1024, 32, 2), (264, 256, 32, 2),
    (36864, 32, 32, 2), (36864, 64, 32, 2), (9216, 256, 32, 2), (9216, 64, 32, 2),
    (9216, 128, 32, 2), (2304, 512, 32, 2), (2304, 128, 32, 2), (2304, 256, 32, 2),
    (576, 1024, 32, 2), (576, 256, 32, 2),
    (1, 32, 32, 2), (5, 32, 32, 4), (77, 40, 4, 2), (17, 2048, 32, 2), (1000, 1024, 32, 4),
    (3000, 32, 32, 4), (100000, 64, 32, 2), (33, 1024, 32, 2),
]


def _block_rows(plan, hw, rank):
    """The rows of every image that the block of cluster rank `rank` keeps
    resident and the rows it reads from global memory: groupnorm.cu's
    row0 / n_rows / n_res, emulated."""
    row0 = rank * plan["rows_per_block"]
    n_rows = max(0, min(hw, row0 + plan["rows_per_block"]) - row0)
    n_res = min(n_rows, plan["res_rows"])
    return range(row0, row0 + n_res), range(row0 + n_res, row0 + n_rows)


@pytest.mark.parametrize("hw,c,groups,elem", PLAN_SITES)
def test_launch_plan_covers_every_row_once(hw, c, groups, elem):
    plan = cuda_groupnorm.launch_plan(hw, c, groups, elem)
    cs = plan["cluster"]
    assert cs in (1, 2, 4, 8, 16)
    assert plan["smem_bytes"] <= cuda_groupnorm.SMEM_TARGET <= cuda_groupnorm.MAX_SMEM
    assert plan["smem_bytes"] == cuda_groupnorm.smem_bytes(plan["res_rows"], c, groups, elem)
    assert cs * plan["rows_per_block"] >= hw
    rows = []
    for rank in range(cs):
        res, streamed = _block_rows(plan, hw, rank)
        assert len(res) <= plan["res_rows"]
        rows += list(res) + list(streamed)
    assert rows == list(range(hw))          # every row once, ranks in order
    # the smallest cluster whose blocks hold their rows, else 16 that stream
    fits = plan["res_rows"] == plan["rows_per_block"]
    assert fits or cs == cuda_groupnorm.MAX_CLUSTER
    if cs > 1:
        half = cuda_groupnorm.smem_bytes(-(-hw // (cs // 2)), c, groups, elem)
        assert half > cuda_groupnorm.SMEM_TARGET


def _kernel_order_stats(x, plan, groups, eps):
    """mean, rstd of one image x [hw, c] fp32 summed in the kernel's order:
    each thread's rows (piece by piece, then the streamed rows, R apart),
    the block's R thread rows in order, the group's channels in order, then
    the cluster's ranks in order."""
    hw, c = x.shape
    r = cuda_groupnorm.MAX_THREADS // (c // 4)
    cpg = c // groups
    a = torch.zeros(groups)
    q = torch.zeros(groups)
    parts = []
    for rank in range(plan["cluster"]):
        res, streamed = _block_rows(plan, hw, rank)
        piece = -(-len(res) // cuda_groupnorm.PIECES)
        segs = [res[i:i + piece] for i in range(0, len(res), piece)] if piece else []
        s1, s2 = torch.zeros(r, c), torch.zeros(r, c)
        for seg in segs + [streamed]:
            for k in range(seg.start, seg.stop, r):
                blk = x[k:min(k + r, seg.stop)]
                s1[:len(blk)] += blk
                s2[:len(blk)] += blk * blk
        p1, p2 = torch.zeros(c), torch.zeros(c)
        for i in range(r):
            p1 += s1[i]
            p2 += s2[i]
        parts.append((p1, p2))
    for p1, p2 in parts:
        g1, g2 = torch.zeros(groups), torch.zeros(groups)
        for j in range(cpg):
            g1 += p1.view(groups, cpg)[:, j]
            g2 += p2.view(groups, cpg)[:, j]
        a += g1
        q += g2
    n = torch.tensor(float(hw * cpg))
    mean = a / n
    return mean, torch.rsqrt(q / n - mean * mean + eps)


@pytest.mark.parametrize("hw,c,target_rows", [(600, 64, 20), (300, 128, 1000), (77, 32, 3)])
def test_cluster_reduction_order_gives_the_stats(monkeypatch, hw, c, target_rows):
    """The plan's ranks, pieces and streamed rows summed in the kernel's fixed
    order give the plain version's statistics (fp32 sums in another order);
    SMEM_TARGET is cut so that small images take clusters and stream rows."""
    fixed = cuda_groupnorm.smem_bytes(0, c, GROUPS, 4)
    monkeypatch.setattr(cuda_groupnorm, "SMEM_TARGET", fixed + target_rows * c * 4)
    plan = cuda_groupnorm.launch_plan(hw, c, GROUPS, 4)
    assert (plan["cluster"] > 1) == (target_rows < hw)
    x = torch.from_numpy(np.random.default_rng(0).normal(0.3, 1.0, (2, hw, c))
                         .astype(np.float32))
    _, mean, rstd = norms.group_norm_act_plain(x, torch.ones(c), torch.zeros(c), None,
                                               GROUPS, EPS, False)
    for b in range(2):
        m, r = _kernel_order_stats(x[b], plan, GROUPS, EPS)
        torch.testing.assert_close(m, mean[b], atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(r, rstd[b], atol=1e-6, rtol=1e-5)
