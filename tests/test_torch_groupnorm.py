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
from torch.profiler import ProfilerActivity, profile

from merlot_tpu.ops import pallas_groupnorm as pgn
from merlot_tpu_torch.core import trace
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
    assert cuda_groupnorm.BACKEND == "auto"
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["plain", "relu", "residual"])
def test_auto_is_plain_on_cpu_bit_for_bit(dtype, mode):
    """On CPU tensors 'auto' is the composition: the same outputs and
    gradients, bit for bit, as 'plain'."""
    *_, tx, tg, tb, tres = _inputs(7, (2, 5, 3, 64), dtype, mode == "residual")
    dy = torch.from_numpy(np.random.default_rng(8).normal(0, 1, tx.shape)
                          .astype(np.float32)).to(tx.dtype)
    runs = []
    for backend in ("auto", "plain"):
        leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
                  for t in (tx, tg, tb, tres) if t is not None]
        out = cuda_groupnorm.group_norm_act(
            *leaves[:3], residual=leaves[3] if tres is not None else None,
            relu=mode != "plain", backend=backend)
        runs.append((out, *torch.autograd.grad(out, leaves, dy)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# 'auto''s rule at the stem's channel counts and beyond what the kernels
# take: (C, groups, dtype). On a CUDA tensor 'auto' is ``GroupNormAct``
# whatever the shape (K4 and K4B raise on what they refuse, as under
# 'cuda'); on a CPU tensor it is the composition.
AUTO_CASES = [
    (32, 32, torch.bfloat16), (1024, 32, torch.bfloat16), (2048, 32, torch.bfloat16),
    (4096, 32, torch.bfloat16), (1024, 32, torch.float32), (2048, 32, torch.float32),
    (36, 4, torch.float32), (36, 4, torch.bfloat16), (64, 32, torch.float16),
    (96, 32, torch.float32), (20, 4, torch.bfloat16),
]


@pytest.mark.parametrize("c,groups,dtype", AUTO_CASES)
def test_auto_picks_the_kernels_where_the_card_takes_them(monkeypatch, c, groups, dtype):
    x = torch.from_numpy(np.random.default_rng(c).normal(0, 1, (1, 2, 2, c))
                         .astype(np.float32)).to(dtype)
    gamma, beta = torch.ones(c), torch.zeros(c)
    kw = dict(num_groups=groups, relu=True)
    # a CPU tensor: the composition, bit for bit
    want = norms.group_norm_act(x, gamma, beta, **kw)
    assert torch.equal(cuda_groupnorm.group_norm_act(x, gamma, beta, backend="auto", **kw),
                       want)
    # a tensor on the card: the kernels, never the composition
    calls = []
    _kernel_stand_ins(monkeypatch, calls)
    monkeypatch.setattr(norms, "group_norm_act", lambda *a, **k: calls.append("plain"))
    cuda_groupnorm.group_norm_act(x, gamma, beta, backend="auto", **kw)
    assert calls == ["k4"]


def _kernel_stand_ins(monkeypatch, calls):
    """Take the kernels' path on CPU tensors: the device test says 'the
    card', and K4 and K4B are stood in for by their plain versions (counted
    in ``calls``)."""
    def k4(x, gamma, beta, residual, *, num_groups, epsilon, relu):
        calls.append("k4")
        return norms.group_norm_act_plain(x, gamma, beta, residual, num_groups, epsilon, relu)

    def k4b(*a):
        calls.append("k4b")
        return norms.group_norm_act_bwd(*a)

    monkeypatch.setattr(cuda_groupnorm, "_on_card", lambda x: True)
    monkeypatch.setattr(cuda_groupnorm, "group_norm_act_cuda", k4)
    monkeypatch.setattr(cuda_groupnorm, "group_norm_act_bwd_cuda", k4b)


@pytest.mark.parametrize("picks", [True, False])
def test_auto_dispatch_follows_the_rule(monkeypatch, picks):
    """'auto' runs ``GroupNormAct`` (forward K4, backward K4B) on the card,
    and the composition on the CPU."""
    calls = []
    if picks:
        _kernel_stand_ins(monkeypatch, calls)
    applied = []
    orig = cuda_groupnorm.GroupNormAct.apply
    monkeypatch.setattr(cuda_groupnorm.GroupNormAct, "apply",
                        lambda *a: applied.append(1) or orig(*a))
    *_, tx, tg, tb, tres = _inputs(9, (2, 4, 4, 64), "float32", True)
    leaves = [t.requires_grad_() for t in (tx, tg, tb, tres)]
    out = cuda_groupnorm.group_norm_act(*leaves[:3], residual=leaves[3], relu=True,
                                        backend="auto")
    got = torch.autograd.grad(out.square().sum(), leaves)
    assert applied == ([1] if picks else []) and calls == (["k4", "k4b"] if picks else [])
    want_out = norms.group_norm_act(*leaves[:3], residual=leaves[3], relu=True)
    want = torch.autograd.grad(want_out.square().sum(), leaves)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def _gn_counts(fn):
    """The ``gn.kernel`` values ``fn`` counted inside one root span while a
    profiler recorded."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("step"):
            fn()
    counted = trace.counted()
    trace.clear()
    assert len(counted) == 1
    return counted[0].get("gn.kernel", [])


def test_gn_kernel_counter_records_each_call(monkeypatch):
    """``gn.kernel`` is 0 for a call on the composition (every backend on a
    CPU tensor) and 1 for one on the kernels; nothing without a profiler."""
    *_, tx, tg, tb, _ = _inputs(10, (1, 3, 3, 32), "float32", False)

    def calls():
        for backend in ("plain", "cuda", "auto", None):
            cuda_groupnorm.group_norm_act(tx, tg, tb, relu=True, backend=backend)

    assert _gn_counts(calls) == [0.0] * 4
    cuda_groupnorm.group_norm_act(tx, tg, tb, backend="auto")
    assert trace.counted() == []
    _kernel_stand_ins(monkeypatch, [])
    assert _gn_counts(calls) == [0.0, 1.0, 1.0, 1.0]


def test_gn_kernel_counter_over_the_stem():
    """One counted call per GroupNorm site of the stem, in one forward."""
    net = LiteResNet((1, 1, 1), dtype=torch.float32)
    init_params(net, torch.Generator().manual_seed(2))
    img = torch.from_numpy(np.random.default_rng(11).normal(0, 1, (1, 32, 48, 3))
                           .astype(np.float32))
    with torch.no_grad():
        assert _gn_counts(lambda: net(img)) == [0.0] * (3 + 4 * 3)


@pytest.mark.parametrize("deterministic", [True, False])
def test_vision_backbone_picks_the_path_backend(monkeypatch, deterministic):
    """VisionBackbone takes BACKEND on forward-only and training calls
    alike, for every one of the stem's GroupNorms; LiteResNet's
    channels-last GroupNorm inputs are contiguous, as K4 requires."""
    calls = []
    orig = cuda_groupnorm.GroupNormAct.apply

    def counting(x, *a):
        calls.append(x.is_contiguous())
        return orig(x, *a)

    monkeypatch.setattr(cuda_groupnorm.GroupNormAct, "apply", counting)
    hp = TransformerHParams(hidden_size=64, num_layers=1, num_heads=4,
                            intermediate_size=128, dtype=torch.float32,
                            hidden_dropout_prob=0.0)
    vb = VisionBackbone(hidden_size=64, resnet_layers=(1, 1, 1), dtype=torch.float32,
                        vit_hp=hp)
    init_params(vb, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 32, 48, 3))
                           .astype(np.float32))
    for backend, sites in (("cuda", 3 + 4 * 3), ("plain", 0)):  # stem + 3 blocks
        monkeypatch.setattr(cuda_groupnorm, "BACKEND", backend)
        calls.clear()
        with torch.no_grad():
            vb(img, attn_backend="plain", deterministic=deterministic)
        assert len(calls) == sites and all(calls)


def test_resnet_cuda_backend_matches_plain_on_cpu(monkeypatch):
    """The whole LiteResNet, fused path (plain version of K4) against the
    unfused one, fp32: the same function up to the order of fp32 sums."""
    net = LiteResNet((1, 1, 1), dtype=torch.float32)
    init_params(net, torch.Generator().manual_seed(1))
    img = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 32, 48, 3))
                           .astype(np.float32))
    with torch.no_grad():
        monkeypatch.setattr(cuda_groupnorm, "BACKEND", "cuda")
        a = net(img)
        monkeypatch.setattr(cuda_groupnorm, "BACKEND", "plain")
        b = net(img)
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


@pytest.mark.parametrize("hw,c,groups,elem", PLAN_SITES)
def test_bwd_launch_plan_covers_every_row_once(hw, c, groups, elem):
    """K4B's plan (two resident slabs, x and dy) at the same sites: every row
    once, in rank order, within SMEM_TARGET, the smallest cluster whose
    blocks hold their rows, else 16 that stream."""
    plan = cuda_groupnorm.launch_plan(hw, c, groups, elem, slabs=2)
    cs = plan["cluster"]
    assert plan["smem_bytes"] == cuda_groupnorm.smem_bytes(plan["res_rows"], c, groups, elem, 2)
    assert plan["smem_bytes"] <= cuda_groupnorm.SMEM_TARGET
    rows = []
    for rank in range(cs):
        res, streamed = _block_rows(plan, hw, rank)
        rows += list(res) + list(streamed)
    assert rows == list(range(hw))
    assert plan["res_rows"] == plan["rows_per_block"] or cs == cuda_groupnorm.MAX_CLUSTER
    fwd = cuda_groupnorm.launch_plan(hw, c, groups, elem)
    assert cs >= fwd["cluster"] and plan["res_rows"] <= fwd["res_rows"]


def _k4b_order(x, dy, out, gamma, mean, rstd, plan, groups):
    """K4B on one image x, dy, out [hw, c] fp32 in its order of sums: each
    block's channel partials over its rows, rank k's slice of channels
    summed over the ranks in order, its gamma-weighted group partials over
    the slice (channels in order), the ranks' group partials in order.
    Returns (dx, S1, S2)."""
    hw, c = x.shape
    cs, cpg = plan["cluster"], c // groups
    dyg = torch.where(out > 0, dy, torch.zeros(())) if out is not None else dy
    mean_c = mean.repeat_interleave(cpg)
    rstd_c = rstd.repeat_interleave(cpg)
    x_hat = (x - mean_c) * rstd_c
    parts = []
    for rank in range(cs):
        res, streamed = _block_rows(plan, hw, rank)
        rows = list(res) + list(streamed)
        parts.append((dyg[rows].sum(0), (dyg[rows] * x_hat[rows]).sum(0)))
    chunk = -(-c // cs)
    s1, s2 = torch.zeros(c), torch.zeros(c)
    gparts = []
    for k in range(cs):
        lo, hi = min(c, k * chunk), min(c, k * chunk + chunk)
        for p1, p2 in parts:
            s1[lo:hi] += p1[lo:hi]
            s2[lo:hi] += p2[lo:hi]
        g1, g2 = torch.zeros(groups), torch.zeros(groups)
        for ch in range(lo, hi):
            g1[ch // cpg] += gamma[ch] * s1[ch]
            g2[ch // cpg] += gamma[ch] * s2[ch]
        gparts.append((g1, g2))
    n = float(hw * cpg)
    m1 = sum(g for g, _ in gparts) / n
    m2 = sum(g for _, g in gparts) / n
    dx = rstd_c * ((dyg * gamma - m1.repeat_interleave(cpg)) - x_hat * m2.repeat_interleave(cpg))
    return dx, s1, s2


@pytest.mark.parametrize("hw,c,groups,target_rows,relu",
                         [(600, 64, 32, 20, True), (300, 40, 4, 12, True), (77, 32, 32, 3, False)])
def test_bwd_cluster_order_gives_the_plain_backward(monkeypatch, hw, c, groups, target_rows,
                                                    relu):
    """K4B's slices of channels (a group split across ranks where the
    cluster outnumbers the groups: 10 channels a group over slices of 3),
    its gamma-weighted group partials and its rank-order sums give the plain
    saved-stats backward (fp32 sums in another order)."""
    fixed = cuda_groupnorm.smem_bytes(0, c, groups, 4, 2)
    monkeypatch.setattr(cuda_groupnorm, "SMEM_TARGET", fixed + target_rows * 2 * c * 4)
    plan = cuda_groupnorm.launch_plan(hw, c, groups, 4, slabs=2)
    assert plan["cluster"] > 1
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(0.3, 1.0, (2, hw, c)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (2, hw, c)).astype(np.float32))
    gamma = torch.from_numpy(rng.normal(1, 0.1, c).astype(np.float32))
    out, mean, rstd = norms.group_norm_act_plain(x, gamma, torch.zeros(c), None, groups,
                                                 EPS, relu)
    saved = out if relu else None
    want_dx, want_dgamma, want_dbeta, _ = norms.group_norm_act_bwd(dy, x, gamma, mean, rstd,
                                                                   saved, False, groups)
    got = [_k4b_order(x[b], dy[b], None if saved is None else saved[b], gamma, mean[b],
                      rstd[b], plan, groups) for b in range(2)]
    dx = torch.stack([g[0] for g in got])
    torch.testing.assert_close(dx, want_dx, atol=1e-5 * want_dx.abs().max().item(), rtol=0)
    torch.testing.assert_close(got[0][1] + got[1][1], want_dbeta, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got[0][2] + got[1][2], want_dgamma, atol=1e-4, rtol=1e-5)
