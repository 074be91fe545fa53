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
