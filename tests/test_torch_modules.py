"""merlot_tpu_torch nn modules vs merlot_tpu nn modules on the CPU.

Each flax module is initialised by JAX, its parameters are moved into the
port's module by ``convert.load_flax_params``, and both run the same
numpy-made inputs. Tolerances: fp32 atol/rtol 1e-4 on hidden states (the
matmul and conv sums run in another order in each framework, and the
errors compound through the stack); 2e-2 for the bf16 run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from merlot_tpu.nn import layers as jl
from merlot_tpu.nn import transformer as jt
from merlot_tpu.nn import vit as jv
from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.nn import layers as tl
from merlot_tpu_torch.nn import transformer as tt
from merlot_tpu_torch.nn import vit as tv

FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            flatten_dict(variables["params"], sep="/").items()}


def _port(jmod, tmod, *args, seed=0, **kw):
    """Init jmod on args, load its params into tmod; returns (variables, tmod)."""
    variables = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(seed), *a, **kw))(*args)
    load_flax_params(tmod, _flat(variables))
    return variables, tmod


def _close(j, t, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_tn(dtype):
    x = np.random.default_rng(0).standard_normal((3, 5, 16)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = jl.DenseTN(24, dtype=jd)
    v, tm = _port(jm, tl.DenseTN(16, 24, dtype=td), jnp.asarray(x))
    # give the bias a value, so that its rounding point is checked too
    v = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, v)
    load_flax_params(tm, _flat(v))
    out = tm(torch.from_numpy(x))
    assert out.dtype == td
    _close(jm.apply(v, jnp.asarray(x)), out, FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("cin,cout,k,s,ws,bias,padding", [
    (5, 8, 3, 2, True, False, None),
    (5, 8, 3, 1, True, False, None),
    (5, 8, 1, 1, True, False, None),
    (3, 16, 16, 16, False, True, "VALID"),
    (4, 6, 4, 1, False, False, None),   # even kernel: SAME pads asymmetrically
])
def test_ws_conv(cin, cout, k, s, ws, bias, padding):
    x = np.random.default_rng(1).standard_normal((2, 32, 32, cin)).astype(np.float32)
    jm = jl.WSConv(cout, k, strides=s, weight_standardization=ws, use_bias=bias,
                   padding=padding, dtype=jnp.float32)
    tm = tl.WSConv(cin, cout, k, strides=s, weight_standardization=ws,
                   use_bias=bias, padding=padding, dtype=torch.float32)
    v, tm = _port(jm, tm, jnp.asarray(x))
    _close(jm.apply(v, jnp.asarray(x)), tm(torch.from_numpy(x)), FP32)


@pytest.mark.parametrize("fn,shape,window,stride", [
    ("avg_pool_same", (2, 8, 12, 4), 2, 2),
    ("avg_pool_same", (2, 7, 9, 4), 3, 2),
    ("avg_pool_valid", (2, 8, 12, 4), 2, 2),
    ("avg_pool_valid", (2, 7, 9, 4), 3, 2),
])
def test_avg_pools(fn, shape, window, stride):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = getattr(jl, fn)(jnp.asarray(x), window, stride)
    _close(want, getattr(tl, fn)(torch.from_numpy(x), window, stride), FP32)


def test_lite_resnet():
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 32, 32, 3)).astype(np.float32)
    jm = jv.LiteResNet((1, 2), dtype=jnp.float32)
    v, tm = _port(jm, tv.LiteResNet((1, 2), dtype=torch.float32), jnp.asarray(x))
    _close(jax.jit(jm.apply)(v, jnp.asarray(x)), tm(torch.from_numpy(x)), FP32)


HP = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)


@pytest.mark.parametrize("resnet,uint8", [((), False), ((1, 1, 1), True)])
def test_vision_backbone(resnet, uint8):
    rng = np.random.default_rng(4)
    if uint8:
        img = rng.integers(0, 256, (2, 32, 64, 3)).astype(np.uint8)
    else:
        img = rng.uniform(0, 1, (2, 32, 64, 3)).astype(np.float32)
    jm = jv.VisionBackbone(hidden_size=32, resnet_layers=resnet, dtype=jnp.float32,
                           vit_hp=jt.TransformerHParams(**HP, dtype=jnp.float32))
    tm = tv.VisionBackbone(hidden_size=32, resnet_layers=resnet, dtype=torch.float32,
                           vit_hp=tt.TransformerHParams(**HP, dtype=torch.float32))
    v, tm = _port(jm, tm, jnp.asarray(img))
    want = jax.jit(jm.apply)(v, jnp.asarray(img))
    got = tm(torch.from_numpy(img))
    assert (got["num_h"], got["num_w"]) == (want["num_h"], want["num_w"]) == (1, 2)
    for key in ("cls", "seq"):
        _close(want[key], got[key], FP32)


def _encoder_inputs(seed, b=2, s=20, h=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[0, 15:] = False                           # padding: fully masked rows
    mask = (valid[:, None] & valid[:, :, None]).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("collect,num_layers", [
    ("none", None), ("colsum", None), ("colsum", 1), ("probs", None)])
def test_transformer_encoder(collect, num_layers):
    x, mask = _encoder_inputs(5)
    jm = jt.TransformerEncoder(jt.TransformerHParams(**HP, dtype=jnp.float32))
    tm = tt.TransformerEncoder(tt.TransformerHParams(**HP, dtype=torch.float32))
    v, tm = _port(jm, tm, jnp.asarray(x), jnp.asarray(mask))
    want = jax.jit(lambda v, x, m: jm.apply(v, x, m, collect=collect,
                                            num_layers=num_layers))(
        v, jnp.asarray(x), jnp.asarray(mask))
    got = tm(torch.from_numpy(x), torch.from_numpy(mask), collect=collect,
             num_layers=num_layers)
    assert set(got) == set(want)
    for key in want:
        _close(want[key], got[key], FP32)


@pytest.mark.parametrize("softmax_fp32", [True, False])
def test_transformer_encoder_bf16(softmax_fp32):
    x, mask = _encoder_inputs(6)
    jhp = jt.TransformerHParams(**HP, softmax_fp32=softmax_fp32)
    thp = tt.TransformerHParams(**HP, softmax_fp32=softmax_fp32)
    jm, tm = jt.TransformerEncoder(jhp), tt.TransformerEncoder(thp)
    v, tm = _port(jm, tm, jnp.asarray(x), jnp.asarray(mask))
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask))
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert got["hidden_state"].dtype == torch.bfloat16
    _close(want["hidden_state"], got["hidden_state"], BF16)


def test_transformer_encoder_kernel_backend_on_cpu():
    """The kernel backend keeps the multiplicative mask; on CPU tensors it
    runs the kernel's plain version and matches the plain backend."""
    x, mask = _encoder_inputs(7)
    hp = tt.TransformerHParams(**HP, dtype=torch.float32)
    tm = tt.TransformerEncoder(hp)
    tl.init_params(tm, torch.Generator().manual_seed(0))
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    a = tm(*args, attn_backend="cuda")["hidden_state"]
    b = tm(*args, attn_backend="plain")["hidden_state"]
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_init_matches_flax_initialisers():
    """Seeded init draws from the JAX package's distributions: truncated
    normal(0.02) dense kernels and fan-in variance-scaled conv kernels."""
    tm = tv.LiteResNet((1,), dtype=torch.float32)
    tl.init_params(tm, torch.Generator().manual_seed(0))
    w = tm.group1_block0.conv2.weight.detach()          # 3x3x64x64
    std = np.sqrt(1.0 / (9 * 64))
    assert abs(w.std().item() - std) < 0.05 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    d = tl.DenseTN(256, 256)
    tl.init_params(d, torch.Generator().manual_seed(0))
    assert d.weight.abs().max().item() <= 0.04 + 1e-7
    assert abs(d.weight.std().item() - 0.02 * 0.87962566103423978) < 1e-3
    assert torch.count_nonzero(d.bias) == 0
    hp = dataclasses.replace(tt.TransformerHParams(**HP), num_layers=1)
    e = tt.TransformerEncoder(hp)
    tl.init_params(e, torch.Generator().manual_seed(0))
    assert torch.equal(e.final_ln.gamma, torch.ones(32))
