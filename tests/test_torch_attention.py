"""merlot_tpu_torch attention vs merlot_tpu attention on the CPU.

The port's ``attention_core`` (the plain path on the CPU) is held against
JAX ``_xla_attention``, and its kernel backend — which on CPU tensors takes
the kernel's plain version, ``flash_attention_plain`` — against the Pallas
kernel run in interpret mode, as tests/test_pallas_attention.py runs it.
Inputs are made by numpy from a seed.

Tolerances: fp32 inputs 2e-5 (same formula, different summation order);
bf16 inputs 2e-2 on ctx (both round the probs to bf16 before the value
product, so one-ulp flips of a prob move ctx by up to ~1e-2) and 2e-3 on
colsum (an fp32 sum of many bf16-rounded probs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlot_tpu.ops.attention import _xla_attention
from merlot_tpu.ops.pallas_attention import flash_attention as jax_flash
from merlot_tpu_torch.ops import cuda_attention
from merlot_tpu_torch.ops.attention import attention_core

DT_CASES = [("float32", True), ("bfloat16", True), ("bfloat16", False)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CTX_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
COLSUM_TOL = {"float32": 2e-5, "bfloat16": 2e-3}


def _inputs(seed, sq, sk, mask_kind, dtype, b=2, h=2, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for s in (sq, sk, sk))
    mask = None
    if mask_kind != "none":
        mask = (rng.random((b, sq, sk)) < 0.7).astype(np.float32)
        mask[:, :, 0] = 1.0
        if mask_kind == "fully_masked_rows":
            mask[0, 3] = 0.0
            mask[1, 5:7] = 0.0
    jx = [jnp.asarray(a, dtype) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, k, v)]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    return jx, jm, tx, tm


def _check(j_ctx, j_extra, t_ctx, t_extra, dtype):
    tol = CTX_TOL[dtype]
    np.testing.assert_allclose(np.asarray(t_ctx.float()),
                               np.asarray(j_ctx, np.float32), atol=tol, rtol=tol)
    if j_extra is None:
        assert t_extra is None
    else:
        tol = COLSUM_TOL[dtype]
        np.testing.assert_allclose(t_extra.numpy(), np.asarray(j_extra),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,softmax_fp32", DT_CASES)
@pytest.mark.parametrize("mask_kind", ["none", "dense", "fully_masked_rows"])
@pytest.mark.parametrize("collect", ["none", "colsum", "probs"])
@pytest.mark.parametrize("sq,sk", [(24, 24), (16, 40)])
def test_plain_attention_matches_xla(dtype, softmax_fp32, mask_kind, collect, sq, sk):
    jx, jm, tx, tm = _inputs(0, sq, sk, mask_kind, dtype)
    fn = jax.jit(lambda q, k, v, m: _xla_attention(
        q, k, v, m, collect=collect, softmax_fp32=softmax_fp32))
    j_ctx, j_extra = fn(*jx, jm)
    t_ctx, t_extra = attention_core(*tx, tm, collect=collect, backend="plain",
                                    softmax_fp32=softmax_fp32)
    assert t_ctx.dtype == TORCH_DT[dtype]
    _check(j_ctx, j_extra, t_ctx, t_extra, dtype)


@pytest.mark.parametrize("dtype,softmax_fp32", DT_CASES)
def test_bias_mask_matches_xla(dtype, softmax_fp32):
    """JAX's encoder turns the mask into an additive bias on the CPU; the
    port keeps only the multiplicative form, which must give the same
    results, fully masked rows included."""
    jx, jm, tx, tm = _inputs(1, 24, 24, "fully_masked_rows", dtype)
    sm = jnp.float32 if softmax_fp32 else jnp.bfloat16
    j_ctx, _ = _xla_attention(*jx, (-1e10 * (1.0 - jm)).astype(sm),
                              collect="none", softmax_fp32=softmax_fp32,
                              mask_format="bias")
    t_ctx, _ = attention_core(*tx, tm, backend="plain", softmax_fp32=softmax_fp32)
    _check(j_ctx, None, t_ctx, None, dtype)


@pytest.mark.parametrize("dtype,softmax_fp32", DT_CASES)
@pytest.mark.parametrize("mask_kind,collect,sq,sk", [
    ("none", "none", 16, 40),
    ("dense", "colsum", 24, 24),
    ("fully_masked_rows", "colsum", 16, 40),
])
def test_kernel_backend_matches_pallas_interpret(dtype, softmax_fp32, mask_kind,
                                                 collect, sq, sk):
    jx, jm, tx, tm = _inputs(2, sq, sk, mask_kind, dtype)
    with pltpu.force_tpu_interpret_mode():
        j_ctx, j_extra = jax_flash(*jx, jm, collect=collect,
                                   softmax_fp32=softmax_fp32)
    cuda_attention.launches = 0
    t_ctx, t_extra = attention_core(*tx, tm, collect=collect, backend="cuda",
                                    softmax_fp32=softmax_fp32)
    _check(j_ctx, j_extra, t_ctx, t_extra, dtype)
    assert cuda_attention.launches == 0  # CPU tensors never reach the kernel


def test_fully_masked_row_is_uniform_over_true_length():
    _, _, (q, k, v), m = _inputs(3, 16, 37, "fully_masked_rows", "float32")
    ctx, _ = cuda_attention.flash_attention(q, k, v, m, softmax_fp32=True)
    torch.testing.assert_close(ctx[0, 3], v[0].mean(dim=0), atol=1e-6, rtol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, _, (q, k, v), _ = _inputs(4, 8, 8, "none", "float32")
    b, s, h, d = q.shape
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.attention_fwd_cuda(
            q.reshape(b, s, h * d), k.reshape(b, s, h * d), v.reshape(b, s, h * d),
            None, num_heads=h, softmax_fp32=True, collect_colsum=False)


@pytest.mark.parametrize("sq,sk,d,dtype,supported", [
    (2048, 2048, 128, torch.bfloat16, True),
    (2048, 2048, 128, torch.float32, True),
    (578, 578, 64, torch.bfloat16, True),
    (2049, 16, 64, torch.bfloat16, False),
    (16, 16, 129, torch.float32, False),
    (16, 16, 40, torch.bfloat16, False),    # bf16 head dim not a multiple of 16
    (16, 16, 40, torch.float32, True),
    (16, 16, 64, torch.float16, False),
])
def test_kernel_supported(sq, sk, d, dtype, supported):
    assert cuda_attention.kernel_supported(sq, sk, d, dtype) is supported


@pytest.mark.parametrize("d,dtype", [(144, "float32"), (40, "bfloat16")])
def test_dispatch_rule(d, dtype):
    # a shape or dtype the kernels do not take raises on the kernel backend
    # (no silent plain path); 'auto' is the plain path
    _, _, tx, tm = _inputs(5, 8, 8, "dense", dtype, d=d)
    with pytest.raises(ValueError, match=f"d={d}"):
        attention_core(*tx, tm, backend="cuda")
    a, _ = attention_core(*tx, tm, backend="auto")
    b, _ = attention_core(*tx, tm, backend="plain")
    torch.testing.assert_close(a, b)


@pytest.mark.parametrize("sq,sk,d,dtype", [(8, 2049, 16, torch.float32),
                                           (8, 8, 8, torch.bfloat16)])
def test_cuda_backend_refuses_unsupported_shapes(sq, sk, d, dtype):
    """attention_core(backend='cuda') names the shape it refuses; the
    probs collection still takes the plain path by design."""
    g = torch.Generator().manual_seed(6)
    q = torch.randn((1, sq, 2, d), generator=g).to(dtype)
    k, v = (torch.randn((1, sk, 2, d), generator=g).to(dtype) for _ in range(2))
    with pytest.raises(ValueError, match=f"Sq={sq} Sk={sk} d={d}"):
        attention_core(q, k, v, None, backend="cuda")
    _, probs = attention_core(q, k, v, None, backend="cuda", collect="probs")
    assert probs.shape == (1, sq, sk)
