"""The port's attention backward vs merlot_tpu's Pallas backward on the CPU.

``attention_bwd_plain`` (K2's plain version) is held against the TPU
kernel ``_flash_bwd_pallas`` run in interpret mode on the same q, k, v,
mask, dO and g_colsum; ``FlashAttention`` (autograd through the port,
which takes the plain versions on CPU tensors) against ``jax.grad``
through the Pallas ``flash_attention``, as tests/test_pallas_attention.py
runs it. Inputs are made by numpy from a seed. Cases: fp32 and bf16, both
softmax modes, masks with fully masked rows, a nonzero g_colsum, and
lengths that are not a multiple of any tile.

Tolerances, relative to the largest |grad| of the case (measured in
brackets): fp32 2e-6 (3.8e-7: the same fp32 formula summed in another
order). bf16 inputs round each grad to bf16 once: 4e-3, one bf16 ulp, in
the fp32-softmax mode (6.2e-5); in the bf16-softmax mode JAX's softmax
rounds exp and its sum to bf16 where torch's rounds only the result, so P
differs by a bf16 ulp here and there: 1.5e-2 (7.3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import merlot_tpu.ops.pallas_attention as pa
from merlot_tpu_torch.ops import cuda_attention as ca

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODES = [("float32", True), ("bfloat16", True), ("bfloat16", False)]
TOL = {("float32", True): 2e-6, ("bfloat16", True): 4e-3, ("bfloat16", False): 1.5e-2}
SHAPES = {  # b, sq, sk, h, d, mask kind, g_colsum
    "square_masked_gcol": (2, 37, 37, 2, 16, "padded", True),
    "cross_unmasked": (2, 20, 45, 3, 16, "none", False),
    "cross_masked": (1, 19, 33, 2, 32, "dense", True),
}


def _inputs(seed, b, sq, sk, h, d, mask_kind, gcol):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h * d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h * d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, sq, h * d)).astype(np.float32)
    mask = None
    if mask_kind == "padded":          # lang padding: fully masked rows
        valid = np.ones((b, sq), bool)
        valid[0, sq - 9:] = False
        valid[1, 5] = False
        mask = (valid[:, None] & valid[:, :, None]).astype(np.float32)
    elif mask_kind == "dense":
        mask = (rng.random((b, sq, sk)) < 0.7).astype(np.float32)
        mask[:, :, 0] = 1.0
        mask[0, 3] = 0.0
    gc = rng.standard_normal((b, sk)).astype(np.float32) if gcol else None
    return q, k, v, mask, g, gc


def _rel_close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: max err {err:.3g} of max |grad| > {tol}"


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_backward_matches_pallas_interpret(dtype, softmax_fp32, shape):
    b, sq, sk, h, d, mask_kind, gcol = SHAPES[shape]
    q, k, v, mask, g, gc = _inputs(0, b, sq, sk, h, d, mask_kind, gcol)
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = pa._flash_bwd_pallas(
            *(jnp.asarray(a, jdt) for a in (q, k, v)),
            None if mask is None else jnp.asarray(mask), jnp.asarray(g, jdt),
            None if gc is None else jnp.asarray(gc), num_heads=h,
            softmax_fp32=softmax_fp32, use_gcol=gcol)
    tdt = TORCH_DT[dtype]
    got = ca.attention_bwd_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(g).to(tdt), None if gc is None else torch.from_numpy(gc),
        num_heads=h, softmax_fp32=softmax_fp32)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt
        _rel_close(a.float().numpy(), w, TOL[(dtype, softmax_fp32)], name)
    if mask_kind == "padded":          # fully masked rows get exactly 0
        assert not got[0][0, sq - 9:].any() and not got[0][1, 5].any()


@pytest.mark.parametrize("dtype,softmax_fp32", MODES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_flash_attention_grad_matches_jax_grad(dtype, softmax_fp32, shape):
    b, sq, sk, h, d, mask_kind, gcol = SHAPES[shape]
    q, k, v, mask, g, gc = _inputs(1, b, sq, sk, h, d, mask_kind, gcol)
    collect = "colsum" if gcol else "none"
    jdt = jnp.dtype(dtype)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(q_, k_, v_):
        ctx, cs = pa.flash_attention(q_, k_, v_, jm, collect=collect,
                                     softmax_fp32=softmax_fp32)
        out = jnp.sum(ctx.astype(jnp.float32) * g.reshape(ctx.shape))
        return out if cs is None else out + jnp.sum(cs * gc)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(a.reshape(a.shape[0], a.shape[1], h, d), jdt)
              for a in (q, k, v)))

    tdt = TORCH_DT[dtype]
    tq, tk, tv = (torch.from_numpy(a.reshape(a.shape[0], a.shape[1], h, d))
                  .to(tdt).requires_grad_() for a in (q, k, v))
    ca.launches = ca.bwd_launches = 0
    ctx, cs = ca.flash_attention(tq, tk, tv,
                                 None if mask is None else torch.from_numpy(mask),
                                 collect=collect, softmax_fp32=softmax_fp32)
    loss = (ctx.float() * torch.from_numpy(g).reshape(ctx.shape)).sum()
    if cs is not None:
        loss = loss + (cs * torch.from_numpy(gc)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    assert ca.launches == ca.bwd_launches == 0   # CPU tensors never reach a kernel
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt
        _rel_close(a.float().numpy(), w, TOL[(dtype, softmax_fp32)], name)


def test_unused_colsum_gets_no_cotangent():
    """A colsum that feeds nothing differentiable (the lang tower's, which
    only ranks tokens for masking) gives the same grads as no colsum."""
    q, k, v, mask, g, _ = _inputs(2, 2, 37, 37, 2, 16, "padded", False)
    grads = []
    for collect in ("none", "colsum"):
        tq, tk, tv = (torch.from_numpy(a.reshape(2, 37, 2, 16)).requires_grad_()
                      for a in (q, k, v))
        ctx, cs = ca.flash_attention(tq, tk, tv, torch.from_numpy(mask),
                                     collect=collect, softmax_fp32=True)
        if cs is not None:
            cs = cs.detach()
        loss = (ctx * torch.from_numpy(g).reshape(ctx.shape)).sum()
        grads.append(torch.autograd.grad(loss, (tq, tk, tv)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, _, g, _ = _inputs(3, 1, 8, 8, 2, 16, "none", False)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    with pytest.raises(ValueError, match="CUDA"):
        ca.attention_bwd_cuda(t[0], t[1], t[2], None, t[3], None, num_heads=2,
                              softmax_fp32=True)
