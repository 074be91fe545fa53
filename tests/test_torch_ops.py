"""merlot_tpu_torch ops vs merlot_tpu ops on the CPU.

Inputs are made by numpy from a seed and fed to both packages.
Tolerances: fp32 atol/rtol 1e-5 for single ops (the same formula in both
frameworks; only the summation order of the reductions differs); bf16
2e-2 (each package rounds every op's output to bf16, XLA sometimes fusing
the intermediate roundings away).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlot_tpu.ops import activations as jax_act
from merlot_tpu.ops import norms as jax_norms
from merlot_tpu.ops import pallas_groupnorm as jax_gn
from merlot_tpu_torch.ops import activations, norms

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(x: np.ndarray, dtype: str):
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(TORCH_DT[dtype])


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(t.float()), np.asarray(j, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = np.random.default_rng(0).standard_normal((4, 33)).astype(np.float32) * 3
    jx, tx = _both(x, dtype)
    _close(jax_act.gelu(jx), activations.gelu(tx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 48)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jx, tx = _both(x, dtype)
    out = norms.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert out.dtype == TORCH_DT[dtype]
    _close(jax_norms.layer_norm(jx, jnp.asarray(g), jnp.asarray(b)), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual,relu", [(False, False), (True, True)])
def test_group_norm_act_matches_jax(dtype, residual, relu):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32)
    r = rng.standard_normal((2, 6, 5, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jx, tx = _both(x, dtype)
    jr, tr = _both(r, dtype)
    want = jax_gn.group_norm_act(jx, jnp.asarray(g), jnp.asarray(b),
                                 residual=jr if residual else None,
                                 relu=relu, backend="xla")
    got = norms.group_norm_act(tx, torch.from_numpy(g), torch.from_numpy(b),
                               residual=tr if residual else None, relu=relu)
    _close(want, got, dtype)


def test_standardize_kernel_matches_jax():
    k = np.random.default_rng(4).standard_normal((3, 3, 5, 7)).astype(np.float32)
    want = jax_norms.standardize_kernel(jnp.asarray(k))            # HWIO
    got = norms.standardize_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    _close(jnp.transpose(want, (3, 2, 0, 1)), got, "float32")
