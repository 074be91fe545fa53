"""Activation functions (counterpart of merlot_tpu/ops/activations.py).

MERLOT uses the exact-erf GELU everywhere, not the tanh approximation.
"""

import math

import torch


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU, computed op by op in the input dtype.

    The divisor is sqrt(2) rounded to x.dtype first, as the JAX version
    does with ``jnp.asarray(sqrt(2), x.dtype)``."""
    sqrt2 = float(torch.tensor(math.sqrt(2.0), dtype=x.dtype))
    cdf = 0.5 * (1.0 + torch.erf(x / sqrt2))
    return x * cdf
