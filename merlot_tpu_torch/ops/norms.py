"""Normalization ops, forward only (counterpart of merlot_tpu/ops/norms.py).

Statistics in fp32, output in the input dtype:
  * layer_norm — eps 1e-5, the two-term ``x*s - mean*s + beta`` form;
  * group_norm — channels-last input, one-pass ``E[x^2] - E[x]^2``
    variance, eps 1e-4 in the ResNet;
  * standardize_kernel — weight standardization of a conv kernel, eps 1e-5.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 statistics, output in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + epsilon) * gamma.float()
    out = xf * scale - mean * scale + beta.float()
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int = 32, epsilon: float = 1e-4) -> torch.Tensor:
    """GroupNorm over channels-last [B, ..., C] input; fp32 statistics and
    the one-pass variance E[x^2] - E[x]^2 (the JAX package's and the
    reference's default, ``mean_close_to_zero=True``)."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"{c} channels not divisible into {num_groups} groups")
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    xn = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    out = xn * gamma.float() + beta.float()
    return out.to(x.dtype)


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   *, residual: torch.Tensor | None = None,
                   num_groups: int = 32, epsilon: float = 1e-4,
                   relu: bool = False) -> torch.Tensor:
    """``relu(group_norm(x) + residual)`` as the unfused composition — the
    form the JAX package runs (``pallas_groupnorm.BACKEND = 'xla'``)."""
    out = group_norm(x, gamma, beta, num_groups, epsilon)
    if residual is not None:
        out = out + residual
    if relu:
        out = torch.relu(out)
    return out


def standardize_kernel(kernel: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Weight standardization of an OIHW conv kernel: each output filter
    to zero mean and unit variance over its receptive field, in fp32."""
    kf = kernel.float()
    mean = kf.mean(dim=(1, 2, 3), keepdim=True)
    var = (kf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (kf - mean) * torch.rsqrt(var + epsilon)
