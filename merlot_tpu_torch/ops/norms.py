"""Normalization ops (counterpart of merlot_tpu/ops/norms.py).

Statistics in fp32, output in the input dtype:
  * layer_norm — eps 1e-5, the two-term ``x*s - mean*s + beta`` form;
  * group_norm — channels-last input, one-pass ``E[x^2] - E[x]^2``
    variance, eps 1e-4 in the ResNet;
  * standardize_kernel — weight standardization of a conv kernel, eps 1e-5.

Beside them, the plain versions of the two fused norm kernels, in the
kernels' operation order: ``group_norm_act_plain`` and its saved-stats
backward ``group_norm_act_bwd`` (K4, merlot_tpu/ops/pallas_groupnorm.py),
and ``ln_matmul_plain`` (K5, merlot_tpu/ops/pallas_ln_matmul.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


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


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         residual: Optional[torch.Tensor], num_groups: int,
                         epsilon: float, relu: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's function in plain PyTorch (``_gn_kernel``): fp32 channel sums
    s1, s2 over the spatial axes folded into groups, mean = s1/n, var =
    s2/n - mean^2, rstd = rsqrt(var + eps); out = (x - mean)*rstd*gamma +
    beta cast to x.dtype, then the residual add and ReLU in x.dtype.
    x, residual [B, ..., C] channels-last. Returns (out, mean [B, G] fp32,
    rstd [B, G] fp32)."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"{c} channels not divisible into {num_groups} groups")
    cpg = c // num_groups
    xf = x.float().reshape(b, -1, c)
    n = xf.shape[1] * cpg
    s1 = xf.sum(dim=1).reshape(b, num_groups, cpg).sum(dim=-1)
    s2 = xf.square().sum(dim=1).reshape(b, num_groups, cpg).sum(dim=-1)
    mean = s1 / n
    rstd = torch.rsqrt(s2 / n - mean.square() + epsilon)
    mean_c = mean.repeat_interleave(cpg, dim=1)[:, None]
    rstd_c = rstd.repeat_interleave(cpg, dim=1)[:, None]
    out = ((xf - mean_c) * rstd_c * gamma.float() + beta.float()).to(x.dtype)
    if residual is not None:
        out = out + residual.reshape(out.shape)
    if relu:
        out = torch.relu(out)
    return out.reshape(x.shape), mean, rstd


def group_norm_act_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor,
                       out: Optional[torch.Tensor], has_residual: bool,
                       num_groups: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """The backward of ``group_norm_act_plain`` from its saved statistics
    (``_gn_act_bwd``): the ReLU mask from the saved output (``out`` is None
    without ReLU), x_hat recomputed from (x, mean, rstd). Returns (dx in
    x.dtype, dgamma fp32, dbeta fp32, dresidual in dy.dtype or None)."""
    if out is not None:
        dy = torch.where(out > 0, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))
    dres = dy if has_residual else None
    b, c = x.shape[0], x.shape[-1]
    shape4 = (b, -1, num_groups, c // num_groups)
    mean4 = mean.reshape(b, 1, num_groups, 1)
    rstd4 = rstd.reshape(b, 1, num_groups, 1)
    x_hat = (x.float().reshape(shape4) - mean4) * rstd4
    dyg = dy.float().reshape(shape4)
    dgamma = (dyg * x_hat).sum(dim=(0, 1)).reshape(c)
    dbeta = dyg.sum(dim=(0, 1)).reshape(c)
    dx_hat = dyg * gamma.float().reshape(1, 1, num_groups, -1)
    m1 = dx_hat.mean(dim=(1, 3), keepdim=True)
    m2 = (dx_hat * x_hat).mean(dim=(1, 3), keepdim=True)
    dx = (rstd4 * (dx_hat - m1 - x_hat * m2)).reshape(x.shape).to(x.dtype)
    return dx, dgamma, dbeta, dres


def ln_matmul_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                    epsilon: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """K5's function in plain PyTorch (the unfused math of ``ln_matmul``):
    z = layer_norm(x) in x.dtype, then for each consumer j
    ``linear(z, W_j) + b_j`` with W_j [N, K] and b_j [N] cast to x.dtype
    (the product rounded to x.dtype before the bias add)."""
    z = layer_norm(x, gamma, beta, epsilon)
    cdtype = x.dtype
    return tuple(F.linear(z, w.to(cdtype)) + b.to(cdtype)
                 for w, b in zip(weights, biases))


def standardize_kernel(kernel: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Weight standardization of an OIHW conv kernel: each output filter
    to zero mean and unit variance over its receptive field, in fp32."""
    kf = kernel.float()
    mean = kf.mean(dim=(1, 2, 3), keepdim=True)
    var = (kf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (kf - mean) * torch.rsqrt(var + epsilon)
