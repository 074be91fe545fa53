"""Small building blocks with the reference's numerics (counterpart of
merlot_tpu/nn/layers.py).

Parameters are stored fp32 and cast to the compute dtype at use. Activations
of the vision stem are channels-last (NHWC), as in the JAX package; a
convolution hands torch an NCHW view of the same memory (channels_last), so
no copy is made at the boundary.

Every module here initialises its own parameters in ``init_weights(gen)``
with the JAX package's initialisers, drawing from an explicit
``torch.Generator``; ``init_params`` walks a module tree and calls them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from merlot_tpu_torch.ops import cuda_groupnorm, norms

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    """flax ``truncated_normal(stddev, lower=-2, upper=2)``: a normal of std
    ``std`` truncated at two of its standard deviations."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                     generator=gen)


def variance_scaling_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``variance_scaling(1.0, 'fan_in', 'truncated_normal')``."""
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / _TRUNC_STD, gen)


def init_params(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise every parameter of a module tree, in module order."""
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)


def dropout(x: torch.Tensor, rate: float, *, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate), in x's dtype; the identity when
    ``deterministic`` or ``rate == 0``. The keep mask is drawn from
    ``generator`` (the device's default generator when None)."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def _param(*shape, device=None) -> nn.Parameter:
    """An fp32 parameter, uninitialised until ``init_params`` or a load."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class DenseTN(nn.Module):
    """Dense with truncated-normal(0.02) weight, fp32 params, compute in
    ``dtype``; the bias is added after the product is rounded to ``dtype``.
    ``weight`` is [out, in] (the JAX kernel [in, out] transposed)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 initializer_range: float = 0.02, device=None):
        super().__init__()
        self.dtype = dtype
        self.initializer_range = initializer_range
        self.weight = _param(features, in_features, device=device)
        self.bias = _param(features, device=device)

    def init_weights(self, gen):
        trunc_normal_(self.weight, self.initializer_range, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, eps 1e-5, output in the input dtype."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = _param(dim, device=device)
        self.beta = _param(dim, device=device)

    def init_weights(self, gen):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norms.layer_norm(x, self.gamma, self.beta)


class GroupNorm(nn.Module):
    """GroupNorm(32, eps 1e-4) with one-pass fp32 statistics over NHWC
    input; ``residual`` and ``relu`` fold the shortcut add and activation
    that follow it. ``backend`` picks the implementation
    (``ops.cuda_groupnorm.group_norm_act``): 'plain', the unfused
    composition, or 'cuda', the fused kernel K4; None takes
    ``cuda_groupnorm.BACKEND`` ('plain' unless set)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.gamma = _param(channels, device=device)
        self.beta = _param(channels, device=device)

    def init_weights(self, gen):
        with torch.no_grad():
            self.gamma.fill_(1.0)
            self.beta.zero_()

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                relu: bool = False, backend: Optional[str] = None) -> torch.Tensor:
        return cuda_groupnorm.group_norm_act(x, self.gamma, self.beta,
                                             residual=residual, relu=relu,
                                             backend=backend)


def _same_pads(size: int, k: int, stride: int):
    """TF 'SAME' padding (begin, end) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class WSConv(nn.Module):
    """NHWC conv with optional weight standardization and fixed padding:
    stride > 1 pads (k-1)//2 before and the rest after, then runs VALID;
    stride 1 runs SAME. The kernel is standardized in fp32, then cast to the
    compute dtype. ``weight`` is OIHW (the JAX HWIO kernel permuted)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 strides: int = 1, weight_standardization: bool = True,
                 use_bias: bool = False, padding: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if padding not in (None, "VALID", "SAME"):
            raise ValueError(f"bad padding={padding}")
        self.kernel_size = kernel_size
        self.strides = strides
        self.weight_standardization = weight_standardization
        self.padding = padding
        self.dtype = dtype
        self.weight = _param(features, in_channels, kernel_size, kernel_size,
                             device=device)
        self.bias = _param(features, device=device) if use_bias else None

    def init_weights(self, gen):
        fan_in = self.weight.shape[1] * self.kernel_size ** 2
        variance_scaling_(self.weight, fan_in, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.strides
        w = self.weight
        if self.weight_standardization:
            w = norms.standardize_kernel(w)
        if self.padding == "VALID":
            pads = ((0, 0), (0, 0))
        elif self.padding is None and s > 1:
            pads = (((k - 1) // 2, k - 1 - (k - 1) // 2),) * 2
        else:  # SAME
            pads = (_same_pads(x.shape[1], k, s), _same_pads(x.shape[2], k, s))
        xc = x.to(self.dtype).permute(0, 3, 1, 2)      # NCHW view, channels_last
        (ph0, ph1), (pw0, pw1) = pads
        if ph0 == ph1 and pw0 == pw1:
            conv_pad = (ph0, pw0)
        else:
            xc = F.pad(xc, (pw0, pw1, ph0, ph1))
            conv_pad = (0, 0)
        w = w.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(xc, w, stride=s, padding=conv_pad).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def _avg_pool_reshape(x: torch.Tensor, window: int) -> torch.Tensor:
    """window == stride pooling on evenly divisible dims. A 2x2 window
    averages in the input dtype (as tf.nn.avg_pool does in bf16); wider
    windows accumulate in fp32."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // window, window, w // window, window, c)
    if window <= 2:
        return y.mean(dim=(2, 4))
    return y.mean(dim=(2, 4), dtype=torch.float32).to(x.dtype)


def _window_sum(x: torch.Tensor, window: int, stride: int, pads) -> torch.Tensor:
    xc = x.permute(0, 3, 1, 2)
    (ph0, ph1), (pw0, pw1) = pads
    xc = F.pad(xc, (pw0, pw1, ph0, ph1))
    return F.avg_pool2d(xc, window, stride, divisor_override=1).permute(0, 2, 3, 1)


def avg_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """tf.nn.avg_pool2d(padding='SAME') on NHWC, with correct edge counts."""
    _, h, w, _ = x.shape
    if window == stride and h % window == 0 and w % window == 0:
        return _avg_pool_reshape(x, window)  # SAME == VALID when divisible
    pads = (_same_pads(h, window, stride), _same_pads(w, window, stride))
    summed = _window_sum(x, window, stride, pads)
    counts = _window_sum(torch.ones_like(x[:1, :, :, :1]), window, stride, pads)
    return summed / counts


def avg_pool_valid(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    _, h, w, _ = x.shape
    if window == stride and h % window == 0 and w % window == 0:
        return _avg_pool_reshape(x, window)
    summed = _window_sum(x, window, stride, ((0, 0), (0, 0)))
    return summed / (window * window)
