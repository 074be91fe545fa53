"""Plain PyTorch building blocks of the MERLOT and Grover references.

A frozen copy of the port's plain paths (its layers, norms, plain
attention and transformer encoder), with no kernel, no tensor or data
parallelism and no fused norms. Everything is computed and stored in
float32; a ``Precision`` rounds the results at the sites where the
configuration computes in its low type (bf16), to bf16 (a witness) or to
float8 (the control: e4m3 forward, e5m2 backward).

The hidden dropout draws ``torch.rand(x.shape, generator)`` at the same
sites and in the same order as the port, so the same generator seed gives
the same masks. A checkpointed layer (``remat``) saves the generator's
state before its forward and sets it back for the recompute.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

MASK_PENALTY = 1e10
# float8 as fp8 training stores it: values in e4m3, gradients in e5m2, each
# tensor under one scale (its largest magnitude to the format's largest)
FP8 = {"forward": (torch.float8_e4m3fn, 448.0), "backward": (torch.float8_e5m2, 57344.0)}


def _round(t: torch.Tensor, fmt: str, direction: str) -> torch.Tensor:
    """``t`` rounded to ``fmt`` and back to float32: bf16, or float8 (e4m3
    forward, e5m2 backward) under one scale for the tensor."""
    t = t.detach().float()
    if fmt == "bf16":
        return t.to(torch.bfloat16).float()
    dtype, largest = FP8[direction]
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).float() * scale


class _Rounded(torch.autograd.Function):
    """Rounds the value forward and its gradient backward."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return _round(t, fmt, "forward")

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt, "backward"), None


class Precision:
    """Where the configuration computes in its low type (bf16 products,
    activations, softmax), the reference rounds each result, and its
    gradient, to ``fmt``: 'fp32' (no rounding: the reference), 'bf16' (the
    configuration's own type: a witness of how far bf16 rounding moves
    the numbers) or 'fp8' (the control: the reference computed in the
    precision below bf16, as fp8 training does: e4m3 values, e5m2
    gradients). Everything is stored in float32."""

    def __init__(self, fmt: str = "fp32"):
        if fmt not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {fmt!r}")
        self.fmt = fmt

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.fmt == "fp32" else _Rounded.apply(t, self.fmt)

    @property
    def low(self) -> bool:
        return self.fmt != "fp32"


FP32 = Precision("fp32")


def layer_norm(x, gamma, beta, epsilon: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + epsilon) * gamma.float()
    return (xf * scale - mean * scale + beta.float()).to(x.dtype)


def group_norm(x, gamma, beta, num_groups: int = 32, epsilon: float = 1e-4):
    """Channels-last GroupNorm, one-pass variance E[x^2] - E[x]^2."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    xn = ((xf - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return (xn * gamma.float() + beta.float()).to(x.dtype)


def standardize_kernel(kernel, epsilon: float = 1e-5):
    kf = kernel.float()
    mean = kf.mean(dim=(1, 2, 3), keepdim=True)
    var = (kf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (kf - mean) * torch.rsqrt(var + epsilon)


def gelu(x, p: Precision = FP32):
    """Exact-erf GELU; at a low-precision site the divisor is sqrt(2)
    rounded to bf16, as the port rounds it to the compute type."""
    sqrt2 = float(torch.tensor(math.sqrt(2.0),
                               dtype=torch.bfloat16 if p.low else torch.float32))
    return p(x * (0.5 * (1.0 + torch.erf(x / sqrt2))))


def cross_entropy(logits, labels):
    return -torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[..., None])[..., 0]


def dropout(x, rate: float, *, deterministic: bool, generator=None, p: Precision = FP32):
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, p(x / (1.0 - rate)), torch.zeros((), device=x.device))


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


class DenseTN(nn.Module):
    """y = x W^T + b; at a low-precision site (``p``) both operands, the
    product and the sum are rounded (float32 accumulation)."""

    def __init__(self, in_features, features, p: Precision = FP32, device=None):
        super().__init__()
        self.p = p
        self.weight = _param(features, in_features, device=device)
        self.bias = _param(features, device=device)

    def forward(self, x):
        p = self.p
        return p(p(F.linear(p(x), p(self.weight))) + p(self.bias))


class LayerNorm(nn.Module):
    """fp32 statistics; the output rounded by ``p`` (the port's LN returns
    its input's type)."""

    def __init__(self, dim, device=None, p: Precision = FP32):
        super().__init__()
        self.p = p
        self.gamma = _param(dim, device=device)
        self.beta = _param(dim, device=device)

    def forward(self, x):
        return self.p(layer_norm(x, self.gamma, self.beta))


class GroupNorm(nn.Module):
    def __init__(self, channels, device=None, p: Precision = FP32):
        super().__init__()
        self.p = p
        self.gamma = _param(channels, device=device)
        self.beta = _param(channels, device=device)

    def forward(self, x, residual=None, relu=False):
        out = self.p(group_norm(x, self.gamma, self.beta))
        if residual is not None:
            out = self.p(out + residual)
        return torch.relu(out) if relu else out


def _same_pads(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class WSConv(nn.Module):
    """NHWC conv, optional weight standardization; stride > 1 pads
    (k-1)//2 before and the rest after, stride 1 runs SAME. At a
    low-precision site the operands, the product and the bias sum are
    rounded."""

    def __init__(self, cin, features, k, strides=1, weight_standardization=True,
                 use_bias=False, padding=None, p: Precision = FP32, device=None):
        super().__init__()
        self.k, self.s, self.ws, self.padding, self.p = (
            k, strides, weight_standardization, padding, p)
        self.weight = _param(features, cin, k, k, device=device)
        self.bias = _param(features, device=device) if use_bias else None

    def forward(self, x):
        k, s, p = self.k, self.s, self.p
        w = standardize_kernel(self.weight) if self.ws else self.weight
        if self.padding == "VALID":
            pads = ((0, 0), (0, 0))
        elif self.padding is None and s > 1:
            pads = (((k - 1) // 2, k - 1 - (k - 1) // 2),) * 2
        else:
            pads = (_same_pads(x.shape[1], k, s), _same_pads(x.shape[2], k, s))
        (ph0, ph1), (pw0, pw1) = pads
        xc = F.pad(p(x).permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
        y = p(F.conv2d(xc, p(w), stride=s).permute(0, 2, 3, 1))
        return y if self.bias is None else p(y + p(self.bias))


def _window_sum(x, window, stride, pads):
    (ph0, ph1), (pw0, pw1) = pads
    xc = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    return F.avg_pool2d(xc, window, stride, divisor_override=1).permute(0, 2, 3, 1)


def avg_pool_same(x, window, stride, p: Precision = FP32):
    _, h, w, _ = x.shape
    if window == stride and h % window == 0 and w % window == 0:
        b, _, _, c = x.shape
        return p(x.reshape(b, h // window, window, w // window, window, c).mean(dim=(2, 4)))
    pads = (_same_pads(h, window, stride), _same_pads(w, window, stride))
    counts = _window_sum(torch.ones_like(x[:1, :, :, :1]), window, stride, pads)
    return p(_window_sum(x, window, stride, pads) / counts)


def avg_pool_valid(x, window, stride, p: Precision = FP32):
    _, h, w, _ = x.shape
    if window == stride and h % window == 0 and w % window == 0:
        return avg_pool_same(x, window, stride, p)
    return p(_window_sum(x, window, stride, ((0, 0), (0, 0))) / (window * window))


def plain_attention(q, k, v, mask, *, collect="none", p: Precision = FP32, p_sm: Precision = FP32):
    """q [B, Sq, H, D], k, v [B, Sk, H, D], mask [B or 1, Sq, Sk] (1 =
    attend) or None. Scores and probs are rounded by ``p_sm`` (the
    softmax's type), the context by ``p`` (q's). Returns (ctx [B, Sq, H,
    D], colsum [B, Sk] or None)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = p_sm(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale)
    if mask is not None:
        m = mask.float()[:, None]
        scores = p_sm(scores * m - MASK_PENALTY * (1 - m))
    probs = p_sm(torch.softmax(scores, dim=-1))
    extra = probs.sum(dim=(1, 2)) / probs.shape[1] if collect == "colsum" else None
    ctx = p(torch.einsum("bhqk,bkhd->bqhd", p(probs), v))
    return ctx, extra


@dataclass(frozen=True)
class EncoderHParams:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    p: Precision = FP32         # the compute type's sites
    p_sm: Precision = FP32      # the softmax's
    remat: bool = False


class TransformerLayer(nn.Module):
    """Pre-LN layer: x + drop(attn(LN x)), then + drop(mlp(LN x))."""

    def __init__(self, hp: EncoderHParams, device=None):
        super().__init__()
        self.hp = hp
        h, p = hp.hidden_size, hp.p
        dense = lambda i, o: DenseTN(i, o, p, device)  # noqa: E731
        self.attn_ln = LayerNorm(h, device, p)
        self.attention = nn.Module()
        for name in ("query", "key", "value", "out_proj"):
            self.attention.add_module(name, dense(h, h))
        self.mlp_ln = LayerNorm(h, device, p)
        self.mlp = nn.Module()
        self.mlp.intermediate = dense(h, hp.intermediate_size)
        self.mlp.output = dense(hp.intermediate_size, h)

    def forward(self, x, mask, collect, deterministic, generator):
        hp, a, p = self.hp, self.attention, self.hp.p
        drop = dict(deterministic=deterministic, generator=generator, p=p)
        b, s, h = x.shape
        xn = self.attn_ln(x)
        q, k, v = (d(xn).reshape(b, s, hp.num_heads, h // hp.num_heads)
                   for d in (a.query, a.key, a.value))
        ctx, extra = plain_attention(q, k, v, mask, collect=collect, p=p, p_sm=hp.p_sm)
        x = p(x + dropout(a.out_proj(ctx.reshape(b, s, h)), hp.hidden_dropout_prob, **drop))
        y = self.mlp.output(gelu(self.mlp.intermediate(self.mlp_ln(x)), p))
        return p(x + dropout(y, hp.hidden_dropout_prob, **drop)), extra


def replay_contexts(generator: Optional[torch.Generator]):
    """A checkpoint's contexts that set ``generator`` back to its state
    before the forward for the recompute (the same dropout masks)."""
    if generator is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    state = {}

    @contextlib.contextmanager
    def forward():
        state["before"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(state["before"])
        try:
            yield
        finally:
            generator.set_state(now)

    return forward(), recompute()


class TransformerEncoder(nn.Module):
    def __init__(self, hp: EncoderHParams, device=None):
        super().__init__()
        self.hp = hp
        for i in range(hp.num_layers):
            self.add_module(f"layer{i:02d}", TransformerLayer(hp, device))
        self.final_ln = LayerNorm(hp.hidden_size, device, hp.p)

    def forward(self, x, mask, *, collect="none", num_layers=None, deterministic=True,
                generator=None) -> Dict[str, torch.Tensor]:
        hp = self.hp
        x = hp.p(x.float())
        mask = None if mask is None else mask.float()
        colsum = None
        remat = hp.remat and torch.is_grad_enabled()
        for i in range(hp.num_layers if num_layers is None else num_layers):
            layer = getattr(self, f"layer{i:02d}")
            args = (x, mask, collect, deterministic, generator)
            if remat:
                gen = None if deterministic else generator
                x, extra = torch_checkpoint.checkpoint(
                    layer, *args, use_reentrant=False,
                    context_fn=lambda: replay_contexts(gen))
            else:
                x, extra = layer(*args)
            if collect == "colsum":
                colsum = extra if colsum is None else colsum + extra
        out = {"hidden_state": self.final_ln(x)}
        if collect == "colsum":
            out["attn_colsum"] = colsum
        return out
