"""Weights made from the seed, on the device, in a few large calls.

The benchmark makes the weights and hands the same values to the program
and to the reference (the program's own initialiser is never run). By the
parameter's name and shape: norm scales 1, biases 0, convolution kernels
normal of std sqrt(1 / fan in), every other table and matrix normal of
std ``initializer_range``; the normals are clipped at two standard
deviations. One generator on the device draws one flat block for all the
random leaves, in name order.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

ONES = ("gamma",)
ZEROS = ("beta", "bias", "lm_output_bias")


def _kind(name: str, shape: Tuple[int, ...], std: float) -> Tuple[str, float]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ONES:
        return "ones", 0.0
    if leaf in ZEROS:
        return "zeros", 0.0
    if len(shape) == 4:  # OIHW conv kernel
        return "normal", math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
    return "normal", std


def make_weights(shapes: Mapping[str, Tuple[int, ...]], seed: int, device,
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``shapes`` from ``seed``."""
    names = sorted(shapes)
    plan = {n: _kind(n, tuple(shapes[n]), std) for n in names}
    randoms = [n for n in names if plan[n][0] == "normal"]
    total = sum(math.prod(shapes[n]) for n in randoms)
    gen = torch.Generator(device=device).manual_seed(seed)
    block = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for n in names:
        kind, s = plan[n]
        if kind == "ones":
            out[n] = torch.ones(shapes[n], device=device)
        elif kind == "zeros":
            out[n] = torch.zeros(shapes[n], device=device)
        else:
            size = math.prod(shapes[n])
            out[n] = block[offset:offset + size].view(shapes[n]).mul(s)
            offset += size
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Mapping[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters, every one by name."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) ^ set(weights))
    if missing:
        raise KeyError(f"weights and parameters differ: {missing[:8]}")
    for n, p in params.items():
        p.copy_(weights[n])


def param_shapes(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}
