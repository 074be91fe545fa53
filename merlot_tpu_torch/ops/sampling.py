"""Randomness primitives with explicit ``torch.Generator``s (counterpart
of merlot_tpu/ops/sampling.py). The distributions are the JAX package's;
the streams are not (and cannot be), so tests compare distributions, or
feed both packages the same draws."""

from __future__ import annotations

from typing import Optional

import torch


def top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, largest first;
    among equal values the lower index comes first (XLA's TopK order;
    ``torch.topk`` promises no order among ties)."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws, fp32."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def gumbel_topk_without_replacement(logits: torch.Tensor, num_samples: int, *,
                                    generator: Optional[torch.Generator] = None,
                                    gumbel: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """Sample ``num_samples`` indices without replacement via Gumbel top-k.
    logits [..., N] -> int64 indices [..., num_samples], ordered by perturbed
    logit (descending). ``gumbel`` gives the noise explicitly; otherwise it
    is drawn from ``generator``."""
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return top_k_indices(logits + gumbel, num_samples)


def sample_categorical(log_probs: torch.Tensor, shape, *,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """Categorical draws from 1-D log_probs to an arbitrary output shape
    (int64)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    probs = torch.softmax(log_probs.float(), dim=-1).to(device)
    draws = torch.multinomial(probs, n, replacement=True, generator=generator)
    return draws.reshape(shape)


def sample_bernoulli(p, shape=(), *, generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """Bernoulli(p) draws as bool: uniform [0, 1) draws below p (p a float
    or a tensor broadcast against ``shape``)."""
    return torch.rand(tuple(shape), generator=generator, device=device) < p


def binomial_sample(n: int, p: float, *, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """One Binomial(n, p) draw (int64 scalar) as a categorical over the counts
    0..n, whose logits are the log-pmf from lgamma terms."""
    counts = torch.arange(0, n + 1, dtype=torch.float32, device=device)
    n_f = torch.tensor(float(n), device=device)
    p_t = torch.tensor(float(p), device=device)
    logits = (-torch.lgamma(1.0 + n_f - counts) - torch.lgamma(1.0 + counts)
              + counts * torch.log(p_t) + (n_f - counts) * torch.log1p(-p_t))
    return sample_categorical(logits, (), generator=generator, device=device)
