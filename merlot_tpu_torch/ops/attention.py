"""Multi-head attention core (counterpart of merlot_tpu/ops/attention.py).

Scores scaled by 1/sqrt(d_head), the mask applied as
``score*mask - 1e10*(1-mask)`` (a fully masked row softmaxes to uniform over
the true key length), softmax in fp32 or in the compute dtype, then
probs @ value with fp32 accumulation. The JAX package's additive-bias form
of the mask gives the same results (``s - 1e10`` rounds to ``-1e10`` in
fp32 and bf16), so only the multiplicative form is kept.

``collect`` says what is returned beside the context:
  - 'none'   : nothing;
  - 'colsum' : per-key attention mass [B, Sk] fp32, head-meaned and summed
               over query rows (what attention-guided masking reads);
  - 'probs'  : head-meaned probs [B, Sq, Sk] fp32 (telemetry).

Attention-prob dropout (``dropout_rate`` > 0, training only) drops each
prob with probability ``dropout_rate`` and scales the kept ones by
1 / (1 - rate) after the colsum or probs are taken and before the value
product; the keep mask is drawn from ``generator``. A call that holds some
of the heads (a tensor-parallel rank's, ``dropout_heads``) draws the mask
over all heads and keeps its own, so the ranks together drop what one
process would.

Backends: 'plain' is the PyTorch composition below (autograd through it);
'cuda' is the hand-written attention kernels (ops/cuda_attention.py): the
forward K1 and, when a gradient is taken, the backward K2; a shape or
dtype they do not take raises. Two cases take the plain path on every
backend, by the JAX package's own routing (its ``fusable`` rule), not as a
fallback: ``collect='probs'`` (its kernel never returns the probs) and a
nonzero ``dropout_rate`` (its kernel has no dropout). 'auto' means
'plain'.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MASK_PENALTY = 1e10


def inference_backend(device: torch.device | str) -> str:
    """The backend of a device: the kernels on a CUDA device (the forward
    K1 and, where a gradient is taken, the backward K2), the plain
    composition elsewhere (as JAX picks 'pallas' only on a TPU)."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


# training (grad) paths pick their backend by the same rule
training_backend = inference_backend


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], *,
                   collect: str = "none",
                   backend: str = "auto",
                   softmax_fp32: bool = True,
                   dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   dropout_heads: Optional[Tuple[int, int]] = None,
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scaled dot-product attention.

    Args:
      q: [B, Sq, H, D]; k, v: [B, Sk, H, D].
      mask: [B, Sq, Sk] (1 = attend) or None.
      collect: 'none' | 'colsum' | 'probs'.
      backend: 'auto' | 'plain' | 'cuda'.
      dropout_rate: attention-prob dropout (0 outside training), its keep
        mask drawn from ``generator`` (the device's default when None).
      dropout_heads: (first, total) when q holds heads first.. of ``total``
        (a tensor-parallel rank's): the keep mask is drawn over all
        ``total`` heads and this call's are sliced out.

    Returns (context [B, Sq, H, D] in q.dtype, extra) with extra None /
    colsum [B, Sk] fp32 / probs [B, Sq, Sk] fp32 per ``collect``.
    """
    if collect not in ("none", "colsum", "probs"):
        raise ValueError(f"bad collect={collect}")
    if backend not in ("auto", "plain", "cuda"):
        raise ValueError(f"bad backend={backend}")

    if backend == "cuda" and collect != "probs" and dropout_rate == 0.0:
        # imported here: cuda_attention imports this module
        from merlot_tpu_torch.ops.cuda_attention import (flash_attention,
                                                         kernel_supported)
        if not kernel_supported(q.shape[1], k.shape[1], q.shape[-1], q.dtype):
            raise ValueError(f"attention_core: the kernels do not take Sq={q.shape[1]} "
                             f"Sk={k.shape[1]} d={q.shape[-1]} {q.dtype}")
        return flash_attention(q, k, v, mask, collect=collect,
                               softmax_fp32=softmax_fp32)

    return _plain_attention(q, k, v, mask, collect=collect,
                            softmax_fp32=softmax_fp32, dropout_rate=dropout_rate,
                            generator=generator, dropout_heads=dropout_heads)


def attention_scores(q, k, mask, *, softmax_fp32: bool) -> torch.Tensor:
    """The softmax's input [B, H, Sq, Sk] in the softmax dtype: exact fp32
    dot products (bf16 inputs widen losslessly), scaled, rounded to the
    softmax dtype, then masked."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    sm_dtype = torch.float32 if softmax_fp32 else q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.to(sm_dtype)
    if mask is not None:
        m = mask.to(sm_dtype)[:, None]          # broadcast over heads
        scores = scores * m - MASK_PENALTY * (1 - m)
    return scores


def attention_probs(q, k, mask, *, softmax_fp32: bool) -> torch.Tensor:
    """Softmax probs [B, H, Sq, Sk] in the softmax dtype, from
    ``attention_scores``."""
    return torch.softmax(attention_scores(q, k, mask, softmax_fp32=softmax_fp32), dim=-1)


def _plain_attention(q, k, v, mask, *, collect, softmax_fp32=True, dropout_rate=0.0,
                     generator=None, dropout_heads=None):
    """The plain PyTorch path (counterpart of ``_xla_attention``): probs
    from ``attention_probs``, dropped out after the colsum or probs are
    taken, cast to q.dtype for the value product, which accumulates in
    fp32."""
    probs = attention_probs(q, k, mask, softmax_fp32=softmax_fp32)

    extra = None
    if collect == "colsum":
        extra = probs.float().sum(dim=(1, 2)) / probs.shape[1]   # [B, Sk]
    elif collect == "probs":
        extra = probs.float().mean(dim=1)                        # [B, Sq, Sk]

    if dropout_rate > 0.0:
        b, h, sq, sk = probs.shape
        first, total = (0, h) if dropout_heads is None else dropout_heads
        keep = torch.rand((b, total, sq, sk), generator=generator,
                          device=probs.device)[:, first:first + h] < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)

    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    return ctx.to(q.dtype), extra
