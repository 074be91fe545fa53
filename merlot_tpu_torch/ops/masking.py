"""Attention-guided SpanBERT masking (counterpart of
merlot_tpu/ops/masking.py), with its random draws explicit.

Per example row of length L:
  1. tokens in the top ``topk_perc`` of attention-received mass get
     sampling weight ``topk_val`` against ``nontopk_val`` elsewhere,
     calibrated so that one draw lands in the top set with probability
     ``choose_topk_prob``;
  2. ``int(L * masking_rate)`` anchors are drawn without replacement by
     Gumbel top-k over the log-weights (special tokens, id < 100, get -1e8);
  3. each anchor grows to a span by two categorical draws over
     ``spanbert_len_probs`` (down and up);
  4. span membership is resolved back to exactly that many positions by
     ranking (first covering span, tie-broken by sampling weight);
  5. masked positions become 80% MASK / 10% a random non-special id /
     10% kept.

Every top-k breaks ties by the lower index first, as XLA's TopK does, so
that the same draws give the JAX package's positions (the padding and
special tokens all tie at mass 0, and uncovered positions tie in step 4).
The draws are the JAX function's five: the Gumbel noise, ``lo``, ``hi``,
``option`` and ``random_ids`` (``masking_draws``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from merlot_tpu_torch.core.tokenizer import MASK, SPECIAL_TOKEN_CUTOFF
from merlot_tpu_torch.ops.sampling import (gumbel_noise,
                                           gumbel_topk_without_replacement,
                                           sample_categorical, top_k_indices)

OPTION_PROBS = (0.1, 0.8, 0.1)  # keep, MASK, random id


def masking_draws(batch: int, length: int, *, vocab_size: int,
                  masking_rate: float = 0.2,
                  spanbert_len_probs: Sequence[float] = (0.625, 0.25, 0.125),
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """The random draws of one masking call, from ``generator``:
    gumbel [B, L] fp32; lo, hi [B, M] span extensions; option [B*L] in
    {0 keep, 1 MASK, 2 random}; random_ids [B*L]."""
    m = int(length * masking_rate)
    len_logp = torch.log(torch.tensor(spanbert_len_probs, dtype=torch.float32))
    opt_logp = torch.log(torch.tensor(OPTION_PROBS, dtype=torch.float32))
    kw = dict(generator=generator, device=device)
    return {
        "gumbel": gumbel_noise((batch, length), **kw),
        "lo": sample_categorical(len_logp, (batch, m), **kw),
        "hi": sample_categorical(len_logp, (batch, m), **kw),
        "option": sample_categorical(opt_logp, (batch * length,), **kw),
        "random_ids": torch.randint(SPECIAL_TOKEN_CUTOFF, vocab_size,
                                    (batch * length,), **kw),
    }


def attention_guided_span_mask(
    input_ids: torch.Tensor,            # [B, L] int
    attn_mass: Optional[torch.Tensor],  # [B, L] attention received, or None
    *,
    vocab_size: int,
    masking_rate: float = 0.2,
    topk_perc: float = 0.20,
    choose_topk_prob: float = 0.5,
    do_spanbert: bool = True,
    spanbert_len_probs: Sequence[float] = (0.625, 0.25, 0.125),
    use_attn: bool = True,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (masked_ids [B, L] in input_ids' dtype, masked_idx
    [B, int(L * masking_rate)] int64, ascending). ``draws`` (see
    ``masking_draws``) are made from ``generator`` when not given."""
    b, length = input_ids.shape
    dev = input_ids.device
    num_topk = int(length * topk_perc)
    num_to_mask = int(length * masking_rate)
    if draws is None:
        draws = masking_draws(b, length, vocab_size=vocab_size,
                              masking_rate=masking_rate,
                              spanbert_len_probs=spanbert_len_probs,
                              generator=generator, device=dev)
    ids = input_ids.long()
    is_special = (ids < SPECIAL_TOKEN_CUTOFF).float()
    positions = torch.arange(length, device=dev)

    # 1. per-token sampling weights
    nontopk_val = 0.01
    topk_val = (nontopk_val * choose_topk_prob * (1.0 - topk_perc)
                / (topk_perc * (1.0 - choose_topk_prob)))
    if use_attn and attn_mass is not None:
        mass = attn_mass.float() * (1.0 - is_special)
        top = top_k_indices(mass, num_topk)
        is_important = torch.zeros((b, length), dtype=torch.bool, device=dev)
        is_important.scatter_(1, top, True)
        mask_weight = is_important.float() * (topk_val - nontopk_val) + nontopk_val
    else:
        mask_weight = torch.ones((b, length), dtype=torch.float32, device=dev)

    # 2. anchors by Gumbel top-k, reversed so that spans anchored on
    # higher-weight draws win ties later
    log_mask = torch.log(mask_weight) - 1e8 * is_special
    idx = gumbel_topk_without_replacement(
        log_mask, num_to_mask, gumbel=draws["gumbel"].to(dev)).flip(-1)

    if do_spanbert:
        # 3-4. spans; the first covering span's index (0 where none covers,
        # never chosen: the tie-break ranks uncovered positions lower)
        start = idx - draws["lo"].to(dev)
        end = idx + draws["hi"].to(dev)
        covers = ((positions[None, None] >= start[..., None])
                  & (positions[None, None] <= end[..., None]))       # [B, M, L]
        which = torch.argmax(covers.float(), dim=1).float()
        which = which * (1.0 - is_special)
        which = which + 0.5 * mask_weight / mask_weight.max()
        mask_idx = top_k_indices(which, num_to_mask)
    else:
        mask_idx = idx
    mask_idx = torch.sort(mask_idx, dim=1).values

    # 5. 80/10/10 corruption
    do_mask = torch.zeros((b, length), dtype=torch.bool, device=dev)
    do_mask.scatter_(1, mask_idx, True)
    option = draws["option"].to(dev) * do_mask.reshape(-1).long()
    flat = ids.reshape(-1)
    masked = torch.where(option == 0, flat,
                         torch.where(option == 1, torch.full_like(flat, MASK),
                                     draws["random_ids"].to(dev).long()))
    return masked.reshape(b, length).to(input_ids.dtype), mask_idx
