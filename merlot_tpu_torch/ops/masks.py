"""Attention-mask and gather utilities (counterpart of
merlot_tpu/ops/masks.py), with its dtypes:

  * ``one_hot_gather``       rows of a table by a one-hot product in the
                             table's dtype (bf16 stays bf16, else fp32);
  * ``ltr_attention_mask``   the causal [nd, ns] mask whose lower-right
                             triangle is 1 (ns >= nd: a cached prefix);
  * ``unilm_attention_mask`` causal, or any key flagged bidirectional;
                             padding keys excluded; fp32 [B, L, L].
"""

from __future__ import annotations

from typing import Optional

import torch


def one_hot_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``table`` [N, H] as one-hot [len(idx), N] @ table,
    in bf16 for a bf16 table and fp32 otherwise (a one-hot product is
    exact in either)."""
    n = table.shape[0]
    dtype = torch.bfloat16 if table.dtype == torch.bfloat16 else torch.float32
    oh = (idx[:, None] == torch.arange(n, device=idx.device)[None]).to(dtype)
    return oh @ table.to(dtype)


def ltr_attention_mask(nd: int, ns: int, dtype: torch.dtype = torch.float32,
                       device=None) -> torch.Tensor:
    """Causal [nd, ns] mask: row i attends keys j <= i + ns - nd (the last
    nd of ns positions are the queries)."""
    i = torch.arange(nd, device=device)[:, None]
    j = torch.arange(ns, device=device)[None]
    return (i >= j - ns + nd).to(dtype)


def unilm_attention_mask(is_bidirectional: torch.Tensor,
                         is_padding: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hybrid mask [B, L, L] fp32: position i attends j if i >= j or token j
    is flagged bidirectional, and never a padding key."""
    b, length = is_bidirectional.shape
    ar = torch.arange(length, device=is_bidirectional.device)
    causal = ar[:, None] >= ar[None]
    joint = is_bidirectional[:, None, :].bool() | causal[None]
    if is_padding is not None:
        joint = joint & ~is_padding[:, None].bool()
    return joint.to(torch.float32)
