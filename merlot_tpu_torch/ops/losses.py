"""Loss primitives (counterpart of merlot_tpu/ops/losses.py)."""

from __future__ import annotations

import torch


def cross_entropy_with_logits(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE. logits [..., C], int labels [...] -> loss [...].
    The JAX package's ``-sum(one_hot * log_softmax)``, taken as a gather
    of the label's log-prob (the one non-zero term of that sum). Its
    per-class weights have no caller in the port yet."""
    log_probs = torch.log_softmax(logits, dim=-1)
    return -log_probs.gather(-1, labels.long()[..., None])[..., 0]
