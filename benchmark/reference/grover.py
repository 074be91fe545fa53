"""Plain PyTorch reference of the Grover LM's training forward and loss.

A frozen copy of the port's ``models/grover.py`` without a cache: per
layer ``h = LN1((h + drop(attn(h))) + drop(mlp(LN0(h + drop(attn(h))))))``
with a causal float32 softmax, word + position embeddings under
``embed_norm``, logits tied to the word embedding, and the weighted
next-token cross-entropy (x``target_bonus`` on denoise targets). Like the
port, no attention-prob dropout. The hidden dropout draws from the
generator at the port's two sites per layer, in its order.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from benchmark.reference.nn import (DenseTN, LayerNorm, dropout, gelu, plain_attention,
                                    replay_contexts)


class GroverLayer(nn.Module):
    def __init__(self, c: Dict[str, Any], device=None):
        super().__init__()
        hs, inter = c["hidden_size"], c["intermediate_size"]
        self.heads, self.rate = c["num_attention_heads"], c["hidden_dropout_prob"]
        for name in ("query", "key", "value", "out_proj"):
            self.add_module(name, DenseTN(hs, hs, device=device))
        self.mlp_ln0 = LayerNorm(hs, device)
        self.intermediate = DenseTN(hs, inter, device=device)
        self.output = DenseTN(inter, hs, device=device)
        self.mlp_ln1 = LayerNorm(hs, device)

    def forward(self, h, mask, generator):
        b, s, hs = h.shape
        q, k, v = (d(h).reshape(b, s, self.heads, hs // self.heads)
                   for d in (self.query, self.key, self.value))
        ctx, _ = plain_attention(q, k, v, mask)
        drop = dict(deterministic=generator is None, generator=generator)
        x = h + dropout(self.out_proj(ctx.reshape(b, s, hs)), self.rate, **drop)
        y = self.output(gelu(self.intermediate(self.mlp_ln0(x))))
        return self.mlp_ln1(x + dropout(y, self.rate, **drop))


class GroverLM(nn.Module):
    """``c``: the configuration's keys (configs/grover_medium.json)."""

    def __init__(self, c: Dict[str, Any], device=None):
        super().__init__()
        self.n_layers = c["num_hidden_layers"]
        self.word_embed = nn.Parameter(torch.zeros(c["vocab_size"], c["hidden_size"],
                                                   device=device))
        self.pos_embed = nn.Parameter(torch.zeros(c["max_position_embeddings"],
                                                  c["hidden_size"], device=device))
        self.embed_norm = LayerNorm(c["hidden_size"], device)
        for i in range(self.n_layers):
            setattr(self, f"layer{i:02d}", GroverLayer(c, device))

    def forward(self, ids, generator, remat: bool = False):
        """Logits [B, S, V] float32; dropout from ``generator`` (None: off).
        ``remat`` checkpoints each layer, replaying its dropout masks."""
        s = ids.shape[1]
        h = self.embed_norm(self.word_embed[ids] + self.pos_embed[:s][None])
        pos = torch.arange(s, device=ids.device)
        mask = (pos[None] <= pos[:, None]).float()[None]
        for i in range(self.n_layers):
            layer = getattr(self, f"layer{i:02d}")
            if remat and torch.is_grad_enabled():
                h = torch_checkpoint.checkpoint(layer, h, mask, generator, use_reentrant=False,
                                                context_fn=lambda: replay_contexts(generator))
            else:
                h = layer(h, mask, generator)
        return h.float() @ self.word_embed.float().t()


def lm_loss(logits, ids, is_target, pad: int = 0, target_bonus: float = 4.0):
    targets = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], pad)], dim=1)
    per_tok = -torch.log_softmax(logits.float(), dim=-1).gather(
        -1, targets[..., None].long())[..., 0]
    w = (targets != pad).float() + is_target.float() * target_bonus
    return (w * per_tok).sum() / (w.sum() + 1e-5)


def grover_loss(model: GroverLM, batch, generator, remat: bool = False, target_bonus=4.0):
    """grover_train's loss: the forward on input_ids[:, :-1], weighted
    against is_target[:, 1:]."""
    ids = batch["input_ids"][:, :-1]
    return lm_loss(model(ids, generator, remat), ids, batch["is_target"][:, 1:],
                   target_bonus=target_bonus)
