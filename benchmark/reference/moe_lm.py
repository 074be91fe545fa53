"""Plain PyTorch reference of the DeepSeek-V3 block's LM as one share of an
expert-parallel deployment (the port's ``models/moe_lm.py``).

Follows arXiv 2412.19437 section 2.1 and Hugging Face's ``deepseek_v3``
modelling, which Moonlight-16B-A3B's config names, in float32 (TF32 off,
the caller's ``tf32(False)``), with no kernel and no cache:

  h = h + W_o attention([q_nope, rope(q_pe)], [k_nope, rope(k_pe)], v)
      q = RMSNorm(h) W_q; [c_kv, k_pe] = RMSNorm(h) W_kva;
      [k_nope, v] = RMSNorm_kv(c_kv) W_kvb; causal, scale (d_nope +
      d_rope)^-0.5, softmax in float32, dense over every (query, key) pair
  h = h + MLP(RMSNorm(h))                    the first dense layers
  h = h + sum_{chosen held i} w_i E_i(y) + Shared(y),  y = RMSNorm(h)
      s = sigmoid(y W_g^T); chosen = top K of s + bias;
      w = (s / sum of the chosen s) * routed_scaling_factor;
      E(y) = W_down (silu(W_gate y) * W_up y)
  logits = RMSNorm(h) W_head^T; next-token cross-entropy + the
  sequence-wise balance loss alpha * sum_i f_i P_i per MoE layer

The held experts' sum is a one-hot product: each held expert over every
token, times the token's weight for it (0 where it did not choose it).

Departures from the published model, as the benchmark's configuration
states them: the layer holds ``experts_held`` of the router's experts and
adds only theirs (the rest live on the deployment's other chips); the
vocabulary is the share's slice; RoPE's pairs are Hugging Face's layout
(interleaved pairs gathered into halves, then rotate_half); no
multi-token prediction; AdamW (``reference/adamw.py``) in place of
Moonlight's Muon.

``Precision`` rounds the sites the configuration computes in bf16 (every
product's operands and result, the SwiGLU's activation, the attention's
probabilities before P.V, RoPE's output); the router, the norms and the
residual stream stay float32.

``forced``: the program's chosen experts per MoE layer ([T, K] each). The
reference then weighs those experts, and records for each layer the
tokens where its own top K differs and the gap of its biased scores at
the boundary there (its K-th best less the least it was given), so a
rounding that moves a choice is told apart from a wrong one.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from benchmark.reference.nn import FP32, MASK_PENALTY, Precision


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


def rms_norm(x, gamma, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gamma


def rope(x, pos, theta, p: Precision):
    """x [B, S, h, d]: pairs (x_2i, x_2i+1) gathered into halves, then x cos
    + rotate_half(x) sin, the angle pos * theta^(-2i/d) on half i."""
    b, s, h, d = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    ang = pos.float()[:, None] * inv_freq[None]
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    x = x.reshape(b, s, h, d // 2, 2).transpose(-1, -2).reshape(b, s, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return p(x * cos[None, :, None] + rot * sin[None, :, None])


class RMSNorm(nn.Module):
    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = _param(dim, device=device)

    def forward(self, x):
        return rms_norm(x, self.gamma, self.eps)


def lin(x, w, p: Precision):
    return p(F.linear(p(x), p(w)))


def swiglu(x, w_gate, w_up, w_down, p: Precision):
    return lin(p(F.silu(lin(x, w_gate, p)) * lin(x, w_up, p)), w_down, p)


class MLA(nn.Module):
    def __init__(self, c, p, device=None):
        super().__init__()
        self.c, self.p = c, p
        h, n = c["hidden_size"], c["num_attention_heads"]
        nope, r, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        self.q_proj = _param(n * (nope + r), h, device=device)
        self.kv_a_proj = _param(c["kv_lora_rank"] + r, h, device=device)
        self.kv_norm = RMSNorm(c["kv_lora_rank"], c["rms_norm_eps"], device)
        self.kv_b_proj = _param(n * (nope + dv), c["kv_lora_rank"], device=device)
        self.o_proj = _param(h, n * dv, device=device)

    def forward(self, x):
        c, p = self.c, self.p
        b, s, _ = x.shape
        n, nope, r, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                          c["qk_rope_head_dim"], c["v_head_dim"])
        pos = torch.arange(s, device=x.device)
        q = lin(x, self.q_proj, p).reshape(b, s, n, nope + r)
        kv_a = lin(x, self.kv_a_proj, p)
        c_kv, k_pe = kv_a[..., :c["kv_lora_rank"]], kv_a[..., c["kv_lora_rank"]:]
        kv = lin(self.kv_norm(c_kv), self.kv_b_proj, p).reshape(b, s, n, nope + dv)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, c["rope_theta"], p)], -1)
        k_pe = rope(k_pe.reshape(b, s, 1, r), pos, c["rope_theta"], p).expand(b, s, n, r)
        k = torch.cat([kv[..., :nope], k_pe], -1)
        v = kv[..., nope:]
        m = torch.ones(s, s, device=x.device).tril_()
        ctx = []
        for i in range(b):  # one row at a time: [n, S, S] scores
            sc = torch.einsum("qhd,khd->hqk", q[i], k[i]) * (1.0 / (nope + r) ** 0.5)
            sc = sc * m - MASK_PENALTY * (1.0 - m)
            probs = p(torch.softmax(sc, dim=-1))
            ctx.append(p(torch.einsum("hqk,khd->qhd", probs, v[i])))
        return lin(torch.stack(ctx).reshape(b, s, n * dv), self.o_proj, p)


class SwiGLUMLP(nn.Module):
    def __init__(self, hidden, width, p, device=None):
        super().__init__()
        self.p = p
        self.gate_proj = _param(width, hidden, device=device)
        self.up_proj = _param(width, hidden, device=device)
        self.down_proj = _param(hidden, width, device=device)

    def forward(self, x):
        return swiglu(x, self.gate_proj, self.up_proj, self.down_proj, self.p)


class MoE(nn.Module):
    def __init__(self, c, p, device=None):
        super().__init__()
        self.c, self.p = c, p
        h, w = c["hidden_size"], c["moe_intermediate_size"]
        self.first, self.count = c["experts_held"]
        self.router = _param(c["n_routed_experts"], h, device=device)
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(c["n_routed_experts"], device=device))
        self.experts_gate_up = _param(self.count, 2 * w, h, device=device)
        self.experts_down = _param(self.count, h, w, device=device)
        self.shared = SwiGLUMLP(h, c["n_shared_experts"] * w, p, device)

    def forward(self, y, forced=None, record=None):
        """y [B, S, H] fp32. Returns (the layer's output, its balance loss,
        the picks per expert)."""
        c, p = self.c, self.p
        b, s, h = y.shape
        e, k = c["n_routed_experts"], c["num_experts_per_tok"]
        y2 = y.reshape(b * s, h)
        scores = torch.sigmoid(y2 @ self.router.t())
        biased = (scores + self.e_score_correction_bias).detach()
        own = torch.sort(biased, dim=-1, descending=True, stable=True).indices[:, :k]
        chosen = own if forced is None else forced.long()
        if forced is not None and record is not None:
            differs = (torch.sort(own, -1).values != torch.sort(chosen, -1).values).any(-1)
            kth = biased.gather(1, own[:, -1:])[:, 0]
            least = biased.gather(1, chosen).min(-1).values
            gap = torch.where(differs, kth - least, torch.zeros_like(kth))
            record.append({"flips": int(differs.sum()), "tokens": b * s,
                           "gap": float(gap.max())})
        sel = scores.gather(1, chosen)
        weights = sel / sel.sum(-1, keepdim=True) * c["routed_scaling_factor"]
        out = torch.zeros_like(y2)
        for i in range(self.count):  # one-hot: every token through each held expert
            g = (weights * (chosen == self.first + i)).sum(-1)
            w_gate, w_up = self.experts_gate_up[i].chunk(2, dim=0)
            out = out + g[:, None] * swiglu(y2, w_gate, w_up, self.experts_down[i], p)
        out = out + self.shared(y2)
        counts = torch.bincount(chosen.reshape(-1), minlength=e)
        rows = torch.zeros(b, e, device=y.device).scatter_add_(
            1, chosen.reshape(b, s * k), torch.ones(b, s * k, device=y.device))
        f = rows * (e / (k * s))
        pbar = (scores / scores.sum(-1, keepdim=True)).reshape(b, s, e).mean(1)
        balance = c["aux_loss_alpha"] * (f * pbar).sum(-1).mean()
        return out.reshape(b, s, h), balance, counts

    @torch.no_grad()
    def update_bias(self, counts):
        """bias += gamma * sign(mean load - load), after the step."""
        e = self.c["n_routed_experts"]
        self.e_score_correction_bias.add_(
            self.c["bias_update_speed"] * torch.sign(counts.sum() - e * counts).float())


class Layer(nn.Module):
    def __init__(self, c, dense, p, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"], device)
        self.attn = MLA(c, p, device)
        self.mlp_norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"], device)
        self.mlp = (SwiGLUMLP(c["hidden_size"], c["intermediate_size"], p, device) if dense
                    else MoE(c, p, device))


class MoeLM(nn.Module):
    """``c``: the port's configuration keys (n_routed_experts the router's
    width, experts_held (first, count))."""

    def __init__(self, c: Dict[str, Any], p: Precision = FP32, device=None):
        super().__init__()
        self.c, self.p = c, p
        self.embed = _param(c["vocab_size"], c["hidden_size"], device=device)
        self.layers = nn.ModuleList(Layer(c, i < c["first_k_dense_replace"], p, device)
                                    for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(c["hidden_size"], c["rms_norm_eps"], device)
        self.head = _param(c["vocab_size"], c["hidden_size"], device=device)

    def forward(self, ids, forced: Optional[List[torch.Tensor]] = None,
                record: Optional[list] = None, remat: bool = False):
        """Logits [B, S, V] fp32, the summed balance loss, and the MoE
        layers' picks per expert (for ``update_bias``). ``remat``
        checkpoints each layer (its routing record taken once)."""
        h = self.embed[ids.long()]
        balance, counts, j = h.new_zeros(()), [], 0
        for layer in self.layers:
            moe = isinstance(layer.mlp, MoE)
            fixed = forced[j] if moe and forced is not None else None
            once = record if moe else None

            def run(h, box, layer=layer, moe=moe, fixed=fixed, once=once):
                h = h + layer.attn(layer.attn_norm(h))
                y = layer.mlp_norm(h)
                if not moe:
                    return h + layer.mlp(y), h.new_zeros(())
                out, bal, n = layer.mlp(y, fixed, once if not box else None)
                if not box:
                    box.append(n)
                return h + out, bal

            box: list = []
            if remat and torch.is_grad_enabled():
                h, part = torch_checkpoint.checkpoint(functools.partial(run, box=box), h,
                                                      use_reentrant=False)
            else:
                h, part = run(h, box)
            balance = balance + part
            if moe:
                counts.append(box[0])
                j += 1
        logits = lin(self.norm(h), self.head, self.p)
        return logits, balance, counts

    def update_biases(self, counts: List[torch.Tensor]) -> None:
        for layer, n in zip([l for l in self.layers if isinstance(l.mlp, MoE)], counts):
            layer.mlp.update_bias(n)

    def biases(self) -> Dict[str, torch.Tensor]:
        return {n: b for n, b in self.named_buffers() if n.endswith("e_score_correction_bias")}


def lm_loss(model: MoeLM, batch, forced=None, record=None, remat: bool = False):
    """(the loss, the MoE layers' picks per expert): next-token
    cross-entropy over input_ids[:, :-1] against input_ids[:, 1:], plus
    the balance losses."""
    ids = batch["input_ids"]
    logits, balance, counts = model(ids[:, :-1], forced, record, remat)
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         ids[:, 1:].reshape(-1).long())
    return ce + balance, counts
