"""DeepSeek-V3's expert layer (arXiv 2412.19437 section 2.1.2), as one
share of an expert-parallel deployment.

``MoE`` routes every token over all of the router's experts
(``ops/moe_route.py``: sigmoid scores, the top K of the scores plus the
correction bias, the chosen scores normalised and scaled) and computes the
part of the result that the experts it holds give:

    out = sum over the chosen held experts i of w_i * E_i(y) + Shared(y)
    E(y) = W_down (silu(W_gate y) * W_up y)

The shared experts (``n_shared_experts`` of them, one SwiGLU of their
summed width) run on every token. What the experts held elsewhere would
add is not computed: on one chip the layer runs without the exchange of an
expert-parallel deployment, and the partial result goes on. No token is
dropped: the held experts' rows have the size of the most picks they can
get (``moe_route.held_rows``), so no count is read by the host.

The held experts' products (``HeldExperts``): the picked tokens gathered
into the routing's layout, one grouped product per projection over the
experts' row ranges (``torch._grouped_mm`` on the card, with the offsets on
the device; a loop over the groups on the CPU), the SwiGLU, and one
weighted sum back to the tokens. On the card the row work is the routing
library's gather and ``ops/moe_experts.py``'s kernels, which stop at the
rows in use; the plain
version below does it in ATen over every row. The backward recomputes the
products from the layer's input: the layout's rows are sized for the
worst case, so keeping them for the backward would hold that worst case
for every layer.

Precision: the router and its scores in fp32; the experts' products on
bf16 operands with fp32 accumulation, their activations and outputs in
bf16; the weighted sum in fp32.

Training adds DeepSeek-V3's balance machinery: each training forward adds
its picks per expert, over all the router's experts, to ``loads``, and
``update_bias`` (which the training step calls once, after the optimizer's
update: ``models/moe_lm.moe_lm_train_step``) moves the correction bias by
``bias_update_speed`` * sign(mean load - load) and clears them, so a step
of several forwards moves it once, by the step's loads (a recompute of a
forward doubles its loads, which leaves the signs). ``balance_loss``
is the sequence-wise balance loss alpha * sum_i f_i P_i over all the
router's experts, averaged over the rows.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from merlot_tpu_torch.core import trace
from merlot_tpu_torch.ops import moe_experts, moe_route


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in fp32 from [.., 2W] (gate first), rounded to the
    input's dtype."""
    gate, up = gate_up.float().chunk(2, dim=-1)
    return (F.silu(gate) * up).to(gate_up.dtype)


def swiglu_bwd(gate_up: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``swiglu`` in its input, in the input's dtype."""
    gate, up = gate_up.float().chunk(2, dim=-1)
    g = g.float()
    sg = torch.sigmoid(gate)
    d_gate = g * up * sg * (1.0 + gate * (1.0 - sg))
    return torch.cat([d_gate, g * gate * sg], dim=-1).to(gate_up.dtype)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """x [R, K] bf16 by w [G, K, N] bf16 group by group over x's row ranges
    (``offs``: the groups' end rows) -> [R, N]; rows past the last group are
    left undefined. ``torch._grouped_mm`` on the card, a loop on the CPU."""
    if x.device.type == "cuda":
        return torch._grouped_mm(x, w, offs=offs)
    out = x.new_zeros(x.shape[0], w.shape[-1])
    start = 0
    for g, end in enumerate(offs.tolist()):
        out[start:end] = x[start:end] @ w[g]
        start = end
    return out


def grouped_mm_k(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """a [M, R] by b [R, N] summed group by group over R's ranges -> [G, M,
    N] (the weights' gradients)."""
    if a.device.type == "cuda":
        return torch._grouped_mm(a, b, offs=offs)
    out = a.new_zeros(offs.numel(), a.shape[0], b.shape[1])
    start = 0
    for g, end in enumerate(offs.tolist()):
        out[g] = a[:, start:end] @ b[start:end]
        start = end
    return out


class HeldExperts(torch.autograd.Function):
    """The held experts' part of the layer: y [T, H] bf16, the weights [T, K]
    fp32, w_gate_up [G, 2W, H] and w_down [G, H, W] bf16 (G held experts,
    gate rows first), and the routing's layout (row_tk, offs). Returns [T,
    H] fp32."""

    @staticmethod
    def _rows(y, w_gate_up, w_down, row_tk, offs, top_k):
        """The layout's rows: (x, [gate | up], act, out)."""
        if y.device.type == "cuda":
            end = offs[-1:]
            x = moe_route.gather(y, row_tk, end, top_k)
            gate_up = grouped_mm(x, w_gate_up.transpose(1, 2), offs)
            act = moe_experts.swiglu(gate_up, end)
        else:
            token = (row_tk // top_k).long()            # T for a pad or unused row
            x = y.index_select(0, token.clamp(max=y.shape[0] - 1))
            gate_up = grouped_mm(x, w_gate_up.transpose(1, 2), offs)
            act = swiglu(gate_up)
        return x, gate_up, act, grouped_mm(act, w_down.transpose(1, 2), offs)

    @staticmethod
    def forward(ctx, y, weights, w_gate_up, w_down, row_tk, offs, top_k: int):
        t, k = weights.shape
        _, _, _, out = HeldExperts._rows(y, w_gate_up, w_down, row_tk, offs, top_k)
        ctx.save_for_backward(y, weights, w_gate_up, w_down, row_tk, offs)
        ctx.top_k = top_k
        if y.device.type == "cuda":
            return moe_experts.combine(out, moe_experts.slots(row_tk, t, k), weights)
        token = (row_tk // top_k).long()
        row_w = torch.cat([weights.reshape(-1), weights.new_zeros(1)])[row_tk.long()]
        # pad and unused rows (undefined past the groups) land in row T
        total = y.new_zeros(t + 1, y.shape[1], dtype=torch.float32)
        total.index_add_(0, token, out.float() * row_w[:, None])
        return total[:t]

    @staticmethod
    def backward(ctx, g):
        y, weights, w_gate_up, w_down, row_tk, offs = ctx.saved_tensors
        x, gate_up, act, out = HeldExperts._rows(y, w_gate_up, w_down, row_tk, offs,
                                                 ctx.top_k)
        if y.device.type == "cuda":
            return HeldExperts._backward_cuda(g, y, weights, w_gate_up, w_down, row_tk, offs,
                                              x, gate_up, act, out, ctx.top_k)
        t, k = weights.shape
        token = (row_tk // ctx.top_k).long()
        flat = row_tk.long()
        row_w = torch.cat([weights.reshape(-1), weights.new_zeros(1)])[flat]
        g_rows = torch.cat([g.float(), g.new_zeros(1, g.shape[1], dtype=torch.float32)]
                           ).index_select(0, token)
        g_w = weights.new_zeros(t * k + 1).scatter_(0, flat, (g_rows * out.float()).sum(-1))
        g_out = (g_rows * row_w[:, None]).to(out.dtype)
        g_act = grouped_mm(g_out, w_down, offs)
        g_w_down = grouped_mm_k(g_out.t(), act, offs)
        g_gate_up = swiglu_bwd(gate_up, g_act)
        g_x = grouped_mm(g_gate_up, w_gate_up, offs)
        g_w_gate_up = grouped_mm_k(g_gate_up.t(), x, offs)
        g_y = y.new_zeros(t + 1, y.shape[1], dtype=torch.float32)
        g_y.index_add_(0, token, g_x.float())
        return (g_y[:t].to(y.dtype), g_w[:t * k].reshape(t, k), g_w_gate_up, g_w_down,
                None, None, None)

    @staticmethod
    def _backward_cuda(g, y, weights, w_gate_up, w_down, row_tk, offs, x, gate_up, act, out,
                       top_k):
        t, k = weights.shape
        end = offs[-1:]
        g_out, g_w = moe_experts.rows_bwd(g.float(), out, row_tk, weights, end)
        g_act = grouped_mm(g_out, w_down, offs)
        g_w_down = grouped_mm_k(g_out.t(), act, offs)
        g_gate_up = moe_experts.swiglu_bwd(gate_up, g_act, end)
        g_x = grouped_mm(g_gate_up, w_gate_up, offs)
        g_w_gate_up = grouped_mm_k(g_gate_up.t(), x, offs)
        g_y = moe_experts.sum_back(g_x, moe_experts.slots(row_tk, t, k), t, k)
        return g_y, g_w, g_w_gate_up, g_w_down, None, None, None


@torch.no_grad()
def trunc_normal(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """A normal of ``std`` clipped at two standard deviations, drawn on the
    generator's device."""
    p.copy_(torch.randn(p.shape, generator=gen, device=gen.device).clamp_(-2.0, 2.0) * std)


class SwiGLUMLP(nn.Module):
    """W_down(silu(W_gate x) * W_up x) with fp32 weights [out, in] and bf16
    products: the dense layer's MLP and the shared experts."""

    def __init__(self, hidden: int, width: int, device=None):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(width, hidden, device=device))
        self.up_proj = nn.Parameter(torch.empty(width, hidden, device=device))
        self.down_proj = nn.Parameter(torch.empty(hidden, width, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        gate = F.linear(x, self.gate_proj.to(torch.bfloat16))
        up = F.linear(x, self.up_proj.to(torch.bfloat16))
        act = (F.silu(gate.float()) * up.float()).to(torch.bfloat16)
        return F.linear(act, self.down_proj.to(torch.bfloat16))


class MoE(nn.Module):
    """The expert layer of one expert-parallel share. ``held``: (first,
    count) of the router's ``n_routed`` experts whose weights live here."""

    def __init__(self, hidden: int, width: int, n_routed: int, top_k: int, n_shared: int,
                 held: Tuple[int, int], scale: float, bias_update_speed: float,
                 balance_alpha: float, device=None):
        super().__init__()
        self.n_routed, self.top_k, self.held = n_routed, top_k, tuple(held)
        self.scale, self.bias_update_speed = scale, bias_update_speed
        self.balance_alpha = balance_alpha
        g = self.held[1]
        self.router = nn.Parameter(torch.empty(n_routed, hidden, device=device))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(n_routed, dtype=torch.float32, device=device))
        # each held expert's gate and up rows stacked, and its down matrix
        self.experts_gate_up = nn.Parameter(torch.empty(g, 2 * width, hidden, device=device))
        self.experts_down = nn.Parameter(torch.empty(g, hidden, width, device=device))
        self.shared = SwiGLUMLP(hidden, n_shared * width, device=device)
        self.loads = None  # [E] int32: the step's picks per expert so far

    def forward(self, y32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """y32: the normed input [B, S, H] fp32. Returns (the held experts'
        and the shared experts' sum [B, S, H] fp32, this layer's balance
        loss, a scalar)."""
        b, s, h = y32.shape
        logits = F.linear(y32.reshape(b * s, h), self.router)
        with trace.span("model.moe.route"):
            r = moe_route.route(logits, self.e_score_correction_bias, top_k=self.top_k,
                                seq_len=s, held=self.held, scale=self.scale)
        if self.training:
            self.loads = r.counts if self.loads is None else self.loads + r.counts
        trace.count("moe.tokens_held", r.stats[0])
        trace.count("moe.dropped", r.stats[1])
        trace.count("moe.load_max_over_mean", r.stats[2])
        y = y32.reshape(b * s, h).to(torch.bfloat16)
        with trace.span("model.moe.experts"):
            out = HeldExperts.apply(y, r.weights, self.experts_gate_up.to(torch.bfloat16),
                                    self.experts_down.to(torch.bfloat16), r.row_tk, r.offs,
                                    self.top_k)
        with trace.span("model.moe.shared"):
            out = out + self.shared(y).float()
        return out.reshape(b, s, h), self.balance_loss(logits, r.seq_counts, s)

    @torch.no_grad()
    def update_bias(self) -> None:
        """bias += gamma * sign(mean load - load) over the loads of the
        training forwards since the last call; nothing without any."""
        if self.loads is not None:
            d = self.loads.sum() - self.n_routed * self.loads
            self.e_score_correction_bias.add_(torch.sign(d).float(),
                                              alpha=self.bias_update_speed)
            self.loads = None

    def balance_loss(self, logits: torch.Tensor, seq_counts: torch.Tensor,
                     seq_len: int) -> torch.Tensor:
        """alpha * sum_i f_i P_i averaged over the rows: f_i = E / (K S) times
        row's picks of expert i (no gradient), P_i the row's mean of s_i
        normalised over all E scores."""
        if not self.training or self.balance_alpha == 0.0:
            return logits.new_zeros(())
        s = torch.sigmoid(logits)
        p = (s / s.sum(-1, keepdim=True)).reshape(-1, seq_len, self.n_routed).mean(1)
        f = seq_counts.float() * (self.n_routed / (self.top_k * seq_len))
        return self.balance_alpha * (f * p).sum(-1).mean()
