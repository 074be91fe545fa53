"""The held experts' row work on the card (``nn/moe.HeldExperts``), as
hand-written Triton kernels that stop at the rows in use.

The routing's layout (``ops/moe_route.py``) has ``held_rows`` rows, sized
for the most picks the held experts can get, so that no count reaches the
host; the rows in use end at ``offs[-1]``, which stays on the card. Each
kernel here reads that end and leaves every row past it alone (the grouped
products read none of them either, and the rows' gather is the routing
library's ``moe_route.gather``, which stops there too), so the row work
costs what the picks need, not the worst case. The kernels are the SwiGLU
passes and the sums over a token's picks:

  swiglu        act[r] = bf16(silu(g) u) from [g | u], in fp32
  combine       out[t] = sum_k w[t, k] rows[slot(t, k)], fp32, k in order
  rows_bwd      g_rows[r] = bf16(g[token(r)] w(r)), and the weight's
                gradient <g[token(r)], rows[r]> at its pick
  swiglu_bwd    [d_g | d_u] from [g | u] and d_act, in fp32
  sum_back      g_y[t] = sum_k g_x[slot(t, k)], fp32, k in order

``slot(t, k)`` is the row of pick (t, k) or -1 (``slots``); a token's sums
run over its picks in order, with no atomics, so every result is the same
from run to run. Triton is imported, and the kernels built, at the first
call: on the CPU ``nn/moe.HeldExperts`` runs its plain version.
"""

from __future__ import annotations

import functools

import torch

BLOCK_R = 32     # rows of a tile
BLOCK_C = 128    # columns of a tile


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def moe_swiglu_rows(gu, act, n_end, W, BR: tl.constexpr, BC: tl.constexpr):
        r = tl.program_id(0) * BR + tl.arange(0, BR)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        m = (r < tl.load(n_end))[:, None] & (c < W)[None, :]
        row = r[:, None].to(tl.int64) * (2 * W)
        g = tl.load(gu + row + c[None, :], mask=m, other=0.0).to(tl.float32)
        u = tl.load(gu + row + W + c[None, :], mask=m, other=0.0).to(tl.float32)
        a = g / (1.0 + tl.exp(-g)) * u
        tl.store(act + r[:, None].to(tl.int64) * W + c[None, :], a.to(tl.bfloat16), mask=m)

    @triton.jit
    def moe_combine_rows(rows, slot, w, out, T, H, K: tl.constexpr, BR: tl.constexpr,
                         BC: tl.constexpr):
        t = tl.program_id(0) * BR + tl.arange(0, BR)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        tm, cm = t < T, c < H
        acc = tl.zeros((BR, BC), dtype=tl.float32)
        for k in tl.static_range(K):
            s = tl.load(slot + t * K + k, mask=tm, other=-1)
            wk = tl.load(w + t * K + k, mask=tm, other=0.0)
            v = tl.load(rows + s[:, None].to(tl.int64) * H + c[None, :],
                        mask=(s >= 0)[:, None] & cm[None, :], other=0.0).to(tl.float32)
            acc += wk[:, None] * v
        tl.store(out + t[:, None].to(tl.int64) * H + c[None, :], acc,
                 mask=tm[:, None] & cm[None, :])

    @triton.jit
    def moe_rows_bwd(g, rows, row_tk, w, g_rows, g_w, n_end, T, K, H, BR: tl.constexpr,
                     BC: tl.constexpr):
        r = tl.program_id(0) * BR + tl.arange(0, BR)
        live = r < tl.load(n_end)
        tk = tl.load(row_tk + r, mask=live, other=0)
        tok = tk // K
        real = live & (tok < T)
        wr = tl.load(w + tk, mask=real, other=0.0)
        dot = tl.zeros((BR,), dtype=tl.float32)
        for c0 in range(0, H, BC):
            c = c0 + tl.arange(0, BC)
            cm = c < H
            gv = tl.load(g + tok[:, None].to(tl.int64) * H + c[None, :],
                         mask=real[:, None] & cm[None, :], other=0.0)
            ov = tl.load(rows + r[:, None].to(tl.int64) * H + c[None, :],
                         mask=real[:, None] & cm[None, :], other=0.0).to(tl.float32)
            dot += tl.sum(gv * ov, axis=1)
            tl.store(g_rows + r[:, None].to(tl.int64) * H + c[None, :],
                     (gv * wr[:, None]).to(tl.bfloat16), mask=live[:, None] & cm[None, :])
        tl.store(g_w + tk, dot, mask=real)

    @triton.jit
    def moe_swiglu_rows_bwd(gu, g_act, g_gu, n_end, W, BR: tl.constexpr, BC: tl.constexpr):
        r = tl.program_id(0) * BR + tl.arange(0, BR)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        m = (r < tl.load(n_end))[:, None] & (c < W)[None, :]
        row = r[:, None].to(tl.int64) * (2 * W)
        g = tl.load(gu + row + c[None, :], mask=m, other=0.0).to(tl.float32)
        u = tl.load(gu + row + W + c[None, :], mask=m, other=0.0).to(tl.float32)
        ga = tl.load(g_act + r[:, None].to(tl.int64) * W + c[None, :], mask=m,
                     other=0.0).to(tl.float32)
        sg = 1.0 / (1.0 + tl.exp(-g))
        tl.store(g_gu + row + c[None, :], (ga * u * sg * (1.0 + g * (1.0 - sg))).to(tl.bfloat16),
                 mask=m)
        tl.store(g_gu + row + W + c[None, :], (ga * g * sg).to(tl.bfloat16), mask=m)

    @triton.jit
    def moe_sum_back(g_x, slot, g_y, T, H, K: tl.constexpr, BR: tl.constexpr,
                     BC: tl.constexpr):
        t = tl.program_id(0) * BR + tl.arange(0, BR)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        tm, cm = t < T, c < H
        acc = tl.zeros((BR, BC), dtype=tl.float32)
        for k in tl.static_range(K):
            s = tl.load(slot + t * K + k, mask=tm, other=-1)
            acc += tl.load(g_x + s[:, None].to(tl.int64) * H + c[None, :],
                           mask=(s >= 0)[:, None] & cm[None, :], other=0.0).to(tl.float32)
        tl.store(g_y + t[:, None].to(tl.int64) * H + c[None, :], acc.to(tl.bfloat16),
                 mask=tm[:, None] & cm[None, :])

    return dict(swiglu=moe_swiglu_rows, combine=moe_combine_rows,
                rows_bwd=moe_rows_bwd, swiglu_bwd=moe_swiglu_rows_bwd, sum_back=moe_sum_back)


def _k(name: str):
    return _kernels()[name]


def _grid(rows: int, cols: int):
    return (-(-rows // BLOCK_R), -(-cols // BLOCK_C))


def slots(row_tk: torch.Tensor, tokens: int, top_k: int) -> torch.Tensor:
    """[T * K] int32: the row of each pick, -1 where it is not held."""
    n = tokens * top_k
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=row_tk.device)
    out.scatter_(0, row_tk.long(), torch.arange(row_tk.numel(), dtype=torch.int32,
                                                device=row_tk.device))
    return out[:n]


def swiglu(gate_up: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    r, w2 = gate_up.shape
    act = gate_up.new_empty(r, w2 // 2)
    _k("swiglu")[_grid(r, w2 // 2)](gate_up, act, end, w2 // 2, BR=BLOCK_R, BC=BLOCK_C)
    return act


def combine(rows: torch.Tensor, slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[T, H] fp32: each token's weighted sum of its held picks' rows."""
    t, k = weights.shape
    h = rows.shape[1]
    out = torch.empty(t, h, dtype=torch.float32, device=rows.device)
    _k("combine")[_grid(t, h)](rows, slot, weights, out, t, h, K=k, BR=BLOCK_R, BC=BLOCK_C)
    return out


def rows_bwd(g: torch.Tensor, rows: torch.Tensor, row_tk: torch.Tensor,
             weights: torch.Tensor, end: torch.Tensor):
    """(the rows' gradient [R, H] bf16, the weights' gradient [T, K] fp32)."""
    t, k = weights.shape
    r, h = rows.shape
    g_rows = rows.new_empty(r, h)
    g_w = torch.zeros(t * k, dtype=torch.float32, device=rows.device)
    _k("rows_bwd")[(-(-r // BLOCK_R),)](g.contiguous(), rows, row_tk, weights, g_rows, g_w,
                                        end, t, k, h, BR=BLOCK_R, BC=BLOCK_C)
    return g_rows, g_w.view(t, k)


def swiglu_bwd(gate_up: torch.Tensor, g_act: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    r, w2 = gate_up.shape
    g_gu = torch.empty_like(gate_up)
    _k("swiglu_bwd")[_grid(r, w2 // 2)](gate_up, g_act, g_gu, end, w2 // 2, BR=BLOCK_R,
                                        BC=BLOCK_C)
    return g_gu


def sum_back(g_x: torch.Tensor, slot: torch.Tensor, tokens: int, top_k: int) -> torch.Tensor:
    """[T, H] bf16: each token's sum of its held picks' rows of g_x."""
    h = g_x.shape[1]
    g_y = g_x.new_empty(tokens, h)
    _k("sum_back")[_grid(tokens, h)](g_x, slot, g_y, tokens, h, K=top_k, BR=BLOCK_R,
                                     BC=BLOCK_C)
    return g_y
