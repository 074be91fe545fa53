"""The routing step of the DeepSeek-V3 expert layer (``nn/moe.py``): the
hand-written launch (``csrc/moe_route.cu``) and its plain PyTorch version.

Per token, over all E experts of the router (the layer's share of them is
``held``: experts held0 .. held0 + n_held - 1):

    s      = sigmoid(logits)                  fp32
    chosen = the K largest of s + bias        ties to the lower expert
    w_k    = (s_k / sum of the chosen s) * scale

(the correction bias steers the choice only; the weights are the scores
normalised over the chosen ones and scaled, as ``noaux_tc`` with
``norm_topk_prob`` does). Beside them: the counts of picks per expert over
all E (the whole call's, for the bias update, and each row's, for the
sequence-wise balance loss), and the layout of the held experts' picks
for the grouped products: expert by expert, tokens in order, each
expert's rows padded to a multiple of ``ALIGN``. ``row_tk[r]`` is row r's
flat pick ``t * K + k``, or ``T * K`` for a pad or unused row; ``offs`` the
padded end of each held expert's rows. The row count is fixed by the
shapes (``held_rows``: every token picking min(K, n_held) held experts),
so nothing waits on the card. ``stats``: the picks of held experts, those
not placed (0: the layer drops nothing) and the busiest held expert's
picks over their mean, as fp32 device scalars for ``core.trace``'s
counters.

The bias is only read here: the training step moves it once a step from
``counts`` (``models/moe_lm.py``).

``route`` takes the kernel for CUDA tensors and the plain version for CPU
tensors; both give the weights' gradient through ``Route``'s backward.
``gather`` is the library's second launch: the picked tokens' rows copied
into the layout, up to the rows in use.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from merlot_tpu_torch._build import load_library

ALIGN = 16
MAX_TOP_K = 8
MAX_HELD = 32


class Routing(NamedTuple):
    idx: torch.Tensor         # [T, K] int32, the chosen experts in rank order
    weights: torch.Tensor     # [T, K] fp32 (differentiable through ``route``)
    counts: torch.Tensor      # [E] int32, picks per expert
    seq_counts: torch.Tensor  # [B, E] int32, picks per expert in each row
    offs: torch.Tensor        # [n_held] int32, each held expert's padded end row
    row_tk: torch.Tensor      # [held_rows] int32, the flat pick of each row
    stats: torch.Tensor       # [3] fp32: held picks, not placed, max over mean


def held_rows(tokens: int, top_k: int, n_held: int) -> int:
    """The rows of the held experts' layout: the most picks they can get
    (each token picking min(K, n_held) of them), plus each group's padding."""
    return tokens * min(top_k, n_held) + n_held * (ALIGN - 1)


def _check(logits: torch.Tensor, bias: torch.Tensor, top_k: int, seq_len: int,
           held: tuple) -> None:
    t, e = logits.shape
    held0, n_held = held
    if logits.dtype != torch.float32 or bias.dtype != torch.float32 or bias.shape != (e,):
        raise ValueError(f"route: fp32 logits [T, E] and bias [E], got {logits.dtype} "
                         f"{tuple(logits.shape)}, {bias.dtype} {tuple(bias.shape)}")
    if not 0 < top_k <= min(e, MAX_TOP_K) or t % seq_len:
        raise ValueError(f"route: top_k {top_k} of {e} experts (at most {MAX_TOP_K}), "
                         f"{t} tokens in rows of {seq_len}")
    if not (0 <= held0 and 0 < n_held <= MAX_HELD and held0 + n_held <= e):
        raise ValueError(f"route: held experts {held} of {e} (at most {MAX_HELD})")


def route_plain(logits: torch.Tensor, bias: torch.Tensor, *, top_k: int, seq_len: int,
                held: tuple, scale: float) -> Routing:
    """The kernel's function in plain PyTorch (the same outputs; the weights
    not differentiable here: ``route`` gives them their gradient)."""
    _check(logits, bias, top_k, seq_len, held)
    t, e = logits.shape
    held0, n_held = held
    dev = logits.device
    s = torch.sigmoid(logits)
    order = torch.sort(s + bias, dim=-1, descending=True, stable=True).indices[:, :top_k]
    chosen = s.gather(1, order)
    weights = chosen / chosen.sum(-1, keepdim=True) * scale
    counts = torch.bincount(order.reshape(-1), minlength=e).int()
    seq_counts = torch.zeros(t // seq_len, e, dtype=torch.int32, device=dev).scatter_add_(
        1, order.reshape(t // seq_len, -1),
        torch.ones(t // seq_len, seq_len * top_k, dtype=torch.int32, device=dev))
    rows = held_rows(t, top_k, n_held)
    row_tk = torch.full((rows,), t * top_k, dtype=torch.int32, device=dev)
    flat = order.reshape(-1)
    ends, start = [], 0
    for l in range(n_held):
        picks = torch.nonzero(flat == held0 + l).reshape(-1)  # flat picks, tokens in order
        row_tk[start:start + picks.numel()] = picks.int()
        start += -(-picks.numel() // ALIGN) * ALIGN
        ends.append(start)
    held_counts = counts[held0:held0 + n_held].float()
    n = held_counts.sum()
    stats = torch.stack([n, n - (row_tk < t * top_k).sum().float(),
                         torch.where(n > 0, held_counts.max() * n_held / n.clamp_min(1),
                                     torch.zeros((), device=dev))])
    return Routing(order.int(), weights, counts, seq_counts,
                   torch.tensor(ends, dtype=torch.int32, device=dev), row_tk, stats)


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the routing kernel's library."""
    lib = load_library("moe_route")
    fn = lib.merlot_moe_route
    if fn.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr, ptr] + [i] * 6 + [f] + [ptr] * 7 + [i, ptr]
        fn.restype = ctypes.c_int
        lib.merlot_moe_gather.argtypes = [ptr] * 4 + [i] * 4 + [ptr]
        lib.merlot_moe_gather.restype = ctypes.c_int
    return lib


def route_cuda(logits: torch.Tensor, bias: torch.Tensor, *, top_k: int, seq_len: int,
               held: tuple, scale: float) -> Routing:
    """One launch of the routing kernel on contiguous CUDA tensors."""
    _check(logits, bias, top_k, seq_len, held)
    if logits.device.type != "cuda" or bias.device != logits.device:
        raise ValueError("route_cuda: logits and bias on one CUDA device")
    if not logits.is_contiguous() or not bias.is_contiguous():
        raise ValueError("route_cuda: contiguous logits and bias")
    t, e = logits.shape
    held0, n_held = held
    rows = held_rows(t, top_k, n_held)
    ints = dict(dtype=torch.int32, device=logits.device)
    out = Routing(torch.empty(t, top_k, **ints), logits.new_empty(t, top_k),
                  torch.empty(e, **ints), torch.empty(t // seq_len, e, **ints),
                  torch.empty(n_held, **ints), torch.empty(rows, **ints), logits.new_empty(3))
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = load_kernel().merlot_moe_route(
        logits.data_ptr(), bias.data_ptr(), t, e, top_k, seq_len, held0, n_held, scale,
        *(x.data_ptr() for x in out), rows, stream)
    if err != 0:
        raise RuntimeError(f"moe_route kernel failed: cudaError_t {err}")
    return out


class Route(torch.autograd.Function):
    """The routing with the weights' gradient: w_k = scale * s_k / S over the
    chosen experts' scores, S their sum, so dL/ds_j = (scale * g_j - sum_k
    g_k w_k) / S at each chosen j, times s (1 - s) for the logits. The other
    outputs carry no gradient."""

    @staticmethod
    def forward(ctx, logits, bias, top_k: int, seq_len: int, held: tuple, scale: float):
        fn = route_cuda if logits.device.type == "cuda" else route_plain
        r = fn(logits, bias, top_k=top_k, seq_len=seq_len, held=held, scale=scale)
        ctx.save_for_backward(logits, r.idx, r.weights)
        ctx.scale = scale
        ctx.mark_non_differentiable(r.idx, r.counts, r.seq_counts, r.offs, r.row_tk, r.stats)
        return tuple(r)

    @staticmethod
    def backward(ctx, g_idx, g_w, *_):
        logits, idx, w = ctx.saved_tensors
        if g_w is None:
            return (None,) * 6
        pick = idx.long()
        s = torch.sigmoid(logits.gather(1, pick))
        g_s = (ctx.scale * g_w - (g_w * w).sum(-1, keepdim=True)) / s.sum(-1, keepdim=True)
        g_logits = torch.zeros_like(logits).scatter_(1, pick, g_s * s * (1.0 - s))
        return (g_logits,) + (None,) * 5


def route(logits: torch.Tensor, bias: torch.Tensor, *, top_k: int, seq_len: int,
          held: tuple, scale: float) -> Routing:
    """The routing of ``logits`` [T, E] fp32 (T tokens in rows of
    ``seq_len``) with the correction ``bias`` [E]: the kernel on CUDA
    tensors, the plain version on CPU tensors. The weights are
    differentiable in the logits."""
    return Routing(*Route.apply(logits.contiguous(), bias, top_k, seq_len, tuple(held),
                                float(scale)))


def gather(y: torch.Tensor, row_tk: torch.Tensor, end: torch.Tensor, top_k: int) -> torch.Tensor:
    """[R, H] bf16 on the card: row r below ``end`` (an int32 on the card,
    the rows in use) is token row_tk[r] // K's row of y [T, H] bf16, or 0 on
    a pad row; the rows past ``end`` are not written."""
    t, h = y.shape
    if y.dtype != torch.bfloat16 or not y.is_contiguous() or h % 8:
        raise ValueError(f"gather: contiguous bf16 y [T, H] with H a multiple of 8, got "
                         f"{y.dtype} {tuple(y.shape)}")
    if any(x.dtype != torch.int32 or x.device != y.device or not x.is_contiguous()
           for x in (row_tk, end)) or end.numel() != 1:
        raise ValueError("gather: row_tk and the one end int32 on y's device")
    x = y.new_empty(row_tk.numel(), h)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = load_kernel().merlot_moe_gather(y.data_ptr(), row_tk.data_ptr(), end.data_ptr(),
                                          x.data_ptr(), t, top_k, h, row_tk.numel(), stream)
    if err != 0:
        raise RuntimeError(f"moe_gather kernel failed: cudaError_t {err}")
    return x
