"""Operations and bytes of the DeepSeek-V3 block's cells (the expert layer
and MLA), beside ``counts.py``'s, which take one head dim.

A count is the work the algorithm needs, as in ``counts.py``: each input
byte read once, each output written once, no recompute (the expert
layer's backward recomputes its products; the counts leave that out),
causal attention over the (query, key) pairs it needs only, the held
experts over the tokens routed to them.

``MLA`` and ``ROUTE`` describe the shapes of the cell that runs: its
``Cell`` sets them in set-up (``describe``), and the readers of
``k1_mla_roofline``, ``k2_mla_roofline`` and ``route_roofline`` read them;
unset, those readers find nothing to read.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

from benchmark.harness.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, bound, dense

MLA: Optional[Dict[str, int]] = None     # {"d_qk", "d_v"}
ROUTE: Optional[Dict[str, int]] = None   # {"tokens", "experts", "top_k", "held", "seq", "layers"}


def describe(mla: Dict[str, int], route: Dict[str, int]) -> None:
    global MLA, ROUTE
    MLA, ROUTE = dict(mla), dict(route)


def causal_pairs(b: int, s: int) -> int:
    return b * s * (s + 1) // 2


def mla_attn_work(b: int, s: int, heads: int, d_qk: int, d_v: int, *, backward: bool,
                  elem: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of one causal MLA attention call over [b, s] tokens.
    Forward: S = QK^T (d_qk) and ctx = PV (d_v); backward: S again, dP =
    dO V^T and dV = P^T dO (d_v), dQ = dS K and dK = dS^T Q (d_qk). Bytes:
    q, k (d_qk) and v, ctx (d_v) once; backward q, k, v, dO once and dQ,
    dK, dV once."""
    pairs = causal_pairs(b, s)
    per_pair = (3 * d_qk + 2 * d_v) if backward else (d_qk + d_v)
    flops = 2.0 * heads * pairs * per_pair
    rows = b * s * heads * elem
    nbytes = rows * ((4 * d_qk + 3 * d_v) if backward else (2 * d_qk + 2 * d_v))
    return flops, nbytes


def mla_bound_s(calls: Iterable[Dict[str, Any]], backward: bool) -> Optional[float]:
    """Summed least seconds of recorded K1 (K2 with ``backward``) calls at
    MLA's head dims (``MLA``), at the bf16 peak or the memory's rate."""
    if MLA is None:
        return None
    total, n = 0.0, 0
    for c in calls:
        if c["d"] != MLA["d_qk"] or c["sq"] != c["sk"]:
            continue
        flops, nbytes = mla_attn_work(c["b"], c["sq"], c["heads"], MLA["d_qk"], MLA["d_v"],
                                      backward=backward, elem=c["elem"])
        total += bound(flops, nbytes, PEAK_BF16_FLOPS)[0]
        n += 1
    return total if n else None


def route_bytes(tokens: int, experts: int, top_k: int, held: int, seq: int) -> float:
    """One routing launch: the fp32 logits and bias read once; the picks,
    weights, counts (whole and per row), offsets, the held experts' rows
    (``ops/moe_route.held_rows``) and the moved bias written once."""
    rows = tokens * min(top_k, held) + held * 15
    reads = 4 * (tokens * experts + experts)
    writes = 4 * (2 * tokens * top_k + experts + (tokens // seq) * experts + held + rows + 3
                  + experts)
    return float(reads + writes)


def route_bound_s() -> Optional[float]:
    """The least seconds of one step's routing launches (``ROUTE``)."""
    if ROUTE is None:
        return None
    r = ROUTE
    nbytes = route_bytes(r["tokens"], r["experts"], r["top_k"], r["held"], r["seq"])
    return r["layers"] * nbytes / PEAK_HBM_BYTES


def moe_lm_forward_flops(m: Dict[str, Any], batch: int, seq: int,
                         held_picks: Optional[float] = None) -> float:
    """The forward's operations at [batch, seq] tokens: per layer MLA's
    four projections and causal attention; the dense layers' SwiGLU; each
    expert layer's router, shared experts and, per pick of a held expert
    (``held_picks`` a layer, the tokens routed to this share; by default
    an even share), one expert; the head over the (sliced) vocabulary."""
    h, n = m["hidden_size"], m["num_attention_heads"]
    nope, rope, dv, lat = (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"],
                           m["kv_lora_rank"])
    tokens = batch * seq
    e, k, (_, held) = m["n_routed_experts"], m["num_experts_per_tok"], m["experts_held"]
    if held_picks is None:
        held_picks = tokens * k * held / e
    w = m["moe_intermediate_size"]
    mla = (dense(tokens, h, n * (nope + rope)) + dense(tokens, h, lat + rope)
           + dense(tokens, lat, n * (nope + dv)) + dense(tokens, n * dv, h)
           + mla_attn_work(batch, seq, n, nope + rope, dv, backward=False)[0])
    dense_mlp = dense(tokens, h, 3 * m["intermediate_size"])
    moe = (dense(tokens, h, e) + dense(tokens, h, 3 * m["n_shared_experts"] * w)
           + dense(held_picks, h, 3 * w))
    n_dense = m["first_k_dense_replace"]
    layers = m["num_hidden_layers"]
    return (layers * mla + n_dense * dense_mlp + (layers - n_dense) * moe
            + dense(tokens, h, m["vocab_size"]))
