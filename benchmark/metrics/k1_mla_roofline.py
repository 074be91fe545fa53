"""K1's share of its roofline at MLA's heads, in %: the least time the card
could take for the traced steps' K1 calls, Q.K at 192 and P.V at 128 over
the causal pairs only (``counts_moe.mla_attn_work``; each input byte read
once, each output written once; the bf16 peak), over K1's device time by
kernel name. The cell's K1 calls are all MLA's."""

from benchmark.harness import counts_moe


def read(r):
    bound = counts_moe.mla_bound_s(r.calls["k1"], backward=False)
    t = r.per_step("K1 attention_fwd")
    if bound is None or t <= 0:
        return None
    return 100.0 * bound / r.trace["steps"] / t
