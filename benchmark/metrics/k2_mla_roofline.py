"""K2's share of its roofline at MLA's heads, in %: as ``k1_mla_roofline``
for the backward's five products (S again, dP and dV at 128, dQ and dK at
192) and its bytes, over K2's device time by kernel name."""

from benchmark.harness import counts_moe


def read(r):
    bound = counts_moe.mla_bound_s(r.calls["k2"], backward=True)
    t = r.per_step("K2 attention_bwd")
    if bound is None or t <= 0:
        return None
    return 100.0 * bound / r.trace["steps"] / t
