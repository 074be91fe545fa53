"""K2's share of its roofline, in %: the least time the card could take
for the traced steps' K2 calls (the backward's five products; each input,
cotangent and gradient byte once), over K2's device time by kernel name."""


def read(r):
    bound = r.attention_bound_s("k2")
    t = r.per_step("K2 attention_bwd")
    if bound is None or t <= 0:
        return None
    return 100.0 * bound / t
