"""K1's share of its roofline, in %: the least time the card could take
for the traced steps' K1 calls (each input byte read once, each output
written once; the operations over the peak of their type; a causal mask's
pairs only), over K1's device time by kernel name (with the fp32 route's
mask classifier)."""


def read(r):
    bound = r.attention_bound_s("k1")
    t = r.per_step("K1 attention_fwd") + r.per_step("K1 mask_tile_classes")
    if bound is None or t <= 0:
        return None
    return 100.0 * bound / t
