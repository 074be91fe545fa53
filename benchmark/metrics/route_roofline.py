"""The routing kernel's share of its roofline, in %: a step's routing
launches' bytes (``counts_moe.route_bytes``: the logits read once, the
picks, weights, counts and the held experts' layout written once) at the
memory's rate, over the ``model.moe.route`` span's device milliseconds a
step, which hold that launch alone (the card's idle inside counts
against it)."""

from benchmark.harness import counts_moe
from benchmark.harness.spans import span_ms


def read(r):
    bound = counts_moe.route_bound_s()
    t = span_ms(r, "model.moe.route")
    if bound is None or not t:
        return None
    return 100.0 * bound / (t / 1e3)
