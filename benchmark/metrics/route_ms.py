"""the expert layers' routing launch (``model.moe.route``: the scores, the biased top-K, the weights, the counts and the held experts' layout): the port's span, its device milliseconds a step in the
forward: between the span's CUDA events, summed over the layers, the
card's idle inside included (``harness/spans.py``). The backward's
share falls under ``step.backward``."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.moe.route")
