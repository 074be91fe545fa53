"""the held experts' products (``model.moe.experts``: the gather, the grouped products and the weighted scatter-add): the port's span, its device milliseconds a step in the
forward: between the span's CUDA events, summed over the layers, the
card's idle inside included (``harness/spans.py``). The backward's
share falls under ``step.backward``."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.moe.experts")
