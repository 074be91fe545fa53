"""MLA's attention sub-block with its projections, norm to the output product (``model.mla``, every layer): the port's span, its device milliseconds a step in the
forward: between the span's CUDA events, summed over the layers, the
card's idle inside included (``harness/spans.py``). The backward's
share falls under ``step.backward``."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.mla")
