"""MERLOT's attention-guided span masking: the port's ``model.masking``
span, its device milliseconds a step: between the span's CUDA events,
the card's idle inside it included (``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.masking")
