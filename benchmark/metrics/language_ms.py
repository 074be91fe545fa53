"""MERLOT's language-only tower, ahead of the masking: the port's
``model.language`` span, its device milliseconds a step: between the
span's CUDA events, the card's idle inside it included
(``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.language")
