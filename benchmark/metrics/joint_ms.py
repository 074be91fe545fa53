"""MERLOT's joint encoder over the frames and the captions: the port's
``model.joint`` span, its device milliseconds a step: between the span's
CUDA events, the card's idle inside it included (``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.joint")
