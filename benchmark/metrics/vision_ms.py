"""MERLOT's vision tower (the LiteResNet stem, the ViT, the final norm):
the port's ``model.vision`` span, its device milliseconds a step:
between the span's CUDA events, the card's idle inside it included
(``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.vision")
