"""AdamW's update (``MerlotAdamW.update``), the in-program twin of
``optimizer_ms``: the port's ``step.update`` span, its device
milliseconds a step: between the span's CUDA events, the card's idle
inside it included (``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "step.update")
