"""The train step's forward: the batch to the card, the model or loss
function through its loss: the port's ``step.forward`` span, its device
milliseconds a step: between the span's CUDA events, the card's idle
inside it included (``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "step.forward")
