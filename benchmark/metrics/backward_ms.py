"""The train step's backward and the gathering of its gradients: the port's
``step.backward`` span, its device milliseconds a step: between the
span's CUDA events, the card's idle inside it included
(``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "step.backward")
