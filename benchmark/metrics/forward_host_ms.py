"""The train step's forward: the port's ``step.forward`` span, its host
milliseconds a step, on the host's clock (``harness/spans.py``)."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "step.forward", "host_ms")
