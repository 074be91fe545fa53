"""MERLOT's LiteResNet stem, the vision tower's convolutions and its 54
GroupNorms: the port's ``model.vision.stem`` span (a child of
``model.vision``), its device milliseconds a step between the span's CUDA
events, the card's idle inside it included (``harness/spans.py``). The
forward only: the stem's backward runs in ``step.backward``."""

from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, "model.vision.stem")
