"""The optimizer's device milliseconds a step: CUDA events around the
optimizer's ``update`` (the median over the traced steps)."""


def read(r):
    return r.optimizer_ms
