"""Kernel launches a step: the CUDA runtime's launch calls in one traced
step (torch.profiler with the host traced)."""


def read(r):
    n = r.trace["launches_per_step"]
    return float(n) if n else None
