"""The share of the step's GroupNorm calls that ran the fused kernels (K4
forward, K4B backward) rather than the ATen composition: the mean of the
port's counter ``gn.kernel``, 1 for a call on the kernels and 0 for one on
the composition (``harness/counters.py``)."""

from benchmark.harness.counters import counter_mean


def read(r):
    return counter_mean(r, "gn.kernel")
