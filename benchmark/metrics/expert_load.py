"""The expert layers' load on the held experts: the busiest held expert's
picks over the held experts' mean, a step's layers averaged (1 is even).
The port's counter ``moe.load_max_over_mean`` (``harness/counters.py``)."""

from benchmark.harness.counters import counter_mean


def read(r):
    return counter_mean(r, "moe.load_max_over_mean")
