"""The port's counters (``merlot_tpu_torch.core.trace.count``) over window
A's kept try, as ``spans.py`` reads its spans: a counter's values within
each of the kept steps' roots, averaged over the values and the steps.
A program without the counters, or a counter the steps did not count,
reads None.
"""

from __future__ import annotations

from typing import Optional


def counter_mean(r, name: str) -> Optional[float]:
    try:
        from merlot_tpu_torch.core import trace
    except ImportError:
        return None
    counted = getattr(trace, "counted", None)
    if counted is None:
        return None
    roots = counted()
    n = r.trace["steps"]
    if len(roots) <= n:
        return None
    values = []
    for root in roots[-1 - n:-1]:
        if not root.get(name):
            return None
        values.extend(root[name])
    return sum(values) / len(values)
