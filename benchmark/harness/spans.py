"""The port's own spans (``merlot_tpu_torch.core.trace``) over window A's
kept try: a span's device or host milliseconds, summed within a step and
averaged over the steps.

A ``--trace 1`` run records spans only while a profiler records: window
A's tries, then window B's one step, each step one root span. The kept try
is the last, so its steps are the ``steps`` roots just before the last
root (window B's step, stretched by the host's tracing). A program without
the spans, or a span the steps did not open, reads None.
"""

from __future__ import annotations

from typing import Optional


def _window_a_steps(r) -> Optional[list]:
    try:
        from merlot_tpu_torch.core import trace
    except ImportError:
        return None
    roots = trace.recorded()
    n = r.trace["steps"]
    return roots[-1 - n:-1] if len(roots) > n else None


def span_ms(r, name: str, clock: str = "device_ms") -> Optional[float]:
    """``name``'s mean milliseconds a step on ``clock`` ('device_ms',
    between the span's CUDA events, the card's idle inside it included;
    or 'host_ms')."""
    steps = _window_a_steps(r)
    if not steps:
        return None
    per_step = []
    for root in steps:
        times = [getattr(s, clock) for s in root if s.name == name]
        if not times or None in times:
            return None
        per_step.append(sum(times))
    return sum(per_step) / len(per_step)
