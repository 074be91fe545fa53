"""Named spans of the program's layers, on the profiler's clock.

``span(name)`` marks a layer's work (``step``, ``step.forward``,
``model.vision``, ...). With no ``torch.profiler`` recording it is one
shared null context and records nothing. While a profiler records (a
benchmark's traced window, the Trainer's ``profile_dir`` window) a span
opens a profiler record function of the name, so it sits in the same
trace and on the same clock as the device's kernels. It is a function's
record (``_RecordFunctionFast``), not ``torch.profiler.record_function``'s
user annotation: the profiler mirrors a user annotation onto the device as
an interval over the span's kernels and the idle gaps between them, which
a reading of the device's busy time would count as work. On CUDA it also
records a timing event on the current stream at entry and at exit, and it
takes the host's clock at both ends. The last ``RING`` root spans, each
with the spans opened inside it, are kept in memory: ``recorded()`` gives
them with the events resolved to milliseconds, ``clear()`` drops them.

``count(name, value)`` is a counter: a device scalar (a tensor the step
already made, such as the expert layer's picks of its held experts) or a
Python number (what path a call took, such as ``gn.kernel``) kept with the
root span open at the call, while a profiler records; nothing otherwise.
Its value is not read during the step: ``counted()`` resolves each root's
counters after the window, as ``recorded()`` resolves the spans' events.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Union

import torch

RING = 64

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_record_function = torch._C._profiler._RecordFunctionFast
_roots: collections.deque = collections.deque(maxlen=RING)
_open = threading.local()


class Record(NamedTuple):
    name: str
    parent: Optional[str]           # the enclosing span's name; None for a root
    host_ms: float
    device_ms: Optional[float]      # between the span's CUDA events; None without


class _Span:
    __slots__ = ("name", "parent", "tree", "ns", "events", "fn", "counters")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.tree = self.parent.tree if self.parent else []
        self.counters = None if self.parent else []
        self.tree.append(self)
        stack.append(self)
        self.fn = _record_function(self.name)
        self.fn.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self.ns
        if self.events is not None:
            self.events[1].record()
        self.fn.__exit__(*exc)
        _open.stack.pop()
        if self.parent is None:
            _roots.append(self.tree)
        return False

    def record(self) -> Record:
        device_ms = None
        if self.events is not None:
            self.events[1].synchronize()
            device_ms = self.events[0].elapsed_time(self.events[1])
        return Record(self.name, self.parent.name if self.parent else None,
                      self.ns / 1e6, device_ms)


def span(name: str):
    """A context that marks ``name``'s work while a profiler records."""
    return _Span(name) if _recording() else _NULL


def count(name: str, value: Union[torch.Tensor, float]) -> None:
    """Keep ``value`` (a tensor scalar, not read now, or a number) as
    counter ``name`` of the open root span, while a profiler records and a
    span is open."""
    if not _recording():
        return
    stack = getattr(_open, "stack", None)
    if stack:
        kept = value.detach() if isinstance(value, torch.Tensor) else value
        stack[0].counters.append((name, kept))


def counted() -> List[Dict[str, List[float]]]:
    """Each finished root span's counters (the same roots, in the same
    order, as ``recorded()``): {name: [value of each call]}, resolved now."""
    out = []
    for tree in list(_roots):
        values: Dict[str, List[float]] = {}
        for name, v in tree[0].counters:
            values.setdefault(name, []).append(float(v))
        out.append(values)
    return out


def recorded() -> List[List[Record]]:
    """The finished root spans, oldest first, each as its spans in the
    order they opened (the root first)."""
    return [[s.record() for s in tree] for tree in list(_roots)]


def clear() -> None:
    _roots.clear()
