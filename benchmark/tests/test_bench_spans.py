"""The readers of the port's spans (``harness/spans.py``): window A's kept
try is picked from the recorded roots and averaged per step; every span a
reader reads is one the cell's step opens on the CPU; with no spans every
reader reads None."""

from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import registry, spans
from benchmark.tests.tiny import tiny_cell
from merlot_tpu_torch.core import trace

BENCH = registry.benchmark()
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]


def _readers():
    return sorted({m["name"].split(".")[0] for m in SPAN_METRICS})


def _root(k, device_ms=None):
    """One step's records: ``step`` and its update, times from ``k``."""
    return [trace.Record("step", None, 10.0 * k, device_ms and 10.0 * device_ms),
            trace.Record("step.update", "step", float(k), device_ms and float(device_ms))]


def test_the_kept_try_is_averaged_per_step(monkeypatch):
    # two tries of window A (2 steps each), then window B's one step
    roots = [_root(1, 1), _root(2, 2), _root(3, 4), _root(4, 8), _root(50, 50)]
    roots[3].append(trace.Record("step.update", "step", 1.0, 2.0))  # twice in one step
    monkeypatch.setattr(trace, "recorded", lambda: roots)
    r = SimpleNamespace(trace={"steps": 2})
    assert spans.span_ms(r, "step.update") == (4.0 + 8.0 + 2.0) / 2
    assert spans.span_ms(r, "step.update", "host_ms") == (3.0 + 4.0 + 1.0) / 2
    assert spans.span_ms(r, "step") == (40.0 + 80.0) / 2
    assert spans.span_ms(r, "step.forward") is None
    monkeypatch.setattr(trace, "recorded", lambda: roots[-2:])   # fewer roots than steps + 1
    assert spans.span_ms(r, "step.update") is None
    monkeypatch.setattr(trace, "recorded", lambda: [_root(1), _root(2), _root(3)])
    assert spans.span_ms(r, "step.update") is None                 # no card: no events
    assert spans.span_ms(r, "step.update", "host_ms") == 1.5


@pytest.fixture(scope="module")
def emitted():
    """The span names one CPU step of each cell opens."""
    out = {}
    for w in BENCH["workloads"]:
        cell = tiny_cell(w["name"], fp32=True)
        cell.ctx.params["check_steps"] = 1
        cell.setup()
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            cell.step()
        out[w["name"]] = {s.name for root in trace.recorded() for s in root}
        trace.clear()
    return out


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_a_reader_reads_a_span_the_cell_opens(metric, emitted, monkeypatch):
    read = []
    monkeypatch.setattr(spans, "span_ms", lambda r, name, clock="device_ms": read.append(name))
    registry.reader(metric["name"]).read(SimpleNamespace(trace={"steps": 2}))
    assert len(read) == 1
    for cell in metric["workloads"]:
        assert read[0] in emitted[cell], (cell, read[0])


@pytest.mark.parametrize("name", _readers())
def test_no_spans_read_none(name, monkeypatch):
    r = SimpleNamespace(trace={"steps": 2})
    trace.clear()
    assert registry.reader(name).read(r) is None
    monkeypatch.setitem(__import__("sys").modules, "merlot_tpu_torch.core.trace", None)
    assert registry.reader(name).read(r) is None   # a program without the spans

