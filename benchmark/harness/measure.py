"""One run of a cell: set-up, the window, the traced steps, the check."""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark.harness import compare, registry, trace
from benchmark.harness.counts import attention_bound_s


class Readings:
    """What the per-layer readers take (``metrics/<name>.py``'s ``read``):
    ``trace`` (``trace.summarize``), ``window`` {steps, seconds, work}, the
    model's operations a step and the peak they are held to, the K1 and K2
    calls of the traced steps, the optimizer's device ms a step."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_step(self, key: str) -> float:
        """Device seconds a traced step of a kernel family."""
        return self.trace["family_s_per_step"].get(key, 0.0)

    def attention_bound_s(self, kernel: str) -> Optional[float]:
        calls = self.calls[kernel]
        if not calls:
            return None
        return attention_bound_s(calls, backward=kernel == "k2") / self.trace["steps"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def traced(cell) -> Readings:
    """Window A over ``trace_steps`` steps with the attention calls
    recorded and the optimizer's update between CUDA events, then window B
    over one step."""
    steps = cell.ctx.params.get("trace_steps", 2)
    spans: List = []
    opt = cell.optimizer()
    with trace.attention_calls(cell.causal_attention) as calls, \
            (trace.event_timed(opt, "update", spans) if opt is not None
             else contextlib.nullcontext()):
        def run(n):
            calls["k1"].clear()
            calls["k2"].clear()
            spans.clear()
            for _ in range(n):
                cell.step()
        a = trace.window_a(run, steps, lambda: {"K1": len(calls["k1"]), "K2": len(calls["k2"])})
        k1, k2 = list(calls["k1"]), list(calls["k2"])
        opt_ms = trace.median_ms(spans)

    def plain(n):
        for _ in range(n):
            cell.step()
    b = trace.window_b(plain)
    return Readings(trace=trace.summarize(a, b), calls={"k1": k1, "k2": k2},
                    optimizer_ms=opt_ms, flops_per_step=cell.flops_per_step(),
                    peak_flops=cell.peak_flops())


def run_cell(cell, wl: Dict[str, Any], metrics: Dict[str, List[Dict[str, Any]]], *,
             seconds: float, trace: bool, t_start: float,
             after_window: Optional[Callable[[], None]] = None) -> Dict[str, Any]:
    """Set-up, the window, the traced steps (``trace``), the check; the
    result line's dict. ``t_start``: the process's start on the host
    clock; ``after_window`` runs once the window has closed (logging that
    should not count as set-up)."""
    dev = cell.dev
    t_cell = time.perf_counter()
    cell.setup()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    phases = {"before_cell_s": t_cell - t_start, "cell_setup_s": setup_s - (t_cell - t_start)}

    outs: List[Any] = []
    work = steps = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    marks = [t0]
    while True:
        w, out = cell.step()
        work += w
        steps += 1
        outs.append(out)
        marks.append(time.perf_counter())
        if marks[-1] >= deadline:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    window = {"steps": steps, "seconds": window_s, "work": work}
    host_step_s = sorted(b - a for a, b in zip(marks, marks[1:]))

    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": wl["chips"],
              "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    values: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if trace:
        r = traced(cell)
        r.window = window
        device["busy_s"], device["window_s"] = r.trace["busy_s"], r.trace["window_s"]
        breakdown = r.trace["breakdown"]
        for m in metrics["per_layer"]:
            v = registry.reader(m["name"]).read(r)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        print("trace " + json.dumps({k: r.trace[k] for k in
                                     ("steps", "tries", "complete", "launches_per_step",
                                      "family_s_per_step")}), file=sys.stderr)
    else:
        rate = wl["rate"]
        for m in metrics["end_to_end"]:
            if m["name"] == "setup_s":
                values["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == rate["metric"]:
                values[m["name"]] = {"value": work / window_s, "unit": m["unit"]}
    failed = cell.failed(outs)
    if after_window is not None:
        after_window()
    print("window " + json.dumps({**window, "setup_s": setup_s, **phases, "failed": failed,
                                  "memory_peak_bytes": device["memory_peak_bytes"],
                                  "host_step_s": {"min": host_step_s[0],
                                                  "median": host_step_s[len(host_step_s) // 2],
                                                  "max": host_step_s[-1]}}),
          file=sys.stderr)

    cell.release()
    checks = cell.check(outs)
    correct = compare.passed(checks) and failed == 0
    compare.print_checks(checks)
    result: Dict[str, Any] = {"correct": correct, "attempted": steps, "failed": failed,
                              "metrics": values, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
