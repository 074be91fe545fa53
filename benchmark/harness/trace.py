"""What a ``--trace 1`` run reads: torch.profiler windows over a few of
the window's own steps, the attention calls they made and the optimizer's
device time, reduced to the numbers the per-layer readers take.

Window A traces the card alone (the host's tracing stretches a host-bound
step): busy seconds (the union of the device's operation intervals),
device time by operation and by kernel family, and the attention kernels'
time. Window B, one step with the host traced too, gives the runtime's
kernel launches per step and what the host was doing in the device's
longest idle gaps. A profile now and then loses kernel records; window A
is taken again (up to ``TRIES`` times) until it holds every K1 and K2
launch the wrappers counted.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

TRIES = 3
TOP = 10
NAME_CHARS = 200    # a kernel's C++ name is cut to this in the breakdown
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernelEx")


def kernel_family(name: str) -> str:
    """A coarse family of a kernel name (copied from ``chip_smoke.py``):
    the port's kernels, library matmuls and convolutions, or the rest."""
    low = name.lower()
    if "mask_tile_classes" in low:
        return "K1 mask_tile_classes"
    if any(t in low for t in ("::gn_kernel<", "gn_kerneli")):
        return "K4 groupnorm"
    if "ln_matmul" in low:
        return "K5 ln_matmul"
    if "attention_decode" in low:
        return "K3 attention_decode"
    if "attention_fwd" in low:
        return "K1 attention_fwd"
    if "attention_bwd" in low:
        return "K2 attention_bwd"
    if any(t in low for t in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet", "matmul")):
        return "matmul"
    return "elementwise, reduction and other"


@contextlib.contextmanager
def patched(module, name: str, wrap: Callable):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _call_record(q3, k3, mask, num_heads, colsum, causal: bool) -> Dict[str, Any]:
    b, sq, hd = q3.shape
    rec = {"b": b, "sq": sq, "sk": k3.shape[1], "heads": num_heads, "d": hd // num_heads,
           "elem": q3.element_size(), "masked": mask is not None, "colsum": colsum}
    if causal and mask is not None:
        rec["pairs"] = int(mask.count_nonzero().item())
    return rec


@contextlib.contextmanager
def attention_calls(causal: bool = False):
    """Records every K1 and K2 call's shapes into {'k1': [...], 'k2': [...]}
    (``counts.attention_bound_s`` takes them). ``causal``: the masks let
    through only the pairs they hold, which the records count."""
    from merlot_tpu_torch.ops import cuda_attention as ca
    calls: Dict[str, List[Dict[str, Any]]] = {"k1": [], "k2": []}

    def fwd(f):
        def rec(q3, k3, v3, mask, *, num_heads, softmax_fp32, collect_colsum, **kw):
            calls["k1"].append(_call_record(q3, k3, mask, num_heads, collect_colsum, causal))
            return f(q3, k3, v3, mask, num_heads=num_heads, softmax_fp32=softmax_fp32,
                     collect_colsum=collect_colsum, **kw)
        return rec

    def bwd(f):
        def rec(q3, k3, v3, mask, g3, gcol, *, num_heads, **kw):
            calls["k2"].append(_call_record(q3, k3, mask, num_heads, gcol is not None, causal))
            return f(q3, k3, v3, mask, g3, gcol, num_heads=num_heads, **kw)
        return rec

    with patched(ca, "attention_fwd_cuda", fwd), patched(ca, "attention_bwd_cuda", bwd):
        yield calls


@contextlib.contextmanager
def event_timed(obj, name: str, spans: list):
    """CUDA events around each call of ``obj.name`` into ``spans``."""
    def wrap(f):
        def timed(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = f(*a, **kw)
            end.record()
            spans.append((start, end))
            return out
        return timed
    with patched(obj, name, wrap):
        yield


def _union_seconds(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def _device_events(prof):
    return [e for e in prof.events() if e.device_type.name == "CUDA"]


def window_a(run_steps: Callable[[int], None], steps: int,
             expected: Callable[[], Dict[str, int]]) -> Dict[str, Any]:
    """The card-only profile of ``steps`` steps: busy and window seconds,
    device seconds and launches by kernel name and by family. ``expected``
    gives the K1/K2 launches the wrappers counted over the run."""
    from torch.profiler import ProfilerActivity, profile
    out: Dict[str, Any] = {}
    for tries in range(1, TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_steps(steps)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        events = _device_events(prof)
        by_name: Dict[str, List[float]] = {}
        for e in events:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += (e.time_range.end - e.time_range.start) / 1e6
            acc[1] += 1
        families: Dict[str, List[float]] = {}
        for name, (s, n) in by_name.items():
            acc = families.setdefault(kernel_family(name), [0.0, 0])
            acc[0] += s
            acc[1] += n
        want = expected()
        held = {"K1": families.get("K1 attention_fwd", [0, 0])[1],
                "K2": families.get("K2 attention_bwd", [0, 0])[1]}
        out = {"tries": tries, "steps": steps, "window_s": window_s,
               "busy_s": _union_seconds((e.time_range.start, e.time_range.end)
                                        for e in events),
               "by_name": by_name, "families": families,
               "launches_counted": want, "launches_held": held}
        if all(held[k] >= want.get(k, 0) for k in held):
            out["complete"] = True
            return out
    out["complete"] = False
    return out


def _innermost_at(host, times):
    """For each time (ascending), the name of the innermost host operation
    open then (the last one started that has not ended), or None."""
    host = sorted(host, key=lambda e: e[0])
    stack, out, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        # an op that ended inside an enclosing one that is still open
        alive = [e for e in stack if e[1] >= t]
        stack = alive
        out.append(alive[-1][2] if alive else None)
    return out


def window_b(run_steps: Callable[[int], None]) -> Dict[str, Any]:
    """One step with the host traced too: the runtime's kernel launches,
    and the device's idle time by what the host was doing, the innermost
    host operation open where each gap starts (summed over the gaps)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps(1)
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(1 for e in events if e.device_type.name == "CPU"
                   and any(e.name.startswith(n) for n in LAUNCH_NAMES))
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type.name == "CUDA")
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type.name == "CPU"
            and not e.name.startswith(("cuda", "cuLaunch", "cuMem", "cuStream", "Activity"))]
    gaps = []
    end = None
    for s0, e0 in dev:
        if end is not None and s0 > end:
            gaps.append((end, s0 - end))
        end = e0 if end is None else max(end, e0)
    labelled: Dict[str, float] = {}
    for (at, length), name in zip(gaps, _innermost_at(host, [g[0] for g in gaps])):
        label = name or "host outside any traced op"
        labelled[label] = labelled.get(label, 0.0) + length / 1e6
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:TOP]
    return {"launches": launches, "idle_gaps": [[k, v] for k, v in idle]}


def summarize(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """The per-step numbers the readers take, and the ``breakdown``."""
    steps = a["steps"]
    fam = {k: v[0] / steps for k, v in a["families"].items()}
    top = sorted(a["by_name"].items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": a["busy_s"], "window_s": a["window_s"], "steps": steps,
        "complete": a["complete"], "tries": a["tries"],
        "family_s_per_step": fam,
        "launches_per_step": b["launches"],
        "breakdown": {"device_ops": [[n[:NAME_CHARS], v[0]] for n, v in top],
                      "idle_gaps": b["idle_gaps"]},
    }


def median_ms(spans: list) -> Optional[float]:
    return statistics.median(s.elapsed_time(e) for s, e in spans) if spans else None
