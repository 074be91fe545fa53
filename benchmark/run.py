"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files (``harness/registry.py``) say what to build and drive.
Set-up (the process's start to the window: imports, the kernels' build or
load from the checkout's ``build/``, the weights from the seed, every
shape of the window run once) is ``setup_s``. The window drives the cell's
closed loop for ``--seconds`` and its rate is all the work over all the
window's time. With ``--trace 1`` a few more steps are traced after the
window and the cell's per-layer metrics are read from them. The program's
state is then freed and the reference judges what the window produced;
each compared number is printed beside its limit as the last lines of
standard error and under ``checks``, the last key of the result line, the
last line of standard output.

Exits 2 without a CUDA card (or with fewer than the cell asks for), 3 when
the port is missing, 4 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "merlot_tpu")


def loaded_forbidden(modules=None) -> list:
    """Top-level module names, compared whole, of JAX or the JAX package
    among ``modules`` (``sys.modules`` by default)."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


def cache_env() -> None:
    """Every compiler cache inside the checkout, at fixed paths (the port
    builds its kernels into ``build/merlot_tpu_torch`` itself)."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))


def host_info(dev_count: int) -> dict:
    """The host's CPU (its model name and cpuinfo's codes) and the cards'
    name, power limit and clocks."""
    info = {"cpu": None, "machine": platform.machine(), "cpus": os.cpu_count()}
    try:
        with open("/proc/cpuinfo") as f:
            fields = {}
            for ln in f:
                k, _, v = ln.partition(":")
                fields.setdefault(k.strip().lower(), v.strip())
        info["cpu"] = fields.get("model name")
        info["cpuinfo"] = {k: fields[k] for k in ("vendor_id", "cpu family", "model",
                                                  "stepping", "cpu mhz", "cpu implementer",
                                                  "cpu part", "hardware") if k in fields}
    except OSError:
        pass
    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["cards"] = [ln.strip() for ln in out.stdout.splitlines()[:dev_count]]
    except (OSError, subprocess.SubprocessError):
        info["cards"] = None
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    try:
        import merlot_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port merlot_tpu_torch is not in this checkout: {e}", file=sys.stderr)
        return 3
    import torch

    from benchmark.harness import registry
    from benchmark.harness.cell import Context
    from benchmark.harness.measure import run_cell

    wl = registry.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    bench = registry.benchmark()
    ctx = Context(config=registry.config(wl["config"]), params=wl["params"],
                  limits=wl["limits"], seed=args.seed, device=torch.device("cuda", 0))
    cell = registry.traffic(wl["traffic"]).Cell(ctx)
    log_host = lambda: print("host " + json.dumps(host_info(wl["chips"])),  # noqa: E731
                             file=sys.stderr, flush=True)
    result = run_cell(cell, wl, registry.cell_metrics(bench, args.workload),
                      seconds=args.seconds, trace=bool(args.trace), t_start=T0,
                      after_window=log_host)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
