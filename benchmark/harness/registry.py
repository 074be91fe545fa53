"""Finds a cell's files by the names in BENCHMARK.json.

    workloads/<cell>.json     config name, traffic kind and its parameters,
                              the rate it reports, the limits of its checks
    configs/<config>.json     the model configuration as it is run
    traffic/<kind>.py         the driver of one kind of window (``Cell``)
    metrics/<metric>.py       the reader of one per-layer metric (``read``);
                              a split name such as ``mfu.pretrain`` falls
                              back to the reader of its first part, ``mfu.py``

A later cell, configuration or metric is a new file here and new entries
in BENCHMARK.json; nothing that is already here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def workload(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    return _json(bench_dir / "workloads" / f"{name}.json")


def config(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    return _json(bench_dir / "configs" / f"{name}.json")


def traffic(kind: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(bench_dir / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader of ``metric``: metrics/<metric>.py, else the file of the
    name's first part."""
    whole = bench_dir / "metrics" / f"{metric}.py"
    path = whole if whole.is_file() else bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    return _module(path, "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))


def _applies(entry: Dict[str, Any], cell: str, e2e_names: Optional[List[str]] = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry.get("moves") in e2e_names


def cell_metrics(bench: Dict[str, Any], cell: str) -> Dict[str, List[Dict[str, Any]]]:
    """The end-to-end and per-layer entries of BENCHMARK.json that ``cell``
    reports."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    names = [m["name"] for m in e2e]
    return {"end_to_end": e2e,
            "per_layer": [m for m in bench["per_layer"] if _applies(m, cell, names)]}
