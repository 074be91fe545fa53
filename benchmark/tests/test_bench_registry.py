"""The harness finds every configuration, workload, traffic kind and
metric reader by the names in BENCHMARK.json, and takes a cell added as
new files; BENCHMARK.json keeps to the contract's names and keys."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.harness import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert NAME.match(entry["name"])
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    c = registry.config(entry["name"])
    assert Path(registry.ROOT, entry["file"]) == registry.BENCH_DIR / "configs" / f"{entry['name']}.json"
    assert sorted(entry["reduced"]) == sorted(c["reduced"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_files(entry):
    wl = registry.workload(entry["name"])
    assert NAME.match(entry["name"]) and len(entry["why"]) <= 200
    assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    assert hasattr(registry.traffic(wl["traffic"]), "Cell")
    reported = registry.cell_metrics(BENCH, entry["name"])
    names = [m["name"] for m in reported["end_to_end"]]
    assert "setup_s" in names and wl["rate"]["metric"] in names and len(names) >= 2
    assert reported["per_layer"], "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(registry.reader(metric["name"]).read)
        for cell in metric.get("workloads", []):
            assert metric["moves"] in [m["name"] for m in
                                       registry.cell_metrics(BENCH, cell)["end_to_end"]]
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A later PR's cell: a new workload file (and a new metric reader)
    beside the old ones, and entries in BENCHMARK.json; no file changes."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(registry.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((bench_dir / "workloads" / "merlot-base.zeroshot.json").read_text())
    wl["params"] = {**wl["params"], "stories": 8}
    (bench_dir / "workloads" / "merlot-base.zeroshot-b8.json").write_text(json.dumps(wl))
    (bench_dir / "metrics" / "stories_per_batch.py").write_text(
        "def read(r):\n    return r.window['work'] / r.window['steps']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "merlot-base.zeroshot-b8", "config": "merlot-base",
                               "traffic": "zero_shot", "chips": 1, "why": "smaller batches"})
    bench["per_layer"].append({"name": "stories_per_batch.zeroshot-b8", "unit": "stories",
                               "better": "higher", "source": "program_counter",
                               "layer": "step", "moves": "stories_per_s",
                               "workloads": ["merlot-base.zeroshot-b8"]})
    for m in bench["end_to_end"]:
        if m["name"] == "stories_per_s":
            m["workloads"].append("merlot-base.zeroshot-b8")
    assert registry.workload("merlot-base.zeroshot-b8", bench_dir)["params"]["stories"] == 8
    reader = registry.reader("stories_per_batch.zeroshot-b8", bench_dir)

    class R:
        window = {"work": 64, "steps": 8}
    assert reader.read(R) == 8
    got = registry.cell_metrics(bench, "merlot-base.zeroshot-b8")
    assert [m["name"] for m in got["per_layer"]] == ["stories_per_batch.zeroshot-b8"]
    assert {m["name"] for m in got["end_to_end"]} == {"stories_per_s", "setup_s"}
