"""A cell of ``BENCHMARK.json`` resolved by name into its configuration,
its traffic mix and the metrics it reports. Configurations, traffic mixes,
generators and metric readers are files found by the names the JSON
gives, so a new cell or metric is new files and entries, not an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "benchmark"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(workload: str) -> dict:
    """``{"workload", "config", "traffic", "end_to_end", "per_layer"}`` of
    the cell named ``workload``; raises KeyError for an unknown name."""
    cells = {w["name"]: w for w in benchmark()["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    return _resolve(cells[workload])


def cell_for(config: str, traffic: str) -> dict:
    """The cell of a configuration under a traffic mix, whether or not
    ``BENCHMARK.json`` lists it (the CPU tests drive every mix)."""
    for w in benchmark()["workloads"]:
        if (w["config"], w["traffic"]) == (config, traffic):
            return _resolve(w)
    return _resolve({"name": f"{config}.{traffic}", "config": config, "traffic": traffic, "chips": 1})


def _resolve(w: dict) -> dict:
    bench = benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])

    def applies(m):
        return "workloads" not in m or w["name"] in m["workloads"]

    return {
        "workload": w,
        "config": load_json(ROOT / entry["file"]),
        "traffic": load_json(PKG / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (irs, masks, signals)."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def metric_reader(name: str):
    """The ``read(run) -> float | None`` of ``benchmark/metrics/<name>.py``
    (metric names hold dots, so the file is loaded by path)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
