"""BENCHMARK.json against the contract's shape, and the result line of a
dry run on the CPU."""

import json
import re

import pytest

from benchmark.lib import runner, spec
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names + CELLS)
    assert "setup_s" in names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        mover = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mover.get("workloads", CELLS))
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200 and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (spec.PKG / "traffic" / f"{w['traffic']}.json").is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(workload):
    cell = spec.cell(workload)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("mix", [("ambi64_10s_split", "render"), ("ambi64_room10s_perc60_bf16", "live")])
def test_result_line_schema(mix, traced):
    cell = spec.cell_for(*mix)
    res = tiny.run(mix, 2**31 + 7, traced=traced)
    line = json.loads(runner.result_line(res))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
    assert line["correct"] is True and line["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    want = cell["per_layer"] if traced else cell["end_to_end"]
    assert set(line["metrics"]) <= {m["name"] for m in want}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not traced:  # host-clock metrics exist on any device
        assert set(line["metrics"]) == {m["name"] for m in want}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
