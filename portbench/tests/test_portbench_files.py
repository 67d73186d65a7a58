"""Every configuration, cell, traffic mix and metric of BENCHMARK.json is
found by name, and its names and units keep to the allowed characters."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert NAME.match(cfg["name"]) and all(NAME.match(k) for k in cfg["reduced"])
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert (ROOT / "portbench" / "programs" / f"{data['program']}.py").exists()
    assert (ROOT / "portbench" / "reference" / f"{data['program']}.py").exists()
    assert sum(c["file"] == cfg["file"] for c in BENCH["configs"]) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = harness.load_cell(cell)
    assert NAME.match(cell) and NAME.match(c.entry["traffic"]) and NAME.match(c.entry["config"])
    assert (ROOT / "portbench" / "traffic" / f"{c.mix['driver']}.py").exists()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
    assert c.entry["chips"] == 1
    assert set(c.spec["limits"]) and all(r["counter"] for r in c.spec["route"])


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in BENCH["per_layer"]:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert callable(harness.metric_reader(metric["name"]))
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
