"""BENCHMARK.json keeps to the contract's shape, and every cell
resolves by name from the benchmark's folders."""

import json
import re

import pytest

from benchmark import readings, run
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_metric_keys_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_resolves_by_name(cell):
    spec = run.load_cell(cell["name"], ROOT)
    assert spec["config"]["name"] == cell["config"]
    assert "arrivals" in spec["traffic"]
    assert (ROOT / "benchmark" / "configs"
            / spec["config"]["policy"]).is_file()
    assert cell["chips"] in (1, 4)
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(readings.load_reader(m["name"]))
        assert cell["name"] in m["workloads"]


def test_names_are_unique_and_configs_used():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
