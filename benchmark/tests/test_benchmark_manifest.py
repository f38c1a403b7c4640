"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of the benchmark."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    assert M["command"][1].startswith("benchmark/")
    assert (ROOT / M["command"][1]).is_file()


def test_names_units_and_entries():
    names = [c["name"] for c in M["configs"]] + \
        [w["name"] for w in M["workloads"]] + \
        [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["architecture"]
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
        assert (ROOT / "benchmark/workloads" / f"{w['name']}.json").is_file()
        assert (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").is_file()
        cell = json.loads((ROOT / "benchmark/workloads"
                           / f"{w['name']}.json").read_text())
        assert (ROOT / "benchmark/loops" / f"{cell['loop']}.py").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert (ROOT / "benchmark/metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    def reports(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = {m["name"] for m in M["end_to_end"] if reports(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in M["per_layer"] if reports(m)]
    assert layer
    for m in layer:
        moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        assert reports(moved), (m["name"], cell)
