"""Every file the harness finds by name loads, and BENCHMARK.json agrees
with the files."""

from __future__ import annotations

import json
import re

import pytest

from portbench import common

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for m in BENCH[k]]
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = common.read_json("configs", f"{entry['name']}.json")
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_file(entry):
    cell, cfg = common.workload(entry["name"])
    assert cell["config"] == entry["config"] == cfg["name"]
    assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
    assert entry["traffic"] == entry["name"].split(".", 1)[1]
    assert (common.HERE / "drivers" / f"{cell['driver']}.py").exists()
    e2e, per = common.cell_metrics(BENCH, entry["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_reader(entry):
    reader = common.load_module("metrics", entry["name"])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    moves = [m for m in BENCH["end_to_end"] if m["name"] == entry["moves"]]
    assert moves and all(w in moves[0]["workloads"] for w in entry["workloads"])
    assert reader.read({}) is None


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
