"""BENCHMARK.json against its contract, and every cell resolving by name to
its configuration, traffic, runner, metric readers and chips."""

from __future__ import annotations

import importlib
import json
import math
import re

import pytest

from benchmark.harness import spec

B = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]
PER_LAYER = [m["name"] for m in B["per_layer"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"][:2] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert len(json.dumps(B)) < 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = B["run_seconds"]
    assert 1 <= rs <= 51 and rs == int(rs)
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_bounds():
    names = [c["name"] for c in B["configs"]] + CELLS + [m["name"] for m in B["end_to_end"]] \
        + PER_LAYER
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in B["configs"]}) == len(B["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = [m["name"] for m in B["end_to_end"]] + PER_LAYER
    assert len(set(metrics)) == len(metrics)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])


def test_four_chip_cells_are_few():
    fours = sum(w["chips"] == 4 for w in B["workloads"])
    assert all(w["chips"] in (1, 4) for w in B["workloads"])
    assert fours <= max(1, math.floor(0.25 * len(CELLS)))


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    entry = next(w for w in B["workloads"] if w["name"] == name)
    cell = spec.load_cell(name)
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert cell.config["name"] == entry["config"]
    config = next(c for c in B["configs"] if c["name"] == entry["config"])
    assert config["file"] == f"benchmark/configs/{entry['config']}.json"
    assert config["source"] == cell.config["source"]
    runner = spec.runner(cell)
    assert callable(runner.run)
    assert cell.limits
    e2e = [m for m, _ in spec.end_to_end(name)]
    assert "setup_s" in e2e and cell.traffic["metric"] in e2e and len(e2e) == 2
    layer = spec.per_layer(name)
    assert layer
    moves = {m["name"]: m["moves"] for m in B["per_layer"]}
    assert all(moves[m] in e2e for m, _, _ in layer)


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_resolves(name):
    """Each per-layer entry has its reader, and ``BENCHMARK.json`` alone
    says its unit, layer, moved metric and cells: the reader holds none
    of them, so a later cell that reports it changes no file here."""
    entry = next(m for m in B["per_layer"] if m["name"] == name)
    reader = spec.metric_reader(name)
    assert callable(reader.read)
    assert not {"UNIT", "BETTER", "SOURCE", "LAYER", "MOVES", "WORKLOADS"} & set(vars(reader))
    for cell in entry["workloads"]:
        assert cell in CELLS
        e2e = [m for m, _ in spec.end_to_end(cell)]
        assert entry["moves"] in e2e


def test_roofline_and_mfu_names():
    for m in B["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_one_name_each():
    for m in B["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_every_runner_module_imports_without_the_port():
    for kind in {spec.load_cell(c).traffic["kind"] for c in CELLS}:
        importlib.import_module(f"benchmark.harness.{kind}")
