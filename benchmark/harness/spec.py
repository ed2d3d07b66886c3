"""Find a cell's parts by name: ``benchmark/workloads/<cell>.json`` names its
configuration (``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<mix>.json``), its chips and the limits of its check;
the mix's ``kind`` names the runner module ``benchmark/harness/<kind>.py``;
``BENCHMARK.json`` lists the per-layer metrics, each read by
``benchmark/metrics/<metric>.py``.  A new cell, mix, configuration or
metric is a new file and a new entry; no file here changes for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic read."""
    w = _read(BENCH / "workloads" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_read(BENCH / "configs" / f"{w['config']}.json"),
                traffic_name=w["traffic"],
                traffic=_read(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=w["limits"])


def runner(cell: Cell):
    """The module that runs the cell's kind of traffic."""
    return importlib.import_module(f"benchmark.harness.{cell.traffic['kind']}")


def benchmark_json() -> dict:
    return _read(ROOT / "BENCHMARK.json")


def metric_reader(name: str):
    """The module ``benchmark/metrics/<name>.py`` (a name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics._" + name.replace(".", "_").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def per_layer(cell_name: str) -> list:
    """(name, unit, reader module) of every per-layer metric that
    ``BENCHMARK.json`` lists for the cell."""
    out = []
    for m in benchmark_json()["per_layer"]:
        if cell_name in m.get("workloads", [cell_name]):
            out.append((m["name"], m["unit"], metric_reader(m["name"])))
    return out


def end_to_end(cell_name: str) -> list:
    """(name, unit) of every end-to-end metric the cell reports."""
    return [(m["name"], m["unit"]) for m in benchmark_json()["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]
