"""The controls that set each limit's upper reading: on the CPU at a tiny
size each reads worse than the sound program does; on a card, at the
cell's own size (``benchmark/controls.py``), each fails its cell's limit."""

from __future__ import annotations

import pytest
import torch

import tiny
from benchmark import controls
from benchmark.harness import spec

CPU = torch.device("cpu")


def test_wire_control_breaks_the_auto_reset(monkeypatch):
    monkeypatch.setattr(controls, "CHAIN", 12)
    c = tiny.cell("wire.b24-8192", checked_launches=3)
    c.config = dict(c.config, board_size=5)
    got = controls.wire_readings(c, 7, CPU)
    assert got["wire_mismatch"] == 0 and got["control_wire_mismatch"] > 0


def test_selfplay_control_reads_above_the_program():
    c = tiny.cell("selfplay.b12-32768", checked_roots=24)
    c.config = dict(c.config, compute_dtype="bfloat16")
    got = controls.selfplay_readings(c, 7, 0.1, CPU)
    assert got["engine_mismatch"] == 0 and got["action_mismatch"] == 0
    assert got["control_search_tv_ratio"] > got["search_tv_ratio"]


@pytest.mark.parametrize("seed", [7, 2_147_483_659])
def test_train_control_and_faults_read_above_their_limits(seed):
    c = tiny.cell("train.b12-16384")
    got = controls.train_readings(c, seed, CPU)
    faults = {"control", "half_batch"}
    assert set(got) == faults | {"left_out", "control_worst", "program"}
    assert all(got["program"][k] <= c.limits[k] for k in got["program"]), got["program"]
    for reading in (got[k] for k in faults):
        assert any(reading[k] > c.limits[k] for k in c.limits), reading


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark_json()["workloads"]])
def test_controls_fail_at_the_cells_own_size(name, card):
    c = spec.load_cell(name)
    seed = 1_900_000_001
    if c.traffic["kind"] == "wire":
        got = controls.wire_readings(c, seed, card)
        assert got["wire_mismatch"] <= c.limits["wire_mismatch"] < got["control_wire_mismatch"]
    elif c.traffic["kind"] == "selfplay":
        got = controls.selfplay_readings(c, seed, 1.0, card)
        assert got["search_tv_ratio"] <= c.limits["search_tv_ratio"] < got["control_search_tv_ratio"]
    else:
        got = controls.train_readings(c, seed, card)
        assert all(got["program"][k] <= c.limits[k] for k in got["program"])
        for reading in (got["control"], got["half_batch"]):
            assert any(reading[k] > c.limits[k] for k in c.limits), reading
