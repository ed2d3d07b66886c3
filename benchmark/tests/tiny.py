"""Tiny copies of the benchmark's cells, for runs on the CPU: the same
runners, limits and checks at boards of 5-8 and a handful of envs, with
the net computed in float32 so that a sound run reads near nought."""

from __future__ import annotations

import time

from benchmark.harness import spec

SMALL = {
    "wire.b24-8192": ({"board_size": 6}, {"batch": 8, "steps": 4, "warmup_launches": 2,
                                          "checked_launches": 2, "trace_launches": 3}),
    "selfplay.b12-32768": ({"board_size": 6, "channels": 8, "blocks": 1, "num_simulations": 6,
                            "temp_moves": 3, "compute_dtype": "float32"},
                           {"batch": 12, "chunk_plies": 3, "checked_envs": 6,
                            "checked_roots": 10}),
    "train.b12-16384": ({"board_size": 6, "channels": 8, "blocks": 1,
                         "compute_dtype": "float32"},
                        {"steps_per_chunk": 2, "envs": 8, "trace_steps": 2,
                         "reference_block": 5}),
}


def cell(name: str, **traffic):
    """The cell ``name`` cut to a CPU's size."""
    c = spec.load_cell(name)
    config, flow = SMALL[name]
    c.config = dict(c.config, **config)
    c.traffic = dict(c.traffic, **{**flow, **traffic})
    return c


def run(c, seed: int = 2_500_000_017, trace: bool = False, seconds: float = 0.3) -> dict:
    return spec.runner(c).run(c, seed=seed, seconds=seconds, trace=trace,
                              start=time.perf_counter(), device="cpu")
