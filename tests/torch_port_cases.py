"""Inputs shared by the port's pins and ``chip_smoke.py``, torch only.

Seeded net parameters and observations for the net pins; the torch twins
of the evaluators in ``tests/test_mcts_exact.py`` (the same float32
operations, so both sides compute the same bits); and a table net for the
deterministic arena.  ``chip_smoke.py`` uses them on the card, where jax is
not installed, so this module imports torch, numpy and the port only.
"""

from __future__ import annotations

import numpy as np
import torch

from twixt_for_open_spiel_tpu_torch.models.network import AZNet
from twixt_for_open_spiel_tpu_torch.ops import bitboard, state, step


def random_state_dict(board_size: int, channels: int, blocks: int, seed: int) -> dict:
    """Float32 parameters of an ``AZNet`` drawn by numpy from ``seed``, none
    trivial: kernels N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.01) and
    biases N(0, 0.01), the value head's output kernel included.  Carry them
    to flax with ``convert.params_to_flax``."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in AZNet(board_size, channels, blocks).state_dict().items():
        shape = tuple(p.shape)
        if p.ndim > 1:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * rng.standard_normal(shape)
            if "norm" in name and name.endswith("weight"):
                a += 1.0
        state[name] = torch.from_numpy(a.astype(np.float32))
    return state


def random_obs(batch: int, board_size: int, seed: int, density: float = 0.2) -> np.ndarray:
    """Binary float32 observations ``[B, 12, n, n-2]`` drawn by numpy."""
    rng = np.random.default_rng(seed)
    shape = (batch, 12, board_size, board_size - 2)
    return (rng.random(shape) < density).astype(np.float32)


def make_table(a_dim: int) -> np.ndarray:
    """Static pseudo-random logits, exactly representable on both sides
    (``test_mcts_exact._make_table``)."""
    return (
        ((np.arange(a_dim) * 2654435761) % 97).astype(np.float32)
        / np.float32(24.0)
        - np.float32(2.0)
    )


def table_evaluator(a_dim: int):
    """Fixed logits and a value of the move counter,
    f32((7*mc mod 11) - 5) / 7 (``test_mcts_exact.table_evaluator``)."""
    table = torch.from_numpy(make_table(a_dim))

    def evaluate(params, bs, generator):
        del params, generator
        b = bs.current_player.shape[-1]
        logits = table.to(bs.red.device).expand(b, a_dim)
        mc = bs.move_counter.float()
        return logits, (torch.remainder(mc * 7.0, 11.0) - 5.0) / 7.0

    return evaluate


def uniform_evaluator(a_dim: int):
    """Zero logits, zero value (``test_mcts_exact.uniform_evaluator``)."""

    def evaluate(params, bs, generator):
        del params, generator
        b = bs.current_player.shape[-1]
        dev = bs.red.device
        return (torch.zeros((b, a_dim), dtype=torch.float32, device=dev),
                torch.zeros(b, dtype=torch.float32, device=dev))

    return evaluate


EVALUATORS = {"table": table_evaluator, "uniform": uniform_evaluator}


def arena_table_params(a_dim: int, side: int, device) -> tuple:
    """Side ``side``'s parameters of the arena's table net: a logit row
    (the table, reversed for side 1) and a value offset."""
    table = make_table(a_dim)
    if side:
        table = table[::-1].copy()
    return torch.from_numpy(table).to(device), float(3 * side + 1)


def arena_table_net(params, obs):
    """``net_apply`` of a table net: the parameters' logit row for every
    env, and the value f32(((7*count + offset) mod 11) - 5) / 7 of the
    observation's set-plane count (an exact integer in float32)."""
    table, offset = params
    b = obs.shape[0]
    count = obs.float().sum(dim=(1, 2, 3))
    value = (torch.remainder(count * 7.0 + offset, 11.0) - 5.0) / 7.0
    return table.expand(b, table.shape[0]), value


def scenario_roots(scenarios, board_size: int, device):
    """A BitState batch with one env per move list of ``scenarios``, each
    played from reset on the port's canonical engine."""
    envs = []
    for moves in scenarios:
        s = state.reset(board_size, device)
        for a in moves:
            s = step.step(s, board_size, a)
        envs.append(s)
    return bitboard.from_state(state.State(*[torch.stack(xs, -1) for xs in zip(*envs)]))
