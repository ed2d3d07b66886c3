"""The port's batched history replay (``ops/replay.py::bit_replay``) on the
CPU: leaf by leaf equal to the JAX package's ``bit_replay`` on ragged padded
histories (some games end before their padding, some are cut before their
end), and equal to the C engine's final snapshots on its random games."""

import inspect

import jax
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops.replay import bit_replay as jax_bit_replay
from twixt_for_open_spiel_tpu_torch.native.engine import random_game
from twixt_for_open_spiel_tpu_torch.ops import bitboard
from twixt_for_open_spiel_tpu_torch.ops.replay import bit_replay

from tests import torch_port_cases as cases


def ragged_histories(n: int, games: int, seed: int) -> np.ndarray:
    """C games at board ``n``; every third cut short by a few moves (the
    game stays open), with a tail of padding past the longest."""
    rng = np.random.default_rng(seed)
    hs = [random_game(n, int(s))[0] for s in rng.integers(0, 2**31, games)]
    hs = [h[: len(h) - int(rng.integers(1, 4))] if b % 3 == 0 else h for b, h in enumerate(hs)]
    padded = np.full((max(map(len, hs)) + 3, games), -1, np.int32)
    for b, h in enumerate(hs):
        padded[: len(h), b] = h
    return padded


@pytest.mark.parametrize("n,seed", [(5, 0), (8, 1)])
def test_bit_replay_matches_jax(n, seed):
    padded = ragged_histories(n, 24, seed)
    got = bitboard.bitstate_to_numpy(bit_replay(n, torch.from_numpy(padded)))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_bit_replay(n, padded))]
    assert len(got) == len(want) == bitboard.NUM_LEAVES
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"leaf {i}"
    results = want[-1]
    assert (results == 0).any() and (results != 0).any()  # open and ended games


@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_bit_replay_matches_c_engine(n):
    padded, facts = cases.c_games(n, [97 * n + b for b in range(32)])
    final = bit_replay(n, padded, device="cpu")
    assert final.red.device.type == "cpu"
    assert cases.replay_mismatches(final, n, facts) == []
    assert (facts["result"] != 0).all()


def test_padding_and_finished_games_stay_put():
    """A column of padding only, and a game that ended, step on action 0
    (a corner, never legal); the result is thrown away and the other
    columns are not disturbed."""
    n = 5
    acts, _ = random_game(n, 3)
    padded = np.full((len(acts) + 5, 3), -1, np.int32)
    padded[: len(acts), 0] = acts
    padded[: len(acts), 2] = acts
    padded[len(acts):, 2] = 0  # after the end: never a legal move
    final = bitboard.bitstate_leaves(bit_replay(n, torch.from_numpy(padded)))
    reset = bitboard.bitstate_leaves(bitboard.bit_reset(n, 1, "cpu"))
    for leaf, r in zip(final, reset):
        assert torch.equal(leaf[..., 1], r[..., 0])
        assert torch.equal(leaf[..., 0], leaf[..., 2])


def test_bit_replay_device():
    """A tensor replays on its own device; an array or a list goes to
    ``device``, the card unless the caller names another."""
    assert inspect.signature(bit_replay).parameters["device"].default == "cuda"
    acts = [[14, 20], [13, -1]]
    from_list = bitboard.bitstate_leaves(bit_replay(5, acts, device="cpu"))
    from_tensor = bitboard.bitstate_leaves(bit_replay(5, torch.tensor(acts), device="meta"))
    assert from_list[0].device.type == from_tensor[0].device.type == "cpu"
    assert all(torch.equal(a, b) for a, b in zip(from_list, from_tensor))
