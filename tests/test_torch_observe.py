"""The port's packed observation wire and its decoders equal the JAX ones."""

import jax
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu.ops import observe as jobs
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import observe as tobs

torch.set_num_threads(1)

_reset_j = jax.jit(jbit.bit_reset, static_argnums=(0, 1))


def mid_game_states(n, batch=64):
    """A JAX batch part-way through random games, and its port copy."""
    jbs, _ = jbit.bit_random_rollout(n, n, 2 * n, _reset_j(n, batch))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jbs)]
    return jbs, tbit.bitstate_from_numpy(leaves)


def as_i64(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_packed_wire_matches_jax(n):
    jbs, tbs = mid_game_states(n)
    # mostly real positions, not fresh resets
    assert int((tbs.move_counter > 2).sum()) > tbs.red.shape[1] // 2
    np.testing.assert_array_equal(
        as_i64(tobs.bit_observation_packed_lanes(tbs, n)),
        as_i64(jobs.bit_observation_packed_lanes(jbs, n)),
    )
    want = as_i64(jobs.bit_observation_packed_with_legal(jbs, n))
    got = tobs.bit_observation_packed_with_legal(tbs, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(as_i64(got), want)


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_decoders_match_jax(n):
    jbs, tbs = mid_game_states(n, batch=16)
    p = n + 6
    wire_j = jobs.bit_observation_packed_with_legal(jbs, n).reshape(-1, 12, p)
    wire_t = tobs.bit_observation_packed_with_legal(tbs, n).reshape(-1, 12, p)
    np.testing.assert_array_equal(
        tobs.unpack_observation_nchw(wire_t, n).numpy(),
        np.asarray(jobs.unpack_observation_nchw(wire_j, n)),
    )
    # leading dims beyond one batch axis decode too
    np.testing.assert_array_equal(
        tobs.unpack_observation_nchw(wire_t.reshape(2, 8, 12, p), n).numpy(),
        np.asarray(jobs.unpack_observation_nchw(wire_j.reshape(2, 8, 12, p), n)),
    )
    words_t = tobs.legal_words_from_obs(wire_t)
    words_j = jobs.legal_words_from_obs(wire_j)
    np.testing.assert_array_equal(as_i64(words_t), as_i64(words_j))
    flat_t = tobs.unpack_legal_words_flat(words_t, n)
    np.testing.assert_array_equal(
        flat_t.numpy(), np.asarray(jobs.unpack_legal_words_flat(words_j, n))
    )
    # round trip: the wire's legal plane is the mover's legal mask
    mover = tbs.current_player.clamp(0, 1)
    for e in range(tbs.red.shape[1]):
        want = tbit.bit_legal_mask_flat(tbs, int(mover[e]), n)[:, e]
        assert torch.equal(flat_t[e], want)
    # the stowaway legal chunks leave the observation decode untouched
    bare = tobs.bit_observation_packed_lanes(tbs, n).permute(2, 0, 1)
    assert torch.equal(
        tobs.unpack_observation_nchw(bare, n),
        tobs.unpack_observation_nchw(wire_t, n),
    )
