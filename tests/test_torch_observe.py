"""The port's observation tensors, packed observation wire and decoders, and
the canonical <-> bitboard conversion equal the JAX ones, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu.ops import observe as jobs
from twixt_for_open_spiel_tpu.ops import state as jstate
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import observe as tobs
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll
from twixt_for_open_spiel_tpu_torch.ops import state as tstate
from twixt_for_open_spiel_tpu_torch.ops import step as tstep

torch.set_num_threads(1)

_reset_j = jax.jit(jbit.bit_reset, static_argnums=(0, 1))


def mid_game_states(n, batch=64):
    """A JAX batch part-way through random games, and its port copy."""
    jbs, _ = jbit.bit_random_rollout(n, n, 2 * n, _reset_j(n, batch))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jbs)]
    return jbs, tbit.bitstate_from_numpy(leaves, "cpu")


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


# --- the observation tensors and the canonical <-> bitboard conversion ------

def mid_game_canonical(n, batch=16):
    """A canonical batch part-way through random games (port rollout), and
    the same state as JAX arrays."""
    ts, _ = troll.random_rollout(
        torch.Generator().manual_seed(n), n, 2 * n, troll.batch_reset(n, batch, "cpu")
    )
    return jstate.State(*[jnp.asarray(x.numpy()) for x in ts]), ts


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_observation_matches_jax(n):
    js, ts = mid_game_canonical(n)
    assert int((ts.move_counter > 2).sum()) > ts.color.shape[-1] // 2
    got = tobs.observation(ts, n)
    assert got.dtype == torch.float32 and got.shape == (12, n, n - 2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jobs.observation(js, n)))
    np.testing.assert_array_equal(
        tobs.observation_nchw(ts, n).numpy(), np.asarray(jobs.observation_nchw(js, n))
    )
    # one unbatched env
    one = tstate.State(*[x[..., 0] for x in ts])
    np.testing.assert_array_equal(
        tobs.observation(one, n).numpy(), got[..., 0].numpy()
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_bit_observation_matches_jax(n, dtype):
    jbs, tbs = mid_game_states(n, batch=16)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tobs.bit_observation(tbs, n, tdt)
    assert got.dtype == tdt and got.shape == (12, n, n - 2, 16)
    want = np.asarray(jobs.bit_observation(jbs, n, jdt)).astype(np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    nchw = tobs.bit_observation_nchw(tbs, n, tdt)
    assert nchw.dtype == tdt and nchw.shape == (16, 12, n, n - 2)
    want = np.asarray(jobs.bit_observation_nchw(jbs, n, jdt)).astype(np.float32)
    np.testing.assert_array_equal(nchw.float().numpy(), want)


@pytest.mark.parametrize("n", [5, 8, 12])
def test_bit_observation_and_legal_mask_match_canonical(n):
    # port of tests/test_bitboard.py::test_bit_observation_and_legal_mask_
    # match_canonical: every state of a random game, both engines' views
    rng = np.random.default_rng(n)
    s = tstate.reset(n, "cpu")
    for mv in range(30):
        if int(s.result) != geo.RESULT_OPEN:
            break
        p = max(0, min(1, int(s.current_player)))
        acts = np.nonzero(tstate.legal_mask_flat(s, p, n).numpy())[0]
        s = tstep.step(s, n, torch.tensor(int(rng.choice(acts)), dtype=torch.int32))
        bs = tbit.from_state(s)
        for q in (0, 1):
            assert torch.equal(
                tbit.bit_legal_mask_flat(bs, q, n), tstate.legal_mask_flat(s, q, n)
            ), (mv, q)
        assert torch.equal(tobs.bit_observation(bs, n), tobs.observation(s, n)), mv
        assert torch.equal(
            tobs.bit_observation(bs, n), tobs.observation(tbit.to_state(bs, n), n)
        ), mv


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_from_state_and_to_state_match_jax(n):
    js, ts = mid_game_canonical(n)
    jbs = jax.jit(jbit.from_state)(js)
    tbs = tbit.from_state(ts)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jbs), tbit.bitstate_leaves(tbs))):
        np.testing.assert_array_equal(as_i64(b), as_i64(a), err_msg=f"leaf {i}")
    want = jax.jit(jbit.to_state, static_argnums=1)(jbs, n)
    got = tbit.to_state(tbs, n)
    for name, a, b in zip(want._fields, want, got):
        assert np.asarray(a).dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        # the round trip gives back the canonical state
        assert torch.equal(b, getattr(ts, name)), name
