"""The port's bitboard engine is bit-identical to the JAX engine.

Every comparison is exact: JAX u32 words and the port's int32 words are
compared as int64 values.  Inputs (actions, noise) come from
``numpy.random.default_rng`` and go to both engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo

torch.set_num_threads(1)

_step_j = jax.jit(jbit.step_bits, static_argnums=1)
_sample_j = jax.jit(jbit.sample_bits, static_argnums=1)
_reset_j = jax.jit(jbit.bit_reset, static_argnums=(0, 1))

LEAF_NAMES = (
    ["red", "blue"] + [f"links{d}" for d in range(4)]
    + [f"blocked{d}" for d in range(4)] + ["legal0", "legal1"]
    + [f"flags{b}" for b in range(4)]
    + ["compid", "current_player", "move_counter", "move_one", "swapped",
       "result"]
)


def jax_leaves(bs):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(bs)]


def assert_same_state(jax_bs, port_bs, msg=""):
    jl = jax_leaves(jax_bs)
    tl = tbit.bitstate_leaves(port_bs)
    assert len(jl) == len(tl) == len(LEAF_NAMES)
    for name, a, b in zip(LEAF_NAMES, jl, tl):
        np.testing.assert_array_equal(
            b.numpy().astype(np.int64), a.astype(np.int64), err_msg=f"{msg} {name}"
        )


def test_hash_u32_matches_numpy():
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint64)
    sweep = np.random.default_rng(0).integers(0, 2**32, 20000, dtype=np.uint64)
    x = np.concatenate([edge, sweep]).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = x ^ (x >> np.uint32(16))
        want = want * np.uint32(0x7FEB352D)
        want = want ^ (want >> np.uint32(15))
        want = want * np.uint32(0x846CA68B)
        want = want ^ (want >> np.uint32(16))
    got = tbit._hash_u32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(jbit._hash_u32(jnp.asarray(x))).astype(np.int64),
        want.astype(np.int64),
    )
    # the Python-int path used for the per-step counter
    assert [tbit._hash_u32(int(v)) for v in x[:5]] == want[:5].tolist()


def test_popcount_matches_numpy():
    x = np.random.default_rng(1).integers(0, 2**32, 5000, dtype=np.uint64)
    want = np.array([bin(int(v)).count("1") for v in x])
    got = tbit._popcount(torch.from_numpy(x.astype(np.uint32).view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_kth_bit_matches_brute_force():
    rng = np.random.default_rng(2)
    words = rng.integers(1, 2**32, 3000, dtype=np.uint64)
    words[:3] = [1, 2**31, 2**32 - 1]
    ks, want = [], []
    for w in words:
        bits = [i for i in range(32) if (int(w) >> i) & 1]
        k = int(rng.integers(0, len(bits)))
        ks.append(k)
        want.append(bits[k])
    got = tbit._select_kth_bit(
        torch.from_numpy(words.astype(np.uint32).view(np.int32)),
        torch.tensor(ks, dtype=torch.int32),
    )
    assert got.tolist() == want


@pytest.mark.parametrize("n", list(range(5, 25)))
def test_bit_reset_matches_jax(n):
    assert_same_state(_reset_j(n, 3), tbit.bit_reset(n, 3, "cpu"), f"n={n}")


def _legal_actions(bs, n):
    """Legal actions of the player to move in env 0 of a port state."""
    player = int(bs.current_player.clamp(0, 1)[0])
    mask = tbit.bit_legal_mask_flat(bs, player, n)[:, 0]
    return np.nonzero(mask.numpy())[0]


@pytest.mark.parametrize("n", [5, 8])
def test_step_bits_matches_jax_every_move(n):
    rng = np.random.default_rng(100 + n)
    outcomes = set()
    swaps = 0
    for game in range(8):
        jbs = _reset_j(n, 1)
        tbs = tbit.bit_reset(n, 1, "cpu")
        while int(tbs.result[0]) == geo.RESULT_OPEN:
            if int(tbs.move_counter[0]) == 1 and game % 4 == 0:
                a = int(tbs.move_one[0])  # the swap: move 2 = move 1
            else:
                a = int(rng.choice(_legal_actions(tbs, n)))
            jbs = _step_j(jbs, n, jnp.asarray([a], jnp.int32))
            tbs = tbit.step_bits(tbs, n, torch.tensor([a], dtype=torch.int32))
            assert_same_state(jbs, tbs, f"n={n} game={game} action={a}")
        outcomes.add(int(tbs.result[0]))
        swaps += int(tbs.swapped[0])
    assert swaps >= 2
    assert geo.RESULT_DRAW in outcomes
    assert outcomes & {geo.RESULT_RED_WIN, geo.RESULT_BLUE_WIN}


def test_sample_bits_matches_jax():
    n, b = 8, 512
    jbs, _ = jbit.bit_random_rollout(4, n, 17, _reset_j(n, b))
    tbs = tbit.bitstate_from_numpy(jax_leaves(jbs), "cpu")
    noise = np.random.default_rng(3).integers(0, 2**32, b, dtype=np.uint64)
    want = np.asarray(_sample_j(jbs, n, jnp.asarray(noise.astype(np.uint32))))
    got = tbit.sample_bits(tbs, n, torch.from_numpy(noise.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bit_step_auto_reset_matches_jax():
    n, b = 5, 256
    jbs, _ = jbit.bit_random_rollout(6, n, 11, _reset_j(n, b))
    tbs = tbit.bitstate_from_numpy(jax_leaves(jbs), "cpu")
    noise = torch.from_numpy(
        np.random.default_rng(5).integers(0, 2**32, b, dtype=np.uint64).astype(np.int64)
    )
    actions = tbit.sample_bits(tbs, n, noise)
    jnxt, jdone, jres = jax.jit(jbit.bit_step_auto_reset, static_argnums=2)(
        jbs, jnp.asarray(actions.numpy()), n
    )
    tnxt, tdone, tres = tbit.bit_step_auto_reset(tbs, actions, n)
    assert tdone.any()  # some envs end and are reset
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    assert_same_state(jnxt, tnxt)


@pytest.mark.parametrize(
    "n,b,steps,seed",
    [(5, 256, 60, 3), (8, 256, 50, 11), (12, 128, 40, 7), (24, 128, 300, 1)],
)
def test_bit_random_rollout_matches_jax(n, b, steps, seed):
    jf, js = jbit.bit_random_rollout(seed, n, steps, _reset_j(n, b))
    tf, ts = tbit.bit_random_rollout(seed, n, steps, tbit.bit_reset(n, b, "cpu"))
    assert_same_state(jf, tf)
    assert int(ts["episodes"]) == int(js["episodes"]) > 0
    np.testing.assert_array_equal(ts["results"].numpy(), np.asarray(js["results"]))


def test_sample_bits_legal_and_uniform():
    n, b = 5, 4096
    bs = tbit.bit_reset(n, b, "cpu")
    noise = tbit._mul_u32(torch.arange(b, dtype=torch.int64), 0x9E3779B9)
    acts = tbit.sample_bits(bs, n, noise).numpy()
    legal_ids = np.nonzero(tbit.bit_legal_mask_flat(bs, 0, n)[:, 0].numpy())[0]
    assert set(acts) <= set(legal_ids.tolist())
    # roughly uniform over the 15 initial legal cells of red on 5x5
    counts = np.bincount(acts, minlength=n * n)[legal_ids]
    expected = b / len(legal_ids)
    assert counts.min() > 0.5 * expected
    assert counts.max() < 1.7 * expected


def test_bit_rollout_states_stay_valid():
    # after a rollout every env's state keeps the engine's invariants
    n, b, steps = 5, 32, 40
    final, _ = tbit.bit_random_rollout(9, n, steps, tbit.bit_reset(n, b, "cpu"))
    p = n + 2 * geo.PAD
    red = tbit._unpack_bool(final.red, p).numpy()
    blue = tbit._unpack_bool(final.blue, p).numpy()
    on_board = geo.board_masks(n)["on_board"][..., None]
    assert not np.any(red & blue)
    assert not np.any((red | blue) & ~on_board)
    assert (final.result == geo.RESULT_OPEN).all()
    assert set(final.current_player.tolist()) <= {0, 1}
    compid = final.compid.numpy()
    for e in range(b):
        color = {c: col for col, board in ((0, red), (1, blue))
                 for c in zip(*np.nonzero(board[..., e]))}
        for planes, linked in ((final.links, True), (final.blocked, False)):
            for d in range(4):
                dx, dy = (int(v) for v in geo.OFFSETS[d])
                bits = tbit._unpack_bool(planes[d], p)[..., e].numpy()
                for x, y in zip(*np.nonzero(bits)):
                    # a link or blocked pair joins two pegs of one colour
                    a, z = (x, y), (x + dx, y + dy)
                    assert a in color and z in color and color[a] == color[z]
                    if linked:  # linked pegs share their component id
                        ca = compid[a[0] - geo.PAD, a[1] - geo.PAD, e]
                        cz = compid[z[0] - geo.PAD, z[1] - geo.PAD, e]
                        assert ca == cz
        # occupied cells leave both legal sets, but move one stays legal
        # for one ply
        for q in (0, 1):
            legal = tbit._unpack_bool(final.legal[q], p)[..., e].numpy()
            taken = legal & (red[..., e] | blue[..., e])
            if int(final.move_counter[e]) == 1:
                mx, my = divmod(int(final.move_one[e]), n)
                taken[mx + geo.PAD, my + geo.PAD] = False
            assert not taken.any()


def test_numpy_converters_round_trip():
    jbs, _ = jbit.bit_random_rollout(2, 5, 7, _reset_j(5, 16))
    leaves = jax_leaves(jbs)
    back = tbit.bitstate_to_numpy(tbit.bitstate_from_numpy(leaves, "cpu"))
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    bad = list(leaves)
    bad[0] = bad[0] | np.uint32(1 << 31)
    with pytest.raises(ValueError, match="bit 31"):
        tbit.bitstate_from_numpy(bad, "cpu")
