"""The port's canonical engine (``State``, ``reset``, ``step``) equals the JAX
engine leaf by leaf, and the independent Python oracle on every move.

Every comparison is exact (dtype and value).  Random games draw their moves
with ``numpy.random.default_rng`` and feed the same actions to all three.
"""

import jax
import numpy as np
import pytest
import torch

from oracle import OracleGame
from twixt_for_open_spiel_tpu.ops import state as jstate
from twixt_for_open_spiel_tpu.ops import step as jstep
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import state as tstate
from twixt_for_open_spiel_tpu_torch.ops import step as tstep

torch.set_num_threads(1)

_step_j = jax.jit(jstep.step_impl, static_argnums=1)
_reset_j = jax.jit(jstate.reset, static_argnums=0)


def assert_same_state(jax_state, port_state, msg=""):
    assert port_state._fields == jax_state._fields
    for name, a, b in zip(jax_state._fields, jax_state, port_state):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(b, a, err_msg=f"{msg} {name}")


def legal_list(state, n):
    p = int(state.current_player)
    return np.nonzero(tstate.legal_mask_flat(state, p, n).numpy())[0].tolist()


def port_step(s, n, a):
    return tstep.step(s, n, torch.tensor(a, dtype=torch.int32))


@pytest.mark.parametrize("n", list(range(5, 25)))
def test_reset_matches_jax(n):
    assert_same_state(_reset_j(n), tstate.reset(n, "cpu"), f"n={n}")


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_onehot_and_legal_mask_flat_match_jax(n):
    actions = np.array([-1, 0, n - 1, n * n // 2, n * n - 1], dtype=np.int32)
    want = np.asarray(jstate.onehot_board(jax.numpy.asarray(actions), n))
    got = tstate.onehot_board(torch.from_numpy(actions), n).numpy()
    np.testing.assert_array_equal(got, want)
    s = tstate.reset(n, "cpu")
    for q in (0, 1):
        np.testing.assert_array_equal(
            tstate.legal_mask_flat(s, q, n).numpy(),
            np.asarray(jstate.legal_mask_flat(_reset_j(n), q, n)),
        )


def check_oracle(s, g, n):
    pad = geo.PAD
    color = s.color.numpy()[pad : pad + n, pad : pad + n]
    links = s.links.numpy()[pad : pad + n, pad : pad + n]
    blocked = s.blocked.numpy()[pad : pad + n, pad : pad + n]
    for (x, y), c in g.color.items():
        assert color[x, y] == c, (x, y)
    for (x, y), ds in g.links.items():
        assert links[x, y] == sum(1 << d for d in ds), ("links", x, y)
    for (x, y), ds in g.blocked.items():
        assert blocked[x, y] == sum(1 << d for d in ds), ("blocked", x, y)
    assert bool(tstep.is_terminal(s)) == g.is_terminal()
    assert int(s.result) == g.result
    assert tstep.returns(s).tolist() == g.returns()
    if not g.is_terminal():
        assert int(s.current_player) == g.current
        assert legal_list(s, n) == g.legal_actions()


@pytest.mark.parametrize("n,games", [(5, 6), (8, 4), (12, 3), (24, 2)])
def test_step_matches_jax_and_oracle(n, games):
    rng = np.random.default_rng(200 + n)
    outcomes, swaps = set(), 0
    for game in range(games):
        js, ts, g = _reset_j(n), tstate.reset(n, "cpu"), OracleGame(n)
        while not g.is_terminal():
            if g.move_counter == 1 and game % 2 == 0 and g.move_one is not None:
                a = g.move_one[0] * n + g.move_one[1]  # the swap
                if a not in g.legal_actions():
                    a = int(rng.choice(g.legal_actions()))
            else:
                a = int(rng.choice(g.legal_actions()))
            js = _step_j(js, n, a)
            ts = port_step(ts, n, a)
            g.apply(a)
            assert_same_state(js, ts, f"n={n} game={game} action={a}")
            check_oracle(ts, g, n)
        outcomes.add(g.result)
        swaps += g.swapped
    assert outcomes <= {geo.RESULT_RED_WIN, geo.RESULT_BLUE_WIN, geo.RESULT_DRAW}
    if n <= 8:
        assert swaps >= 1


def test_batched_step_matches_jax():
    # the same transition with a trailing env batch, mid-game positions
    n, b = 8, 16
    rng = np.random.default_rng(7)
    js = jax.tree_util.tree_map(
        lambda x: jax.numpy.broadcast_to(x[..., None], x.shape + (b,)), _reset_j(n)
    )
    ts = tstate.State(*[torch.from_numpy(np.array(x)) for x in js])
    for k in range(12):
        mask = tstate.legal_mask_flat(ts, ts.current_player.clamp(0, 1), n).numpy()
        acts = np.array([rng.choice(np.nonzero(mask[:, e])[0]) for e in range(b)])
        acts = acts.astype(np.int32)
        js = _step_j(js, n, jax.numpy.asarray(acts))
        ts = tstep.step(ts, n, torch.from_numpy(acts))
        assert_same_state(js, ts, f"k={k}")


# --- ports of tests/test_rules.py (reference twixt_test.cc:108-199) --------


def test_swap():
    n = 8
    s = tstate.reset(n, "cpu")
    assert int(s.current_player) == 0 and 11 in legal_list(s, n)
    s = port_step(s, n, 19)  # player 0: xc5
    assert int(s.current_player) == 1
    s = port_step(s, n, 19)  # player 1 swaps: od3 replaces xc5
    assert bool(s.swapped)
    la = legal_list(s, n)
    assert 19 in la and 29 not in la
    assert int(s.current_player) == 0
    s = port_step(s, n, 36)
    la = legal_list(s, n)
    assert 19 in la and 29 not in la and 36 not in la


def test_legal_actions_and_win():
    n = 8
    s = tstate.reset(n, "cpu")
    assert not bool(tstep.is_terminal(s))
    assert len(legal_list(s, n)) == 48
    for a, count in [(21, 48), (38, 46), (15, 46), (11, 44), (27, 44),
                     (17, 42), (42, 42), (45, 40)]:
        s = port_step(s, n, a)
        assert len(legal_list(s, n)) == count, a
        if a == 11:
            assert 11 not in legal_list(s, n)
    s = port_step(s, n, 48)  # xg8 wins
    assert bool(tstep.is_terminal(s))
    assert tstep.returns(s).tolist() == [1.0, -1.0]
    assert int(s.result) == geo.RESULT_RED_WIN
    assert int(s.current_player) == geo.TERMINAL_PLAYER_ID


def test_draw():
    n = 5
    s = tstate.reset(n, "cpu")
    moves = 0
    while not bool(tstep.is_terminal(s)):
        s = port_step(s, n, legal_list(s, n)[0])
        if bool(tstep.is_terminal(s)):
            break
        s = port_step(s, n, legal_list(s, n)[1])
        moves += 2
        assert moves < 100
    assert tstep.returns(s).tolist() == [0.0, 0.0]
    assert int(s.result) == geo.RESULT_DRAW


def test_swap_window_closes():
    n = 8
    s = port_step(port_step(tstate.reset(n, "cpu"), n, 19), n, 36)  # no swap
    la = legal_list(s, n)
    assert 19 not in la and 36 not in la
    assert not bool(s.swapped)


def test_red_endline_not_swappable():
    n = 8
    s = port_step(tstate.reset(n, "cpu"), n, 15)  # xb1, red's end border
    assert 15 not in legal_list(s, n)


def test_returns_and_is_terminal_match_jax():
    results = np.array([0, 1, 2, 3, 1, 0], dtype=np.int32)
    js = _reset_j(5)._replace(result=jax.numpy.asarray(results))
    ts = tstate.reset(5, "cpu")._replace(result=torch.from_numpy(results))
    got = tstep.returns(ts)
    assert got.dtype == torch.float32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jstep.returns(js)))
    np.testing.assert_array_equal(
        tstep.is_terminal(ts).numpy(), np.asarray(jstep.is_terminal(js))
    )
