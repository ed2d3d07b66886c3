"""The port's Gumbel sequential-halving search (``models/mcts.py``
``gumbel_search_batch``, ``_halving_schedule``) against JAX's and the naive
reference, on the CPU.

Under the set-up of ``tests/test_gumbel_exact.py`` (its five board-5
scenarios, its table evaluator as the torch twin in
``tests/torch_port_cases.py``, numpy-seeded Gumbels injected through
``gumbel_noise=``) the port picks JAX's action in every env, its improved
policy is within 1e-6 of JAX's and of ``ref_gumbel``'s and its ``root_q``
within 1e-5, for both backups and both node-state gathers.  The schedule
copy equals JAX's over that file's grid; the port's own draw is pinned by
distribution (a Kolmogorov-Smirnov test against the Gumbel CDF).

``tests/fixtures/torch_port_gumbel.json`` holds JAX's results;
``chip_smoke.py`` holds the port on the card to it.  Regenerate it with
``PYTHONPATH=. python tests/test_torch_gumbel.py``.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tests import torch_port_cases as cases
from tests.oracle import OracleGame as Board
from tests.test_gumbel_exact import _scenarios, ref_gumbel
from tests.test_mcts_exact import table_evaluator
from twixt_for_open_spiel_tpu.models import mcts as jmcts
from twixt_for_open_spiel_tpu.ops.bitboard import from_state as jfrom_state
from twixt_for_open_spiel_tpu.ops.state import reset as jreset
from twixt_for_open_spiel_tpu.ops.step import step as jstep
from twixt_for_open_spiel_tpu_torch.models import mcts as tmcts
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_gumbel.json"
N = 5
A = N * N
# (simulations, max_considered): the cases of tests/test_gumbel_exact.py
CASES = [(16, 16), (12, 8), (20, 5), (7, 16)]
# the schedule grid of tests/test_gumbel_exact.py:71-72
GRID_SIMS = [2, 3, 5, 7, 12, 16, 33, 64, 100]
GRID_MC = [2, 5, 16, 64]
TOL = {"improved": 1e-6, "root_q": 1e-5}


def scenario_moves():
    return [list(map(int, moves)) for moves, _ in _scenarios()]


def gumbels(sims, max_considered):
    """The Gumbels of ``test_gumbel_matches_naive_reference``'s case."""
    return cases.gumbel_case_noise(sims, max_considered, len(scenario_moves()))


def jax_roots():
    states = []
    for moves in scenario_moves():
        s = jreset(N)
        for a in moves:
            s = jstep(s, N, a)
        states.append(s)
    return jfrom_state(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, -1), *states))


def jax_record(sims, max_considered):
    action, improved, root_q = jmcts.gumbel_search_batch(
        None, jax_roots(), jax.random.PRNGKey(0), evaluator=table_evaluator(A), board_size=N,
        num_simulations=sims, max_considered=max_considered,
        gumbel_noise=jnp.asarray(gumbels(sims, max_considered)), backup="walk")
    return {"num_simulations": sims, "max_considered": max_considered,
            "action": np.asarray(action).tolist(), "improved": np.asarray(improved).tolist(),
            "root_q": np.asarray(root_q).tolist()}


def fixture_record():
    return {
        "board_size": N,
        "scenarios": scenario_moves(),
        "tolerance": f"action exact; improved policy {TOL['improved']}; root_q {TOL['root_q']}",
        "schedules": [[sims, mc, *jmcts._halving_schedule(mc, A, sims)]
                      for sims in GRID_SIMS for mc in GRID_MC],
        "search": [jax_record(*c) for c in CASES],
    }


@functools.lru_cache(maxsize=None)
def stored():
    return json.loads(FIXTURE.read_text())


def jsonable(schedule):
    m, phases = schedule
    return [m, [list(p) for p in phases]]


@functools.lru_cache(maxsize=None)
def naive(sims, max_considered):
    boards = []
    for moves in scenario_moves():
        b = Board(N)
        for a in moves:
            b.apply(a)
        boards.append(b)
    g = gumbels(sims, max_considered)
    return [ref_gumbel(b, g[i], sims, max_considered) for i, b in enumerate(boards)]


def port_search(sims, max_considered, backup, generator=None, noise=True):
    roots = cases.scenario_roots(scenario_moves(), N, "cpu")
    return tmcts.gumbel_search_batch(
        None, roots, generator or torch.Generator().manual_seed(0),
        evaluator=cases.EVALUATORS["table"](A), board_size=N, num_simulations=sims,
        max_considered=max_considered,
        gumbel_noise=torch.from_numpy(gumbels(sims, max_considered)) if noise else None,
        backup=backup)


@pytest.mark.parametrize("mc", GRID_MC)
@pytest.mark.parametrize("sims", GRID_SIMS)
def test_halving_schedule_equals_jax(sims, mc):
    got = tmcts._halving_schedule(mc, A, sims)
    assert got == jmcts._halving_schedule(mc, A, sims)
    assert [sims, mc, *jsonable(got)] in stored()["schedules"]


@pytest.mark.parametrize("sims", [0, 1])
def test_gumbel_needs_two_simulations(sims):
    with pytest.raises(ValueError, match="num_simulations >= 2"):
        tmcts._halving_schedule(16, A, sims)
    with pytest.raises(ValueError, match="num_simulations >= 2"):
        port_search(sims, 16, "auto", noise=False)


@pytest.mark.parametrize("backup", ["amask", "walk"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "s{}_m{}".format(*c))
def test_gumbel_matches_jax_and_naive(case, backup):
    sims, mc = case
    action, improved, root_q = port_search(sims, mc, backup)
    assert action.dtype == torch.int64 and improved.dtype == root_q.dtype == torch.float32
    rec = next(r for r in stored()["search"]
               if (r["num_simulations"], r["max_considered"]) == case)
    assert action.tolist() == rec["action"]
    np.testing.assert_allclose(improved.numpy(), rec["improved"], rtol=0, atol=TOL["improved"])
    np.testing.assert_allclose(root_q.numpy(), rec["root_q"], rtol=0, atol=TOL["root_q"])
    for i, (ref_a, ref_improved, ref_q) in enumerate(naive(sims, mc)):
        assert int(action[i]) == ref_a, i
        np.testing.assert_allclose(improved[i].numpy(), ref_improved, rtol=0,
                                   atol=TOL["improved"])
        assert abs(float(root_q[i]) - ref_q) <= TOL["root_q"]
    roots = cases.scenario_roots(scenario_moves(), N, "cpu")
    legal = tbit.bit_legal_mask_flat(roots, roots.current_player.clamp(0, 1), N).T
    assert bool(legal[torch.arange(len(action)), action].all())
    assert bool((improved[~legal] == 0).all())
    torch.testing.assert_close(improved.sum(-1), torch.ones(len(action)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_fixture_matches_jax(i):
    assert stored()["search"][i] == jax_record(*CASES[i])


def test_schedule_fixture_matches_jax():
    want = [[sims, mc, *jsonable(jmcts._halving_schedule(mc, A, sims))]
            for sims in GRID_SIMS for mc in GRID_MC]
    assert stored()["schedules"] == want


def test_top_keeps_jax_tie_order():
    """``_top`` orders ties as ``jax.lax.top_k`` does (lower index first),
    the -inf tail of a row with few legal actions included."""
    rows = np.array([[1, 3, 3, -np.inf, 3, -np.inf],
                     [0, 0, 0, 0, 0, 0],
                     [-np.inf] * 6,
                     [2, -1, 2, 5, -1, 2]], np.float32)
    rng = np.random.default_rng(5)
    rows = np.concatenate([rows, rng.integers(-2, 3, (64, 6)).astype(np.float32)])
    for k in (1, 2, 5, 6):
        values, idx = tmcts._top(torch.from_numpy(rows), k)
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        assert idx.tolist() == np.asarray(ji).tolist(), k
        assert values.tolist() == np.asarray(jv).tolist(), k
    _, idx = tmcts._top(torch.from_numpy(rows[:1]), 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]


def test_gumbel_draw_by_distribution():
    """The draw is standard Gumbel (Kolmogorov-Smirnov against exp(-exp(-x))),
    finite, and follows the generator."""
    x = tmcts._draw_gumbel(torch.Generator().manual_seed(3), (200_000,), "cpu")
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    ks = scipy.stats.kstest(x.double().numpy(), scipy.stats.gumbel_r.cdf)
    assert ks.pvalue > 1e-3, ks
    assert abs(float(x.double().mean()) - np.euler_gamma) < 0.01
    again = tmcts._draw_gumbel(torch.Generator().manual_seed(3), (200_000,), "cpu")
    assert torch.equal(x, again)
    # U = 0 is kept away from: the smallest uniform gives a finite draw
    tiny = torch.tensor(torch.finfo(torch.float32).tiny)
    assert bool(torch.isfinite(-torch.log(-torch.log(tiny))))


def test_search_draws_gumbels_from_generator():
    """Without ``gumbel_noise`` the Gumbels come from the generator after
    the root evaluation: equal generators give equal searches, and the
    draw is the one ``_draw_gumbel`` makes."""
    sims, mc = 16, 16
    a = port_search(sims, mc, "auto", torch.Generator().manual_seed(7), noise=False)
    b = port_search(sims, mc, "auto", torch.Generator().manual_seed(7), noise=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g = torch.Generator().manual_seed(7)
    noise = tmcts._draw_gumbel(g, (len(scenario_moves()), A), "cpu")
    roots = cases.scenario_roots(scenario_moves(), N, "cpu")
    c = tmcts.gumbel_search_batch(None, roots, torch.Generator(), gumbel_noise=noise,
                                  evaluator=cases.EVALUATORS["table"](A), board_size=N,
                                  num_simulations=sims, max_considered=mc)
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    others = {tuple(port_search(sims, mc, "auto", torch.Generator().manual_seed(s),
                                noise=False)[0].tolist()) for s in range(4)}
    assert len(others) > 1


if __name__ == "__main__":
    FIXTURE.write_text(json.dumps(fixture_record()) + "\n")
    print(f"wrote {FIXTURE}")
