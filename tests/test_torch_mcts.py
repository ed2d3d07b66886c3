"""The port's batched PUCT search (``models/mcts.py``) against JAX's
``search_batch`` and the naive reference, on the CPU.

Under the set-up of ``tests/test_mcts_exact.py`` (its scenarios at boards 5
and 8, its table and uniform evaluators as torch twins in
``tests/torch_port_cases.py``, ``dirichlet_frac=0``) the port's root visit
counts equal JAX's and ``tests/naive_mcts.py``'s integer for integer, for
both backups and both node-state gathers; ``root_q`` agrees within 1e-5.
The seed-level ``one_rollout`` equals the JAX rollout evaluator's values
bit for bit for the seeds JAX draws.  The random parts (Dirichlet noise)
are pinned by distribution.

``tests/fixtures/torch_port_search.json`` holds JAX's visits, ``root_q`` and
rollout values for these cases; ``chip_smoke.py`` holds the port on the card
to it.  Regenerate it with ``PYTHONPATH=. python tests/test_torch_mcts.py``.
"""

import functools
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_port_cases as cases
from tests.naive_mcts import NaiveTree
from tests.oracle import OracleGame as Board
from tests.test_mcts_exact import _scenarios, oracle_eval, table_evaluator, uniform_evaluator
from twixt_for_open_spiel_tpu.models import mcts as jmcts
from twixt_for_open_spiel_tpu.ops.bitboard import from_state as jfrom_state
from twixt_for_open_spiel_tpu.ops.state import reset as jreset
from twixt_for_open_spiel_tpu.ops.step import step as jstep
from twixt_for_open_spiel_tpu_torch.models import mcts as tmcts
from twixt_for_open_spiel_tpu_torch.models.network import create_net, call_net
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll
from twixt_for_open_spiel_tpu_torch.ops import state as tstate
from twixt_for_open_spiel_tpu_torch.ops import step as tstep

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_search.json"
# (board, simulations, evaluator): the cases of tests/test_mcts_exact.py
SEARCH_CASES = [(5, 8, "uniform"), (5, 25, "uniform"), (5, 40, "table"), (8, 24, "table")]
# (board, JAX key): rollouts from the scenario roots
ROLLOUT_CASES = [(5, 0), (8, 2)]
JAX_EVALUATORS = {"table": table_evaluator, "uniform": uniform_evaluator}


def scenario_moves(n):
    return [list(map(int, moves)) for moves, _ in _scenarios(n)]


def jax_roots(n):
    states = []
    for moves in scenario_moves(n):
        s = jreset(n)
        for a in moves:
            s = jstep(s, n, a)
        states.append(s)
    return jfrom_state(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, -1), *states))


def jax_search_record(n, sims, kind):
    # JAX's walk backup: its two backups give the same search
    # (tests/test_mcts_exact.py), and the walk counts both loops
    probs, root_q, stats = jmcts.search_batch(
        None, jax_roots(n), jax.random.PRNGKey(0), evaluator=JAX_EVALUATORS[kind](n * n),
        board_size=n, num_simulations=sims, dirichlet_frac=0.0, backup="walk",
        return_stats=True)
    visits = np.rint(np.asarray(probs) * sims).astype(np.int64)
    return {"board_size": n, "num_simulations": sims, "evaluator": kind,
            "scenarios": scenario_moves(n), "visits": visits.tolist(),
            "root_q": np.asarray(root_q).tolist(),
            "sel_iters": int(stats["sel_iters"]), "backup_iters": int(stats["backup_iters"])}


def jax_rollout_record(n, k):
    key = jax.random.PRNGKey(k)
    seed = int(jax.random.bits(jax.random.fold_in(key, 0), dtype=jnp.uint32))
    _, value = jmcts.rollout_evaluator(n, 1)(None, jax_roots(n), key)
    return {"board_size": n, "scenarios": scenario_moves(n), "seed": seed,
            "values": np.asarray(value).tolist()}


def fixture_record():
    return {
        "tolerance": "visits exact; |root_q - jax| <= 1e-5; rollout values exact",
        "search": [jax_search_record(*c) for c in SEARCH_CASES],
        "rollout": [jax_rollout_record(*c) for c in ROLLOUT_CASES],
    }


@functools.lru_cache(maxsize=None)
def stored():
    return json.loads(FIXTURE.read_text())


@functools.lru_cache(maxsize=None)
def naive_visits(n, sims, kind):
    visits, qs = [], []
    for moves in scenario_moves(n):
        board = Board(n)
        for a in moves:
            board.apply(a)
        tree = NaiveTree(board, oracle_eval(n * n, kind), n * n, root_prior_mode="puct")
        for _ in range(sims):
            tree.simulate()
        visits.append(tree.root_visits())
        qs.append(tree.root_q())
    return np.array(visits), np.array(qs)


def port_search(n, sims, kind, backup, **kw):
    roots = cases.scenario_roots(scenario_moves(n), n, "cpu")
    return tmcts.search_batch(
        None, roots, torch.Generator().manual_seed(0),
        evaluator=cases.EVALUATORS[kind](n * n), board_size=n, num_simulations=sims,
        dirichlet_frac=0.0, backup=backup, **kw)


@pytest.mark.parametrize("backup", ["amask", "walk"])
@pytest.mark.parametrize("case", SEARCH_CASES, ids=lambda c: "n{}_s{}_{}".format(*c))
def test_search_matches_jax_and_naive(case, backup):
    n, sims, kind = case
    probs, root_q, stats = port_search(n, sims, kind, backup, return_stats=True)
    visits = np.rint(probs.numpy() * sims).astype(np.int64)
    rec = next(r for r in stored()["search"]
               if (r["board_size"], r["num_simulations"], r["evaluator"]) == case)
    np.testing.assert_array_equal(visits, np.array(rec["visits"]))
    np.testing.assert_allclose(root_q.numpy(), rec["root_q"], rtol=0, atol=1e-5)
    ref_visits, ref_q = naive_visits(n, sims, kind)
    np.testing.assert_array_equal(visits, ref_visits)
    np.testing.assert_allclose(root_q.numpy(), ref_q, rtol=0, atol=1e-5)
    assert np.all(visits.sum(-1) == sims)
    # the host loops run as many iterations as JAX's while_loops
    assert stats == {"sel_iters": rec["sel_iters"],
                     "backup_iters": rec["backup_iters"] if backup == "walk" else 0}


@pytest.mark.parametrize("i", range(len(ROLLOUT_CASES)))
def test_one_rollout_matches_jax(i):
    rec = stored()["rollout"][i]
    n = rec["board_size"]
    assert n == ROLLOUT_CASES[i][0]
    roots = cases.scenario_roots(rec["scenarios"], n, "cpu")
    got = tmcts.one_rollout(roots, n, rec["seed"])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.array(rec["values"], np.float32))
    # a seed held in a tensor gives the same playouts
    assert torch.equal(tmcts.one_rollout(roots, n, torch.tensor(rec["seed"])), got)


@pytest.mark.parametrize("i", range(len(SEARCH_CASES)))
def test_search_fixture_matches_jax(i):
    assert stored()["search"][i] == jax_search_record(*SEARCH_CASES[i])


def test_rollout_fixture_matches_jax():
    assert stored()["rollout"] == [jax_rollout_record(*c) for c in ROLLOUT_CASES]


def test_rollout_evaluator_draws_seeds_from_generator():
    n = 5
    roots = tbit.bit_reset(n, 8, "cpu")
    g = torch.Generator().manual_seed(7)
    seeds = [int(torch.randint(0, 1 << 32, (), generator=g, dtype=torch.int64))
             for _ in range(2)]
    logits, value = tmcts.rollout_evaluator(n, 2)(None, roots, torch.Generator().manual_seed(7))
    want = (tmcts.one_rollout(roots, n, seeds[0]) + tmcts.one_rollout(roots, n, seeds[1])) / 2
    assert torch.equal(value, want)
    assert torch.equal(logits, torch.zeros(8, n * n))


@pytest.mark.parametrize("alpha", [0.3, 0.03, 1.7])
def test_dirichlet_by_distribution(alpha):
    # Dirichlet(alpha) over A components: mean 1/A, variance
    # (A-1) / (A^2 (A alpha + 1)); the gamma draws: mean = variance = alpha
    a_dim, draws = 25, 8000
    g = torch.Generator().manual_seed(11)
    x = tmcts.dirichlet(g, alpha, (draws, a_dim), "cpu").double()
    assert torch.allclose(x.sum(-1), torch.ones(draws, dtype=torch.float64), atol=1e-5)
    assert bool((x >= 0).all())
    var = (a_dim - 1) / (a_dim**2 * (a_dim * alpha + 1))
    se_mean = (var / draws) ** 0.5
    assert float((x.mean(0) - 1 / a_dim).abs().max()) < 5 * se_mean
    assert abs(float(x.var(0).mean()) / var - 1) < 0.1
    lg = tmcts._log_gamma(torch.Generator().manual_seed(12), alpha, (200_000,), "cpu")
    gamma = lg.double().exp()
    assert abs(float(gamma.mean()) / alpha - 1) < 0.02
    assert abs(float(gamma.var()) / alpha - 1) < 0.05


def test_root_noise_reaches_the_search():
    n, sims = 5, 16
    roots = cases.scenario_roots(scenario_moves(n), n, "cpu")
    ev = cases.EVALUATORS["table"](n * n)

    def run(seed, frac):
        return tmcts.search_batch(None, roots, torch.Generator().manual_seed(seed),
                                  evaluator=ev, board_size=n, num_simulations=sims,
                                  dirichlet_frac=frac)

    quiet, noisy, again, other = run(0, 0.0), run(0, 0.25), run(0, 0.25), run(1, 0.25)
    assert torch.equal(noisy[0], again[0])  # the generator decides the noise
    assert not torch.equal(noisy[0], quiet[0])
    assert not torch.equal(noisy[0], other[0])
    legal = tbit.bit_legal_mask_flat(roots, roots.current_player.clamp(0, 1), n).T
    for probs, _ in (noisy, other):
        assert torch.all(probs[~legal] == 0)
        assert torch.all((probs * sims).round().sum(-1) == sims)


def test_mcts_visits_only_legal():
    # port of tests/test_models.py::test_mcts_visits_only_legal
    n, b = 5, 4
    net = create_net(n, channels=32, blocks=2, device="cpu")
    probs, root_q = tmcts.batched_search(
        net, troll.batch_reset(n, b, "cpu"), torch.Generator().manual_seed(1),
        evaluator=tmcts.net_evaluator(call_net, n), board_size=n, num_simulations=16)
    assert probs.shape == (b, n * n)
    legal = tstate.legal_mask_flat(tstate.reset(n, "cpu"), 0, n)
    assert torch.all(probs[:, ~legal] == 0)
    assert torch.allclose(probs.sum(-1), torch.ones(b), atol=1e-5)
    assert torch.all(root_q.abs() <= 1.0)


def test_mcts_prefers_winning_move():
    # port of tests/test_models.py::test_mcts_prefers_winning_move: one move
    # before the end of the reference's 8x8 win line, with a neutral net
    n = 8
    s = tstate.reset(n, "cpu")
    for a in [21, 38, 15, 11, 27, 17, 42, 45]:
        s = tstep.step(s, n, a)
    states = tstate.State(*[x[..., None] for x in s])

    def uniform_net(params, obs):
        b = obs.shape[0]
        return torch.zeros(b, n * n), torch.zeros(b)

    probs, root_q = tmcts.batched_search(
        None, states, torch.Generator().manual_seed(2),
        evaluator=tmcts.net_evaluator(uniform_net, n), board_size=n, num_simulations=128)
    best = int(probs[0].argmax())
    assert int(tstep.step(s, n, best).result) == geo.RESULT_RED_WIN, best
    assert float(root_q[0]) > 0.2


def test_argmax_takes_the_first_maximum():
    # the tie rules lean on it, an all -inf row included (jnp.argmax agrees)
    rows = torch.tensor([[-torch.inf] * 5, [1.0, 3.0, 3.0, 0.0, 3.0],
                         [-torch.inf, 2.0, -torch.inf, 2.0, 1.0]])
    assert rows.argmax(-1).tolist() == [0, 1, 1]
    assert np.asarray(jnp.argmax(jnp.asarray(rows.numpy()), -1)).tolist() == [0, 1, 1]


def test_backup_resolution_and_checks():
    assert tmcts._resolve_backup("auto", tmcts._AMASK_MAX_NODES) is True
    assert tmcts._resolve_backup("auto", tmcts._AMASK_MAX_NODES + 1) is False
    assert tmcts._AMASK_MAX_NODES == jmcts._AMASK_MAX_NODES
    with pytest.raises(ValueError, match="backup"):
        tmcts._resolve_backup("tree", 9)
    bs = tbit.bit_reset(5, 4, "cpu")
    flat = tbit.bitstate_from_leaves(x.unsqueeze(-1) for x in tbit.bitstate_leaves(bs))
    with pytest.raises(ValueError, match="1-D env batch"):
        tmcts.search_batch(None, flat, torch.Generator(), evaluator=cases.EVALUATORS["uniform"](25),
                           board_size=5, num_simulations=2)
    params = inspect.signature(tmcts.search_batch).parameters
    assert params["dirichlet_alpha"].default == 0.3 and params["c_puct"].default == 1.4


if __name__ == "__main__":
    FIXTURE.write_text(json.dumps(fixture_record()) + "\n")
    print(f"wrote {FIXTURE}")
