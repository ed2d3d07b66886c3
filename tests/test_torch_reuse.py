"""The port's tree-reusing search (``models/mcts.py`` ``search_batch_reuse``,
``init_reuse_tree``, ``reuse_nodes``, ``_descendant_mask``) against JAX's
and the naive reference, on the CPU.

The multi-move sequences of ``tests/test_reuse_exact.py`` (its board-5
scenarios, its table and uniform evaluators as the torch twins in
``tests/torch_port_cases.py``, ``dirichlet_frac=0``; the played action
alternates between the visit argmax and the lowest unvisited legal
action; finished games auto-reset): at every move the port's root visits
equal JAX's and ``tests/naive_mcts.py``'s re-rooted tree's integer for
integer, ``root_q`` is within 1e-5, and ``reused_envs`` and
``inherited_visits`` equal JAX's, for both backups and both node-state
gathers.  A tight survivor cap forces the overflow fallback; the first call
equals a cold ``search_batch``.

``tests/fixtures/torch_port_reuse.json`` holds JAX's sequences;
``chip_smoke.py`` holds the port on the card to it.  Regenerate it with
``PYTHONPATH=. python tests/test_torch_reuse.py``.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_port_cases as cases
from tests.naive_mcts import NaiveTree
from tests.oracle import OPEN, OracleGame as Board
from tests.test_mcts_exact import _scenarios, oracle_eval, table_evaluator, uniform_evaluator
from twixt_for_open_spiel_tpu.models import mcts as jmcts
from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu.ops.state import reset as jreset
from twixt_for_open_spiel_tpu.ops.step import step as jstep
from twixt_for_open_spiel_tpu_torch.models import mcts as tmcts
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_reuse.json"
N = 5
A = N * N
# (simulations, reuse_cap, moves, evaluator): tests/test_reuse_exact.py's
# sequence and its tight-cap sequence
CASES = [(12, 13, 7, "table"), (12, 6, 6, "uniform")]
FIRST_CALL = (16, "table")  # simulations, evaluator
JAX_EVALUATORS = {"table": table_evaluator, "uniform": uniform_evaluator}


def scenario_moves():
    return [list(map(int, moves)) for moves, _ in _scenarios(N)]


def jax_roots():
    states = []
    for moves in scenario_moves():
        s = jreset(N)
        for a in moves:
            s = jstep(s, N, a)
        states.append(s)
    return jbit.from_state(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, -1), *states))


def jax_sequence(sims, cap, n_moves, kind):
    bs = jax_roots()
    nb = len(scenario_moves())
    tree = jmcts.init_reuse_tree(bs, board_size=N, num_simulations=sims, reuse_cap=cap,
                                 backup="walk")
    played, done = jnp.full((nb,), -1, jnp.int32), jnp.ones((nb,), bool)
    moves = []
    for move in range(n_moves):
        probs, root_q, tree, stats = jmcts.search_batch_reuse(
            None, bs, jax.random.PRNGKey(move), tree, played, done,
            evaluator=JAX_EVALUATORS[kind](A), board_size=N, num_simulations=sims,
            reuse_cap=cap, dirichlet_frac=0.0, backup="walk", return_stats=True)
        legal = np.asarray(jbit.bit_legal_mask_flat(bs, jnp.clip(bs.current_player, 0, 1), N)).T
        kid = np.asarray(tree.root_child)
        visits = np.where(
            legal & (kid >= 0),
            np.take_along_axis(np.asarray(tree.visit), np.maximum(kid, 0), axis=1), 0)
        np.testing.assert_allclose(np.asarray(probs), visits / visits.sum(-1, keepdims=True),
                                   rtol=1e-6)
        actions = cases.next_actions(visits, legal, move)
        moves.append({"visits": visits.tolist(), "root_q": np.asarray(root_q).tolist(),
                      "reused_envs": int(stats["reused_envs"]),
                      "inherited_visits": int(stats["inherited_visits"]),
                      "actions": actions.tolist()})
        played = jnp.asarray(actions, jnp.int32)
        bs, done, _ = jbit.bit_step_auto_reset(bs, played, N)
    return {"num_simulations": sims, "reuse_cap": cap, "evaluator": kind, "moves": moves}


def jax_first_call(sims, kind):
    bs = jax_roots()
    nb = len(scenario_moves())
    tree = jmcts.init_reuse_tree(bs, board_size=N, num_simulations=sims)
    probs, root_q, _ = jmcts.search_batch_reuse(
        None, bs, jax.random.PRNGKey(0), tree, jnp.full((nb,), -1, jnp.int32),
        jnp.ones((nb,), bool), evaluator=JAX_EVALUATORS[kind](A), board_size=N,
        num_simulations=sims, dirichlet_frac=0.0)
    return {"num_simulations": sims, "evaluator": kind,
            "visits": np.rint(np.asarray(probs) * sims).astype(np.int64).tolist(),
            "root_q": np.asarray(root_q).tolist()}


def fixture_record():
    return {
        "board_size": N,
        "scenarios": scenario_moves(),
        "tolerance": "visits, reused_envs, inherited_visits exact; |root_q - jax| <= 1e-5",
        "sequences": [jax_sequence(*c) for c in CASES],
        "first_call": jax_first_call(*FIRST_CALL),
    }


@functools.lru_cache(maxsize=None)
def stored():
    return json.loads(FIXTURE.read_text())


@functools.lru_cache(maxsize=None)
def naive_sequence(i):
    """The naive reference along the stored sequence: per move, the root
    visits and root_q of every env; and the counts of re-roots and of
    cold starts other than the first."""
    rec = stored()["sequences"][i]
    sims, cap = rec["num_simulations"], rec["reuse_cap"]
    eval_fn = oracle_eval(A, rec["evaluator"])
    boards = []
    for moves in scenario_moves():
        b = Board(N)
        for a in moves:
            b.apply(a)
        boards.append(b)
    trees = [None] * len(boards)
    out, reused, fresh = [], 0, 0
    for step in rec["moves"]:
        visits, qs = [], []
        for e, b in enumerate(boards):
            if trees[e] is None:
                trees[e] = NaiveTree(b, eval_fn, A, root_prior_mode="puct")
            for _ in range(sims):
                trees[e].simulate()
            visits.append(trees[e].root_visits())
            qs.append(trees[e].root_q())
        out.append((np.array(visits), np.array(qs)))
        for e, a in enumerate(step["actions"]):
            boards[e].apply(a)
            if boards[e].result != OPEN:
                boards[e], trees[e] = Board(N), None
                fresh += 1
            elif trees[e].reroot(a, cap, frac=0.0):
                reused += 1
            else:
                trees[e] = None
                fresh += 1
    return out, reused, fresh


@pytest.mark.parametrize("backup", ["amask", "walk"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=["cap13_table", "cap6_uniform"])
def test_reuse_sequence_matches_jax_and_naive(i, backup):
    rec = stored()["sequences"][i]
    sims, cap, kind = rec["num_simulations"], rec["reuse_cap"], rec["evaluator"]
    assert (sims, cap, len(rec["moves"]), kind) == CASES[i]
    got = cases.reuse_sequence("cpu", scenario_moves(), N, sims, cap, kind, backup,
                               len(rec["moves"]))
    ref, reused, fresh = naive_sequence(i)
    for move, ((visits, root_q, stats, actions), want, (ref_v, ref_q)) in enumerate(
            zip(got, rec["moves"], ref)):
        np.testing.assert_array_equal(visits, want["visits"], err_msg=f"move {move}")
        np.testing.assert_array_equal(visits, ref_v, err_msg=f"move {move} naive")
        np.testing.assert_allclose(root_q, want["root_q"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(root_q, ref_q, rtol=0, atol=1e-5)
        assert stats == {"reused_envs": want["reused_envs"],
                         "inherited_visits": want["inherited_visits"]}, move
        assert actions.tolist() == want["actions"]
    # the sequence re-roots, and the tight cap also overflows into cold starts
    assert reused >= 3 and sum(m["reused_envs"] for m in rec["moves"]) >= 3
    if cap < sims:
        assert fresh > 0


@pytest.mark.parametrize("i", range(len(CASES)))
def test_sequence_fixture_matches_jax(i):
    assert stored()["sequences"][i] == jax_sequence(*CASES[i])


def test_first_call_matches_cold_search():
    """With nothing to reuse, the first call is a cold ``search_batch``
    (other slots, the same search) and JAX's first call."""
    sims, kind = FIRST_CALL
    bs = cases.scenario_roots(scenario_moves(), N, "cpu")
    nb = bs.current_player.shape[0]
    ev = cases.EVALUATORS[kind](A)
    cold = tmcts.search_batch(None, bs, torch.Generator(), evaluator=ev, board_size=N,
                              num_simulations=sims, dirichlet_frac=0.0)
    tree = tmcts.init_reuse_tree(bs, board_size=N, num_simulations=sims)
    probs, root_q, _, stats = tmcts.search_batch_reuse(
        None, bs, torch.Generator(), tree, torch.full((nb,), -1, dtype=torch.int32),
        torch.ones(nb, dtype=torch.bool), evaluator=ev, board_size=N, num_simulations=sims,
        dirichlet_frac=0.0, return_stats=True)
    assert torch.equal(probs, cold[0])
    torch.testing.assert_close(root_q, cold[1], rtol=0, atol=1e-6)
    assert stats == {"reused_envs": 0, "inherited_visits": nb}
    want = stored()["first_call"]
    assert (probs * sims).round().long().tolist() == want["visits"]
    np.testing.assert_allclose(root_q.numpy(), want["root_q"], rtol=0, atol=1e-5)


def test_first_call_fixture_matches_jax():
    assert stored()["first_call"] == jax_first_call(*FIRST_CALL)


@pytest.mark.parametrize("backup", ["amask", "walk"])
def test_init_reuse_tree_layout(backup):
    """The empty carry has JAX's leaves: nothing linked, no visits, no root
    child, ``reuse_nodes`` slots (``reuse_cap`` survivors + one a
    simulation)."""
    sims, cap = 12, 6
    assert tmcts.reuse_nodes(sims) == jmcts.reuse_nodes(sims) == 2 * sims + 1
    assert tmcts.reuse_nodes(sims, cap) == jmcts.reuse_nodes(sims, cap) == cap + sims
    bs = cases.scenario_roots(scenario_moves(), N, "cpu")
    got = tmcts.init_reuse_tree(bs, board_size=N, num_simulations=sims, reuse_cap=cap,
                                backup=backup)
    want = jmcts.init_reuse_tree(jax_roots(), board_size=N, num_simulations=sims,
                                 reuse_cap=cap, backup=backup)
    for name in tmcts.Tree._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w, err_msg=name)


def test_descendant_mask_variants_agree():
    """Both forms of ``_descendant_mask`` give the same subtree for every
    root child of a searched tree, and the subtree is the child and its
    linked descendants (an env without the child is not re-rooted, and
    only the walk's mask is empty there)."""
    sims = 24
    bs = cases.scenario_roots(scenario_moves(), N, "cpu")
    nb = bs.current_player.shape[0]
    tree = tmcts.init_reuse_tree(bs, board_size=N, num_simulations=sims, backup="amask")
    _, _, tree = tmcts.search_batch_reuse(
        None, bs, torch.Generator(), tree, torch.full((nb,), -1, dtype=torch.int32),
        torch.ones(nb, dtype=torch.bool), evaluator=cases.EVALUATORS["table"](A),
        board_size=N, num_simulations=sims, dirichlet_frac=0.0, backup="amask")
    nodes = tree.visit.shape[1]
    checked = 0
    for a in range(A):
        kid = tree.root_child[:, a]
        m_amask = tmcts._descendant_mask(tree, kid, nodes, True)
        m_walk = tmcts._descendant_mask(tree, kid, nodes, False)
        has = kid >= 0
        assert torch.equal(m_amask[has], m_walk[has]), a
        for e in range(nb):
            k = int(kid[e])
            if k < 0:
                assert not bool(m_walk[e].any())
                continue
            members = set(torch.nonzero(m_walk[e]).flatten().tolist())
            for s in range(nodes):
                x, inside = s, False
                while x >= 0 and bool(tree.linked[e, s]):
                    inside |= x == k
                    x = int(tree.parent[e, x])
                assert (s in members) == inside, (a, e, s)
            checked += 1
    assert checked > nb


def test_layout_mismatch_and_batch_checks():
    bs = cases.scenario_roots(scenario_moves(), N, "cpu")
    nb = bs.current_player.shape[0]
    tree = tmcts.init_reuse_tree(bs, board_size=N, num_simulations=8)
    with pytest.raises(ValueError, match="tree layout mismatch"):
        tmcts.search_batch_reuse(None, bs, torch.Generator(), tree,
                                 torch.full((nb,), -1), torch.ones(nb, dtype=torch.bool),
                                 evaluator=cases.EVALUATORS["uniform"](A), board_size=N,
                                 num_simulations=8, reuse_cap=4)
    flat = tbit.bitstate_from_leaves(x.unsqueeze(-1) for x in tbit.bitstate_leaves(bs))
    with pytest.raises(ValueError, match="1-D env batch"):
        tmcts.search_batch_reuse(None, flat, torch.Generator(), tree,
                                 torch.full((nb,), -1), torch.ones(nb, dtype=torch.bool),
                                 evaluator=cases.EVALUATORS["uniform"](A), board_size=N,
                                 num_simulations=8)


def test_root_noise_is_drawn_at_zero_fraction():
    """The Dirichlet draw happens even at ``dirichlet_frac=0``: the
    generator moves on by one draw, and the search is unchanged by it."""
    sims = 8
    bs = cases.scenario_roots(scenario_moves(), N, "cpu")
    nb = bs.current_player.shape[0]
    g = torch.Generator().manual_seed(4)
    tree = tmcts.init_reuse_tree(bs, board_size=N, num_simulations=sims)
    tmcts.search_batch_reuse(None, bs, g, tree, torch.full((nb,), -1),
                             torch.ones(nb, dtype=torch.bool),
                             evaluator=cases.EVALUATORS["uniform"](A), board_size=N,
                             num_simulations=sims, dirichlet_frac=0.0)
    h = torch.Generator().manual_seed(4)
    tmcts.dirichlet(h, 0.3, (nb, A), "cpu")
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=h))


if __name__ == "__main__":
    FIXTURE.write_text(json.dumps(fixture_record()) + "\n")
    print(f"wrote {FIXTURE}")
