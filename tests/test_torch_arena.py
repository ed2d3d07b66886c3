"""The port's arena (``models/arena.py``) against JAX's ``arena_match``, on
the CPU.

A deterministic match (``temp_moves=0``, ``random_b=False``) between two
table nets (``tests/torch_port_cases.arena_table_net`` and its JAX twin
below) plays JAX's games move for move: the tally, the move count and the
digest of the final boards are equal.  JAX's ``arena_match`` returns only
the tally, so the JAX final boards come from a mirror of its loop here,
held to the same tally and move count.  The random parts (sampled plies,
the random bot) are pinned by distribution and by legality.

The deterministic match with ``reuse_a=True`` (A's searches inherit the
game's tree) gives JAX's tally too.  The Gumbel arena and
``arena_match_asym`` draw Gumbels from the generator, so they are pinned by
legality (every move checked against its state's legal mask) and by their
tallies' invariants.

``tests/fixtures/torch_port_arena.json`` and ``torch_port_arena_reuse.json``
hold the JAX records; ``chip_smoke.py`` holds the port on the card to the
first.  Regenerate them with ``PYTHONPATH=. python tests/test_torch_arena.py``.
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
from twixt_for_open_spiel_tpu.models import arena as jarena
from twixt_for_open_spiel_tpu.models import mcts as jmcts
from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu.ops import geometry as jgeo
from twixt_for_open_spiel_tpu_torch.models import arena as tarena
from twixt_for_open_spiel_tpu_torch.models.network import create_net
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_arena.json"
REUSE_FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_arena_reuse.json"
MATCH = {"board_size": 5, "batch": 8, "num_simulations": 12}
TALLY_KEYS = ("a_wins", "b_wins", "draws", "games", "moves", "a_score")


def jax_table_net(params, obs):
    """The JAX twin of ``cases.arena_table_net``: the same float32 ops."""
    table, offset = params
    count = obs.astype(jnp.float32).sum(axis=(1, 2, 3))
    value = (jnp.mod(count * 7.0 + offset, 11.0) - 5.0) / 7.0
    return jnp.broadcast_to(table, (obs.shape[0], table.shape[0])), value


def jax_params(side):
    table, offset = cases.arena_table_params(MATCH["board_size"] ** 2, side, "cpu")
    return jnp.asarray(table.numpy()), jnp.float32(offset)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _mirror_move(bs, dummy, params, n, num_simulations):
    """One move of JAX ``arena_match``'s loop at ``temp_moves=0`` without
    the random bot."""
    open_ = bs.result == jgeo.RESULT_OPEN

    def pick(new, old):
        return jnp.where(jnp.broadcast_to(open_, new.shape), new, old)

    safe = jax.tree_util.tree_map(pick, bs, dummy)
    player = jnp.clip(safe.current_player, 0, 1)
    probs, _ = jmcts.search_batch(
        params, safe, jax.random.PRNGKey(0),
        evaluator=jarena._dual_net_evaluator(jax_table_net, n), board_size=n,
        num_simulations=num_simulations, dirichlet_frac=0.0)
    legal = jnp.moveaxis(jbit.bit_legal_mask_flat(safe, player, n), 0, -1)
    action = jnp.argmax(jnp.where(legal, probs, -1.0), -1).astype(jnp.int32)
    return jax.tree_util.tree_map(pick, jbit.step_bits(safe, n, action), bs)


def jax_arena_final(board_size, batch, num_simulations):
    """A mirror of JAX ``arena_match``'s loop: (final BitState, moves)."""
    n = board_size
    a_is_red = (jnp.arange(batch, dtype=jnp.int32) % 2) == 0
    bs, dummy = jbit.bit_reset(n, batch), jbit.bit_reset(n, batch)
    params = (jax_params(0), jax_params(1), a_is_red)
    move = 0
    while move < n * n - 3 + 1 and bool(jnp.any(bs.result == jgeo.RESULT_OPEN)):
        bs = _mirror_move(bs, dummy, params, n, num_simulations)
        move += 1
    return bs, move


def jax_record():
    tally = jarena.arena_match(
        jax_params(0), jax_params(1), jax.random.PRNGKey(0), net_apply=jax_table_net,
        temp_moves=0, **MATCH)
    final, moves = jax_arena_final(**MATCH)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(final)]
    return {
        **MATCH,
        "tally": {k: float(tally[k]) for k in TALLY_KEYS},
        "mirror_moves": moves,
        "digest": tbit.state_digest(tbit.bitstate_from_numpy(leaves, "cpu")),
    }


def jax_reuse_record():
    tally = jarena.arena_match(
        jax_params(0), jax_params(1), jax.random.PRNGKey(0), net_apply=jax_table_net,
        temp_moves=0, reuse_a=True, **MATCH)
    return {**MATCH, "reuse_a": True, "tally": {k: float(tally[k]) for k in TALLY_KEYS}}


@functools.lru_cache(maxsize=None)
def stored():
    return json.loads(FIXTURE.read_text())


@functools.lru_cache(maxsize=None)
def stored_reuse():
    return json.loads(REUSE_FIXTURE.read_text())


def port_match(generator_seed=0, **kw):
    a_dim = MATCH["board_size"] ** 2
    return tarena.arena_match(
        cases.arena_table_params(a_dim, 0, "cpu"), cases.arena_table_params(a_dim, 1, "cpu"),
        torch.Generator().manual_seed(generator_seed), net_apply=cases.arena_table_net,
        device="cpu", **{**MATCH, "temp_moves": 0, **kw})


def test_fixture_matches_jax():
    rec = jax_record()
    assert rec["mirror_moves"] == rec["tally"]["moves"]
    assert stored() == rec


def test_deterministic_arena_matches_jax():
    got = port_match()
    rec = stored()
    assert {k: float(got[k]) for k in TALLY_KEYS} == rec["tally"]
    assert tbit.state_digest(got["final_state"]) == rec["digest"]
    # deterministic: another generator plays the same games
    assert tbit.state_digest(port_match(generator_seed=5)["final_state"]) == rec["digest"]


def test_dual_evaluator_picks_the_movers_net():
    n, b = 5, 6
    bs = tbit.bit_reset(n, b, "cpu")
    bs = tbit.step_bits(bs, n, torch.tensor([7, 7, 7, 12, 12, 12], dtype=torch.int32))
    # envs 0-2 to move blue, 3-5 too; A is red in envs 0, 2, 4
    a_is_red = torch.arange(b) % 2 == 0
    pa = cases.arena_table_params(n * n, 0, "cpu")
    pb = cases.arena_table_params(n * n, 1, "cpu")
    ev = tarena._dual_net_evaluator(cases.arena_table_net, n)
    logits, _ = ev((pa, pb, a_is_red), bs, None)
    for e in range(b):
        want = pb[0] if bool(a_is_red[e]) else pa[0]  # blue to move
        assert torch.equal(logits[e], want), e


def test_categorical_by_distribution():
    probs = torch.tensor([0.5, 0.25, 0.125, 0.125, 0.0])
    logits = torch.where(probs > 0, probs.log(), -torch.inf).expand(40000, 5)
    draws = tarena._categorical(torch.Generator().manual_seed(3), logits)
    freq = torch.bincount(draws, minlength=5).double() / draws.numel()
    assert float(freq[4]) == 0.0
    se = (probs * (1 - probs) / draws.numel()).sqrt()
    assert bool(((freq - probs).abs() <= 5 * se + 1e-12).all()), freq


@pytest.mark.parametrize("random_b", [False, True])
def test_net_arena_plays_legal_games(random_b):
    n, batch = 5, 4
    net = create_net(n, channels=8, blocks=1, device="cpu")

    def play(seed):
        return tarena.arena_match(net, net, torch.Generator().manual_seed(seed), board_size=n,
                                  batch=batch, num_simulations=2, temp_moves=2,
                                  random_b=random_b, device="cpu")

    t = play(0)
    assert t["a_wins"] + t["b_wins"] + t["draws"] == t["games"] == batch
    assert 0 < t["moves"] <= n * n - 2
    final = t["final_state"]
    assert bool((final.result != geo.RESULT_OPEN).all())
    assert t["a_score"] == (t["a_wins"] + 0.5 * t["draws"]) / batch
    again = play(0)
    assert tbit.state_digest(again["final_state"]) == tbit.state_digest(final)
    # sampled plies (and the random bot) follow the generator
    others = {tbit.state_digest(play(s)["final_state"]) for s in (1, 2)}
    assert others - {tbit.state_digest(final)}


def test_reuse_fixture_matches_jax():
    assert stored_reuse() == jax_reuse_record()


def test_reuse_arena_matches_jax():
    """A's searches reuse the game's tree: JAX's tally and move count, legal
    moves only, and other games than the cold match's."""
    with cases.checked_moves() as counts:
        got = port_match(reuse_a=True)
    assert {k: float(got[k]) for k in TALLY_KEYS} == stored_reuse()["tally"]
    assert counts["illegal"] == 0 and counts["moves"] == got["moves"] * MATCH["batch"]
    assert tbit.state_digest(got["final_state"]) != stored()["digest"]


def check_tally(t, batch, n):
    assert t["a_wins"] + t["b_wins"] + t["draws"] == t["games"] == batch
    assert 0 < t["moves"] <= n * n - 2
    assert bool((t["final_state"].result != geo.RESULT_OPEN).all())
    assert t["a_score"] == (t["a_wins"] + 0.5 * t["draws"]) / batch


@pytest.mark.parametrize("random_b", [False, True])
def test_gumbel_arena_plays_legal_games(random_b):
    n, batch = 5, 4
    net = create_net(n, channels=8, blocks=1, device="cpu")

    def play(seed):
        with cases.checked_moves() as counts:
            t = tarena.arena_match(net, net, torch.Generator().manual_seed(seed), board_size=n,
                                   batch=batch, num_simulations=4, temp_moves=2,
                                   random_b=random_b, search="gumbel", device="cpu")
        assert counts["illegal"] == 0 and counts["moves"] == t["moves"] * batch
        return t

    t = play(0)
    check_tally(t, batch, n)
    again = play(0)
    assert tbit.state_digest(again["final_state"]) == tbit.state_digest(t["final_state"])
    others = {tbit.state_digest(play(s)["final_state"]) for s in (1, 2)}
    assert others - {tbit.state_digest(t["final_state"])}


@pytest.mark.parametrize("greedy_a", [True, False])
def test_asym_arena_plays_legal_games(greedy_a, monkeypatch):
    """Gumbel for A and PUCT for B, both on the whole batch every ply; A
    plays the argmax of the improved policy (or the surviving candidate),
    B its visit counts."""
    n, batch = 5, 4
    net = create_net(n, channels=8, blocks=1, device="cpu")
    calls = []
    real_g, real_p = tarena.mcts.gumbel_search_batch, tarena.mcts.search_batch

    def spy_g(*args, **kw):
        out = real_g(*args, **kw)
        calls.append(("gumbel", kw["num_simulations"], kw["max_considered"], out))
        return out

    def spy_p(*args, **kw):
        out = real_p(*args, **kw)
        calls.append(("puct", kw["num_simulations"], kw["dirichlet_frac"], out))
        return out

    monkeypatch.setattr(tarena.mcts, "gumbel_search_batch", spy_g)
    monkeypatch.setattr(tarena.mcts, "search_batch", spy_p)
    with cases.checked_moves() as counts:
        t = tarena.arena_match_asym(net, torch.Generator().manual_seed(1), board_size=n,
                                    batch=batch, sims_a=4, sims_b=6, temp_moves=0,
                                    greedy_a=greedy_a, max_considered_a=3, device="cpu")
    check_tally(t, batch, n)
    assert counts["illegal"] == 0 and counts["moves"] == t["moves"] * batch
    assert [c[:3] for c in calls] == [("gumbel", 4, 3), ("puct", 6, 0.0)] * t["moves"]
    # the first ply, red to move everywhere: A (red in even envs) plays the
    # improved policy's argmax or its candidate, B the visit argmax
    cand, improved, _ = calls[0][3]
    probs, _ = calls[1][3]
    want_a = improved.argmax(-1) if greedy_a else cand
    first = counts["actions"][0]
    assert torch.equal(first[0::2], want_a[0::2])
    assert torch.equal(first[1::2], probs.argmax(-1)[1::2])


def test_arena_option_checks():
    kw = dict(board_size=5, batch=2, num_simulations=2, device="cpu")
    with pytest.raises(ValueError, match="reuse_a is PUCT-only"):
        tarena.arena_match(None, None, torch.Generator(), search="gumbel", reuse_a=True, **kw)
    with pytest.raises(ValueError, match="search"):
        tarena.arena_match(None, None, torch.Generator(), search="beam", **kw)


def test_arena_defaults_to_the_card():
    params = inspect.signature(tarena.arena_match).parameters
    assert params["device"].default == "cuda"
    assert params["temp_moves"].default == 6 and params["search"].default == "puct"
    asym = inspect.signature(tarena.arena_match_asym).parameters
    assert asym["device"].default == "cuda" and asym["greedy_a"].default is True
    assert asym["max_considered_a"].default == 16 and asym["temp_moves"].default == 6


if __name__ == "__main__":
    FIXTURE.write_text(json.dumps(jax_record(), indent=1) + "\n")
    REUSE_FIXTURE.write_text(json.dumps(jax_reuse_record(), indent=1) + "\n")
    print(FIXTURE.read_text())
