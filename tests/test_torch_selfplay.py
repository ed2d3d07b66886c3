"""The port's self-play (``models/selfplay.py``) against JAX's
``selfplay_chunk``, on the CPU.

A deterministic chunk (the table net of ``tests/torch_port_cases``, greedy
plies, no root noise) emits JAX's chunk bit for bit: the obs wire, the
policy, value and weight targets, the final boards and the debug aux, with
and without the value bootstrap.  The ports of JAX's self-play pins
(``tests/test_models.py``) run on the port alone; the random parts (root
noise, sampled plies) are pinned by distribution and by legality.  A
ground-truth pin fixes the sign conventions by a position whose winner is
known, on both sides.

The other search arms have deterministic chunks too, on the same roots
with the value bootstrap: ``search="puct_reuse"`` (greedy, no root noise)
equals JAX's ``selfplay_chunk``, and ``search="gumbel"`` with zero
Gumbels (the port's draw patched) equals a mirror of JAX's chunk loop
that passes ``gumbel_noise=zeros`` (the improved-policy targets within
1e-6, the rest bit for bit).

``tests/fixtures/torch_port_selfplay.json`` and
``torch_port_selfplay_arms.json`` hold the JAX records; ``chip_smoke.py``
holds the port on the card to them.  Regenerate them with
``PYTHONPATH=. python tests/test_torch_selfplay.py``.
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
from twixt_for_open_spiel_tpu.models import mcts as jmcts
from twixt_for_open_spiel_tpu.models import selfplay as jsp
from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu.ops import geometry as jgeo
from twixt_for_open_spiel_tpu.ops import observe as jobs
from twixt_for_open_spiel_tpu_torch.models import mcts as tmcts
from twixt_for_open_spiel_tpu_torch.models import selfplay as tsp
from twixt_for_open_spiel_tpu_torch.models.network import create_net
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import observe as tobs
from twixt_for_open_spiel_tpu_torch.ops import state as tstate
from twixt_for_open_spiel_tpu_torch.ops import step as tstep

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_selfplay.json"
ARMS_FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_selfplay_arms.json"
IMPROVED_TOL = 1e-6
BOOTSTRAPS = (0.0, 0.5)
N = 5


def jax_chunk_net(params, obs):
    """The JAX twin of ``cases.chunk_table_net``: the same float32 ops."""
    table, offset = params
    count = obs.astype(jnp.float32).sum(axis=(1, 2, 3))
    value = (jnp.mod(count * 7.0 + offset, 11.0) - 5.0) / 8.0
    return jnp.broadcast_to(table, (obs.shape[0], table.shape[0])), value


def port_state(jbs):
    return tbit.bitstate_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(jbs)],
                                    "cpu")


def port_sample(sample):
    """A JAX Sample as the port's (u32 words viewed as int32)."""
    return tsp.Sample(torch.from_numpy(np.array(sample.obs).view(np.int32)),
                      *(torch.from_numpy(np.array(x)) for x in sample[1:]))


def jax_chunk_inputs():
    """The deterministic chunk's table-net parameters and roots, for JAX."""
    c = cases.CHUNK
    n = c["board_size"]
    table, offset = cases.arena_table_params(n * n, 0, "cpu")
    params = (jnp.asarray(table.numpy()), jnp.float32(offset))
    roots, _ = jbit.bit_random_rollout(c["rollout_seed"], n, c["rollout_steps"],
                                       jbit.bit_reset(n, c["batch"]))
    return params, roots


def jax_record():
    c = cases.CHUNK
    n = c["board_size"]
    params, roots = jax_chunk_inputs()
    rec = {**c, "temp_moves": 0, "dirichlet_frac": 0.0, "chunks": {}}
    for vb in BOOTSTRAPS:
        final, sample, aux = jsp.selfplay_chunk(
            params, roots, jax.random.PRNGKey(0), net_apply=jax_chunk_net, board_size=n,
            num_steps=c["num_steps"], num_simulations=c["num_simulations"], temp_moves=0,
            dirichlet_frac=0.0, value_bootstrap=vb, debug_trace=True)
        aux = {k: torch.from_numpy(np.array(v)) for k, v in aux.items()}
        rec["chunks"][str(vb)] = cases.sample_record(port_state(final), port_sample(sample), aux)
    return rec


def jax_gumbel_chunk(params, roots, value_bootstrap):
    """A mirror of JAX ``selfplay_chunk(search="gumbel")``'s scan and
    backward scan, its search called with ``gumbel_noise=zeros``: (final
    BitState, Sample, aux with the actions)."""
    c = cases.CHUNK
    n = c["board_size"]
    zeros = jnp.zeros((c["batch"], n * n), jnp.float32)
    evaluator = jmcts.net_evaluator(jax_chunk_net, n)
    bs, tr = roots, {k: [] for k in ("obs", "policy", "player", "done", "result", "actions")}
    for t in range(c["num_steps"]):
        tr["obs"].append(jobs.bit_observation_packed_with_legal(bs, n))
        tr["player"].append(jnp.clip(bs.current_player, 0, 1))
        actions, probs, root_q = jmcts.gumbel_search_batch(
            params, bs, jax.random.PRNGKey(t), evaluator=evaluator, board_size=n,
            num_simulations=c["num_simulations"], gumbel_noise=zeros)
        actions = actions.astype(jnp.int32)
        bs, done, result = jbit.bit_step_auto_reset(bs, actions, n)
        tr["policy"].append(probs)
        tr["done"].append(done)
        tr["result"].append(result)
        tr["actions"].append(actions)
    tr = {k: jnp.stack(v) for k, v in tr.items()}
    z_red = jnp.where(tr["player"][-1] == 0, root_q, -root_q)
    w = jnp.full(z_red.shape, float(value_bootstrap))
    zs, ws = [], []
    for t in reversed(range(c["num_steps"])):
        z_here = jnp.where(tr["result"][t] == jgeo.RESULT_RED_WIN, 1.0,
                           jnp.where(tr["result"][t] == jgeo.RESULT_BLUE_WIN, -1.0, 0.0))
        z_red = jnp.where(tr["done"][t], z_here, z_red)
        w = jnp.where(tr["done"][t], 1.0, w)
        zs.append(z_red)
        ws.append(w)
    z_red = jnp.stack(zs[::-1])
    sample = jsp.Sample(obs=tr["obs"], policy=tr["policy"],
                        value=jnp.where(tr["player"] == 0, z_red, -z_red),
                        weight=jnp.stack(ws[::-1]).astype(jnp.float32))
    return bs, sample, {"player": tr["player"], "root_q_last": root_q,
                        "actions": tr["actions"]}


def jax_arms_record():
    c = cases.CHUNK
    n = c["board_size"]
    params, roots = jax_chunk_inputs()
    rec = {**c, "temp_moves": 0, "dirichlet_frac": 0.0, "value_bootstrap": cases.ARM_BOOTSTRAP,
           "gumbel_noise": 0.0, "tolerance": f"gumbel policy {IMPROVED_TOL}; the rest exact",
           "chunks": {}}
    for search in cases.ARMS:
        if search == "gumbel":
            final, sample, aux = jax_gumbel_chunk(params, roots, cases.ARM_BOOTSTRAP)
        else:
            final, sample, aux = jsp.selfplay_chunk(
                params, roots, jax.random.PRNGKey(0), net_apply=jax_chunk_net, board_size=n,
                num_steps=c["num_steps"], num_simulations=c["num_simulations"], temp_moves=0,
                search=search, dirichlet_frac=0.0, value_bootstrap=cases.ARM_BOOTSTRAP,
                debug_trace=True)
        aux = {k: torch.from_numpy(np.array(v)) for k, v in aux.items()}
        rec["chunks"][search] = cases.sample_record(port_state(final), port_sample(sample), aux)
    return rec


@functools.lru_cache(maxsize=None)
def stored():
    return json.loads(FIXTURE.read_text())


@functools.lru_cache(maxsize=None)
def stored_arms():
    return json.loads(ARMS_FIXTURE.read_text())


def test_fixture_matches_jax():
    rec = jax_record()
    assert stored() == rec
    # the chunk mixes finished and unfinished frames, and bootstrapped ones
    w0 = np.array(rec["chunks"]["0.0"]["weight"])
    assert 0 < w0.sum() < w0.size
    w5 = np.array(rec["chunks"]["0.5"]["weight"])
    assert set(np.unique(w5)) == {0.5, 1.0}
    assert np.any(np.array(rec["chunks"]["0.5"]["aux"]["root_q_last"]) != 0)


@pytest.mark.parametrize("vb", BOOTSTRAPS)
def test_deterministic_chunk_matches_jax(vb):
    final, sample, aux = cases.deterministic_chunk("cpu", vb, debug_trace=True)
    want = stored()["chunks"][str(vb)]
    got = cases.sample_record(final, sample, aux)
    assert sample.obs.dtype == torch.int32
    for key in ("obs_sha256", "obs_shape", "policy", "value", "weight", "final_digest"):
        assert got[key] == want[key], key
    assert {k: got["aux"][k] for k in want["aux"]} == want["aux"]
    # without the trace: the same chunk
    final2, sample2 = cases.deterministic_chunk("cpu", vb)
    assert tbit.state_digest(final2) == want["final_digest"]
    assert all(torch.equal(a, b) for a, b in zip(sample, sample2))


def test_arms_fixture_matches_jax():
    rec = jax_arms_record()
    assert stored_arms() == rec
    for search in cases.ARMS:
        # finished, bootstrapped and exact-outcome frames all occur
        assert set(np.unique(rec["chunks"][search]["weight"])) == {0.5, 1.0}, search
        assert np.any(np.array(rec["chunks"][search]["aux"]["root_q_last"]) != 0), search
    # the arms differ from each other and from the cold PUCT chunk
    digests = {rec["chunks"][s]["obs_sha256"] for s in cases.ARMS}
    digests.add(stored()["chunks"]["0.5"]["obs_sha256"])
    assert len(digests) == 3


@pytest.mark.parametrize("search", cases.ARMS)
def test_arm_chunk_matches_jax(search):
    final, sample, aux = cases.arm_chunk("cpu", search)
    want = stored_arms()["chunks"][search]
    got = cases.sample_record(final, sample, aux)
    for key in ("obs_sha256", "obs_shape", "value", "weight", "final_digest"):
        assert got[key] == want[key], key
    assert {k: got["aux"][k] for k in want["aux"]} == want["aux"]
    if search == "gumbel":
        np.testing.assert_allclose(np.array(got["policy"]), np.array(want["policy"]),
                                   rtol=0, atol=IMPROVED_TOL)
    else:
        assert got["policy"] == want["policy"]


def small_net():
    return create_net(N, channels=8, blocks=1, device="cpu")


def replay(roots, actions, n):
    """The pre-move state of every frame, replaying the recorded actions."""
    states, bs = [], roots
    for a in actions:
        states.append(bs)
        bs = tbit.bit_step_auto_reset(bs, a, n)[0]
    return states, bs


def test_selfplay_chunk_and_train():
    b, t = 4, 12
    net = small_net()
    final, sample = tsp.selfplay_chunk(
        net, tbit.bit_reset(N, b, "cpu"), torch.Generator().manual_seed(3), board_size=N,
        num_steps=t, num_simulations=8)
    assert sample.obs.shape == (t, b, geo.NUM_PLANES * (N + 2 * geo.PAD))
    assert sample.policy.shape == (t, b, N * N)
    assert sample.value.shape == sample.weight.shape == (t, b)
    assert final.current_player.shape == (b,)
    w, v = sample.weight, sample.value
    assert set(w.unique().tolist()) <= {0.0, 1.0}
    assert bool((v[w > 0].abs() <= 1.0).all())
    before = [p.detach().clone() for p in net.parameters()]
    opt = tsp.make_optimizer(net.parameters(), 1e-3)
    metrics = tsp.train_step(net, opt, sample)
    assert np.isfinite(float(metrics["loss"]))
    assert not any(m.requires_grad for m in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(before, net.parameters()))


def test_value_bootstrap_targets():
    """The bootstrap leaves finished frames exactly as the outcome-only
    path has them, gives every unfinished frame the last root value in its
    mover's perspective at the bootstrap weight, and leaves the wire and
    the policy alone; then the exact sign pin on a biased value head."""
    net = small_net()
    kw = dict(board_size=N, num_steps=6, num_simulations=4)

    def chunk(vb, **extra):
        return tsp.selfplay_chunk(net, tbit.bit_reset(N, 8, "cpu"),
                                  torch.Generator().manual_seed(9), value_bootstrap=vb,
                                  **kw, **extra)

    _, s_plain = chunk(0.0)
    _, s_boot = chunk(0.5)
    assert torch.equal(s_plain.obs, s_boot.obs)
    assert torch.equal(s_plain.policy, s_boot.policy)
    fin = s_plain.weight == 1.0
    assert bool(fin.any())
    assert bool((s_boot.weight[fin] == 1.0).all())
    assert torch.equal(s_boot.value[fin], s_plain.value[fin])
    unf = s_plain.weight == 0.0
    assert bool(unf.any()), "the test needs chunk-truncated episodes"
    assert bool((s_boot.weight[unf] == 0.5).all())
    assert bool((s_boot.value[unf].abs() <= 1.0 + 1e-6).all())
    for e in range(8):
        col = torch.nonzero(unf[:, e]).flatten()
        if len(col) >= 2:
            assert len(set(s_boot.value[col, e].abs().round(decimals=6).tolist())) == 1

    # the fresh net's zero-init value head makes every root value 0, so
    # bias the value by position
    def biased(params, obs):
        logits, v = params(obs)
        bias = torch.tanh(obs.sum(dim=(1, 2, 3)) * 0.11 - 0.3)
        return logits, (v + bias).clamp(-0.95, 0.95)

    _, s_dbg, aux = chunk(0.5, net_apply=biased, debug_trace=True)
    unf = s_dbg.weight == 0.5
    assert bool(unf.any())
    player, q_last = aux["player"], aux["root_q_last"]
    z_red = torch.where(player[-1] == 0, q_last, -q_last)
    want = torch.where(player == 0, z_red[None, :], -z_red[None, :])
    torch.testing.assert_close(s_dbg.value[unf], want[unf], rtol=0, atol=1e-6)
    v = s_dbg.value[unf]
    assert bool((v.abs() > 1e-4).any())
    assert bool((v > 0).any()) and bool((v < 0).any())


@pytest.mark.parametrize("vb", [-0.1, 1.5])
def test_value_bootstrap_range_validated(vb):
    with pytest.raises(ValueError, match="value_bootstrap"):
        tsp.selfplay_chunk(small_net(), tbit.bit_reset(N, 4, "cpu"), torch.Generator(),
                           board_size=N, num_steps=2, num_simulations=2, value_bootstrap=vb)


def test_policy_ce_gradient_covers_legal_set():
    """A legal action with no visits gets gradient (it sits in the softmax's
    denominator), an illegal one exactly none; equal to JAX's."""
    legal = np.array([True, True, True, False, True, False])
    target = np.array([0.75, 0.25, 0.0, 0.0, 0.0, 0.0], np.float32)
    logits = np.arange(6, dtype=np.float32) * np.float32(0.3)

    x = torch.from_numpy(logits).requires_grad_(True)
    ce = tsp.policy_ce(x, torch.from_numpy(target), torch.from_numpy(legal))
    ce.backward()
    g = x.grad.numpy()
    assert abs(g[2]) > 1e-6 and abs(g[4]) > 1e-6, "a legal zero-visit action got no gradient"
    assert g[3] == 0.0 and g[5] == 0.0, "an illegal action got gradient"
    g_jax = np.asarray(jax.grad(lambda lg: jsp.policy_ce(lg, target, legal))(logits))
    np.testing.assert_allclose(g, g_jax, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ce.item(), float(jsp.policy_ce(logits, target, legal)), rtol=1e-6)
    uniform = torch.from_numpy(np.where(legal, 0.25, 0.0).astype(np.float32))
    ce_u = tsp.policy_ce(torch.zeros(6), uniform, torch.from_numpy(legal))
    assert abs(float(ce_u) - np.log(4.0)) <= 1e-6


def test_selfplay_policy_targets_match_engine_legality():
    """Replaying the chunk's actions gives every frame's state: the wire's
    legal plane equals the engine's mask there, the wire's observation its
    observation, the policy has no mass off the legal set, and the replay
    ends at the chunk's final state."""
    b, t = 3, 6
    roots = tbit.bit_random_rollout(5, N, 4, tbit.bit_reset(N, b, "cpu"))[0]
    final, sample, aux = tsp.selfplay_chunk(
        small_net(), roots, torch.Generator().manual_seed(8), board_size=N, num_steps=t,
        num_simulations=4, debug_trace=True)
    torch.testing.assert_close(sample.policy.sum(-1), torch.ones(t, b), rtol=0, atol=1e-5)
    states, end = replay(roots, aux["actions"], N)
    assert tbit.state_digest(end) == tbit.state_digest(final)
    pk = sample.obs.reshape(t, b, 12, N + 2 * geo.PAD)
    legal = tobs.unpack_legal_words_flat(tobs.legal_words_from_obs(pk), N)
    for k, bs in enumerate(states):
        mask = tbit.bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), N).T
        assert torch.equal(legal[k], mask), k
        assert bool((sample.policy[k][~mask] == 0).all()), k
        assert bool(mask[torch.arange(b), aux["actions"][k].long()].all()), k
        assert torch.equal(tobs.unpack_observation_nchw(pk[k], N),
                           tobs.bit_observation_nchw(bs, N)), k
        assert torch.equal(aux["player"][k], bs.current_player.clamp(0, 1)), k


def test_temp_moves_anneal():
    """Plies with the move counter at or past ``temp_moves`` are the argmax
    (the first maximum) of the legal visit counts; earlier ones are draws
    on the visit support."""
    b, t, temp_moves = 6, 8, 3
    roots = tbit.bit_reset(N, b, "cpu")
    _, sample, aux = tsp.selfplay_chunk(
        small_net(), roots, torch.Generator().manual_seed(4), board_size=N, num_steps=t,
        num_simulations=6, temp_moves=temp_moves, debug_trace=True)
    states, _ = replay(roots, aux["actions"], N)
    greedy_seen = sampled_off_argmax = 0
    for k, bs in enumerate(states):
        mask = tbit.bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), N).T
        argmax = torch.where(mask, sample.policy[k], -1.0).argmax(-1)
        act = aux["actions"][k].long()
        late = bs.move_counter >= temp_moves
        assert torch.equal(act[late], argmax[late]), k
        assert bool((sample.policy[k][torch.arange(b), act] > 0).all()), k
        greedy_seen += int(late.sum())
        sampled_off_argmax += int((act != argmax)[~late].sum())
    assert greedy_seen > 0
    assert sampled_off_argmax > 0, "early plies should not all be the argmax"


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sampled_plies_by_frequency(temperature):
    """One ply from identical roots with a deterministic search: every env
    has the same visit counts, and the played actions follow
    visits**(1/temperature), normalised."""
    b, sims = 2048, 12
    table = cases.arena_table_params(N * N, 0, "cpu")
    roots = tbit.bit_reset(N, b, "cpu")
    _, sample, aux = tsp.selfplay_chunk(
        table, roots, torch.Generator().manual_seed(11), net_apply=cases.chunk_table_net,
        board_size=N, num_steps=1, num_simulations=sims, dirichlet_frac=0.0,
        temperature=temperature, debug_trace=True)
    probs = sample.policy[0].double()
    assert bool((probs == probs[0]).all())
    want = probs[0] ** (1.0 / temperature)
    want = want / want.sum()
    assert int((want > 0).sum()) >= 3
    freq = torch.bincount(aux["actions"][0].long(), minlength=N * N).double() / b
    assert float(freq[want == 0].sum()) == 0.0
    se = (want * (1 - want) / b).sqrt()
    assert bool(((freq - want).abs() <= 5 * se + 1e-12).all()), (freq, want)


@pytest.mark.parametrize("search", ["gumbel", "puct_reuse"])
def test_search_arms_run(search, monkeypatch):
    """Each arm plays legal moves from its own search, targets a
    distribution over the legal set, and feeds its root values to the
    bootstrap; a Gumbel chunk plays its surviving candidates and a reuse
    chunk carries its tree (a tight ``reuse_cap`` is passed through)."""
    b, t = 4, 6
    roots = tbit.bit_random_rollout(5, N, 4, tbit.bit_reset(N, b, "cpu"))[0]
    seen = []
    real_gumbel, real_reuse = tmcts.gumbel_search_batch, tmcts.search_batch_reuse

    def spy_gumbel(*args, **kw):
        out = real_gumbel(*args, **kw)
        seen.append(out[0])
        return out

    def spy_reuse(*args, **kw):
        seen.append((args[3], args[4], args[5], kw["reuse_cap"]))
        return real_reuse(*args, **kw)

    monkeypatch.setattr(tmcts, "gumbel_search_batch", spy_gumbel)
    monkeypatch.setattr(tmcts, "search_batch_reuse", spy_reuse)
    final, sample, aux = tsp.selfplay_chunk(
        small_net(), roots, torch.Generator().manual_seed(2), board_size=N, num_steps=t,
        num_simulations=4, search=search, reuse_cap=3, value_bootstrap=0.5, debug_trace=True)
    assert len(seen) == t
    states, end = replay(roots, aux["actions"], N)
    assert tbit.state_digest(end) == tbit.state_digest(final)
    torch.testing.assert_close(sample.policy.sum(-1), torch.ones(t, b), rtol=0, atol=1e-5)
    for k, bs in enumerate(states):
        mask = tbit.bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), N).T
        assert bool((sample.policy[k][~mask] == 0).all()), k
        assert bool(mask[torch.arange(b), aux["actions"][k].long()].all()), k
    if search == "gumbel":
        assert all(torch.equal(a.int(), p) for a, p in zip(seen, aux["actions"]))
    else:
        tree0, played0, done0, cap = seen[0]
        assert cap == 3 and tree0.visit.shape == (b, 3 + 4) and not bool(tree0.linked.any())
        assert played0.tolist() == [-1] * b and bool(done0.all())
        for k in range(1, t):  # the previous ply's action and reset flags
            _, played, done, _ = seen[k]
            assert torch.equal(played, aux["actions"][k - 1])
    z_red = torch.where(aux["player"][-1] == 0, aux["root_q_last"], -aux["root_q_last"])
    unf = sample.weight == 0.5
    want = torch.where(aux["player"] == 0, z_red[None, :], -z_red[None, :])
    torch.testing.assert_close(sample.value[unf], want[unf], rtol=0, atol=1e-6)


def test_unknown_search_raises():
    with pytest.raises(ValueError, match="search"):
        tsp.selfplay_chunk(None, tbit.bit_reset(N, 2, "cpu"), torch.Generator(),
                           board_size=N, num_steps=1, num_simulations=2, search="beam")


def test_dirichlet_alpha_defaults_to_0_3(monkeypatch):
    seen = []
    real = tmcts.search_batch

    def spy(*args, **kw):
        seen.append((kw["dirichlet_alpha"], kw["dirichlet_frac"]))
        return real(*args, **kw)

    monkeypatch.setattr(tmcts, "search_batch", spy)
    kw = dict(board_size=N, num_steps=1, num_simulations=2)
    tsp.selfplay_chunk(small_net(), tbit.bit_reset(N, 2, "cpu"), torch.Generator(), **kw)
    tsp.selfplay_chunk(small_net(), tbit.bit_reset(N, 2, "cpu"), torch.Generator(),
                       dirichlet_alpha=0.02, dirichlet_frac=0.5, **kw)
    assert seen == [(0.3, 0.25), (0.02, 0.5)]


# --- ground truth: a position whose winner is known -------------------------
# The win line of the reference (board 8; red wins with its 9th move).  After
# its first 7 moves (red's 42 the last) blue is to move and every blue move
# leaves red an immediate win at 32 or 48 (checked by the engine below);
# after 8 moves red is to move and wins at 32 or 48.
WIN_LINE = [21, 38, 15, 11, 27, 17, 42, 45, 48]
BOARD8 = 8
# a static prior: red's 42 first, then its winning cells; values 0, so every
# nonzero value in a search is an engine-scored terminal
PRIOR = {42: 8.0, 32: 4.0, 48: 4.0}


def prior_net(params, obs):
    logits = torch.zeros((obs.shape[0], BOARD8 * BOARD8))
    for cell, logit in PRIOR.items():
        logits[:, cell] = logit
    return logits, torch.zeros(obs.shape[0])


def jax_prior_net(params, obs):
    row = np.zeros(BOARD8 * BOARD8, np.float32)
    for cell, logit in PRIOR.items():
        row[cell] = logit
    return (jnp.broadcast_to(jnp.asarray(row), (obs.shape[0], row.size)),
            jnp.zeros(obs.shape[0], jnp.float32))


def jax_roots(starts):
    leaves = tbit.bitstate_to_numpy(cases.scenario_roots(starts, BOARD8, "cpu"))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jbit.bit_reset(BOARD8, 1)), [jnp.asarray(x) for x in leaves])


def red_wins_after_every_blue_move(moves) -> bool:
    s = tstate.reset(BOARD8, "cpu")
    for a in moves:
        s = tstep.step(s, BOARD8, a)
    assert int(s.current_player) == 1
    for b in torch.nonzero(tstate.legal_mask_flat(s, 1, BOARD8)).flatten().tolist():
        t = tstep.step(s, BOARD8, b)
        if int(t.result) != geo.RESULT_OPEN:
            return False
        reds = torch.nonzero(tstate.legal_mask_flat(t, 0, BOARD8)).flatten().tolist()
        if not any(int(tstep.step(t, BOARD8, r).result) == geo.RESULT_RED_WIN for r in reds):
            return False
    return True


def test_ground_truth_signs():
    """Red wins the line, so ``root_q`` is positive with red to move and
    negative with blue to move, and a chunk that ends with the game open,
    red's frame before blue's, gives red's frame a positive bootstrap
    target and blue's a negative one, on both sides, whatever the two
    perspective conversions inside the chunk are.

    Env 0 starts before red's 42: red plays it, then blue searches the lost
    position (the chunk's last root, open at the end).  Env 1 starts at
    that lost position: blue moves, then red searches a won position."""
    assert red_wins_after_every_blue_move(WIN_LINE[:7])
    sims = 64
    for moves, sign in ((WIN_LINE[:8], 1.0), (WIN_LINE[:7], -1.0)):
        _, q = tmcts.search_batch(None, cases.scenario_roots([moves], BOARD8, "cpu"),
                                  torch.Generator().manual_seed(0),
                                  evaluator=tmcts.net_evaluator(prior_net, BOARD8),
                                  board_size=BOARD8, num_simulations=sims, dirichlet_frac=0.0)
        assert float(q[0]) * sign > 0, (len(moves), float(q[0]))

    starts = [WIN_LINE[:6], WIN_LINE[:7]]
    chunk = dict(board_size=BOARD8, num_steps=2, num_simulations=sims, temp_moves=0,
                 dirichlet_frac=0.0, value_bootstrap=1.0, debug_trace=True)
    final, sample, aux = tsp.selfplay_chunk(
        None, cases.scenario_roots(starts, BOARD8, "cpu"), torch.Generator(),
        net_apply=prior_net, **chunk)
    assert int(aux["actions"][0, 0]) == 42
    assert aux["player"].tolist() == [[0, 1], [1, 0]]
    q_last = aux["root_q_last"]
    assert float(q_last[0]) < 0 < float(q_last[1]), q_last  # blue lost, red won
    assert int(final.result[0]) == geo.RESULT_OPEN
    v = sample.value[:, 0]
    assert sample.weight[:, 0].tolist() == [1.0, 1.0]
    assert float(v[0]) > 0 > float(v[1]), v
    # env 1's red played its win: exact targets, blue's frame lost
    assert sample.weight[:, 1].tolist() == [1.0, 1.0]
    assert sample.value[:, 1].tolist() == [-1.0, 1.0]

    _, s_jax, aux_jax = jsp.selfplay_chunk(
        None, jax_roots(starts), jax.random.PRNGKey(0), net_apply=jax_prior_net, **chunk)
    np.testing.assert_array_equal(np.asarray(aux_jax["root_q_last"]), q_last.numpy())
    np.testing.assert_array_equal(np.asarray(s_jax.value), sample.value.numpy())
    np.testing.assert_array_equal(np.asarray(s_jax.weight), sample.weight.numpy())


if __name__ == "__main__":
    FIXTURE.write_text(json.dumps(jax_record(), indent=1) + "\n")
    ARMS_FIXTURE.write_text(json.dumps(jax_arms_record(), indent=1) + "\n")
    print(FIXTURE.read_text()[:2000])
