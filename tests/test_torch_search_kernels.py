"""The search's kernels (S1a ``bit_step``, S1b ``select_walk``, S1c
``backup_walk``): their plain versions against the JAX search's own
functions, bit for bit, and models of the kernels' designs against the
plain versions, on the CPU.

Inputs are the calls a port search makes: ``search_batch`` runs on numpy-
seeded roots (``bit_random_rollout`` from reset, part-way into games, so
that terminal children and revisits occur) with the table or uniform
evaluator of ``tests/test_mcts_exact.py``, and every call of the three
wrappers is recorded with a copy of its inputs.  Synthetic calls on the
recorded trees add what a search reaches rarely: revisits (an action whose
child exists), Gumbel-style forced root entries, values of +-0.0.

  * ``bit_step_reference`` (slot gather, step, legal mask, slot write)
    against JAX ``_gather_node_state`` + ``step_bits`` +
    ``bit_legal_mask_flat`` + ``_set_node_state``
    (``twixt_for_open_spiel_tpu/models/mcts.py:191, 228``) in both of
    JAX's gather forms;
  * ``select_walk_reference`` against JAX ``_best_edge`` iterated in the
    ``while_loop`` of ``mcts.py:352-368``, with its iteration count;
  * ``backup_walk_reference`` against the ``while_loop`` of
    ``mcts.py:496-511`` (the sign of a zero sum included), with its count.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each to its
plain version there); the models here pin, per env, the kernels'
algorithms: the warp's strided lanes and its shuffle argmax (the first
maximum, NaN above all), the backup's trailing +0.0, the slot indexing.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_port_cases as cases
from twixt_for_open_spiel_tpu.models import mcts as jmcts
from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu_torch.models import mcts as tmcts
from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.ops import bit_step as tstep
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import search_walk as twalk

torch.set_num_threads(1)

C_PUCT = 1.4
WARP = 32
INT_MAX = 2**31 - 1
# (board, batch, simulations, evaluator, backup, random plies to the roots, seed)
CASES = {
    "n5-table-walk": (5, 24, 12, "table", "walk", 14, 1),
    "n5-uniform-amask": (5, 16, 16, "uniform", "amask", 10, 2),
    "n8-table-walk": (8, 12, 10, "table", "walk", 34, 3),
}


def clone_tree(tree):
    return tmcts.Tree(*(x.clone() for x in tree))


@functools.cache
def recorded(name: str) -> dict:
    """Every select_walk, bit_step and backup_walk call of one port search
    (inputs copied before the call), the search's stats and roots."""
    n, b, sims, kind, backup, plies, seed = CASES[name]
    roots = tbit.bit_random_rollout(seed, n, plies, tbit.bit_reset(n, b, "cpu"))[0]
    calls = {"select": [], "step": [], "backup": []}
    real = {"select": tmcts.select_walk, "step": tmcts.bit_step, "backup": tmcts.backup_walk}

    def select(tree, action, kid, kid_term, c_puct, iters=None):
        calls["select"].append((clone_tree(tree), action.clone(), kid.clone(), kid_term.clone()))
        return real["select"](tree, action, kid, kid_term, c_puct, iters)

    def step(src, src_slot, action, dst, dst_slot, board_size, **kw):
        calls["step"].append((tuple(x.clone() for x in src), src_slot.clone(), action.clone(),
                              dst_slot))
        return real["step"](src, src_slot, action, dst, dst_slot, board_size, **kw)

    def back(tree, node, value, iters=None):
        calls["backup"].append((clone_tree(tree), node.clone(), value.clone()))
        return real["backup"](tree, node, value, iters)

    saved = (tmcts.select_walk, tmcts.bit_step, tmcts.backup_walk)
    tmcts.select_walk, tmcts.bit_step, tmcts.backup_walk = select, step, back
    try:
        _, _, stats = tmcts.search_batch(
            None, roots, torch.Generator().manual_seed(seed),
            evaluator=cases.EVALUATORS[kind](n * n), board_size=n, num_simulations=sims,
            dirichlet_frac=0.0, backup=backup, return_stats=True)
    finally:
        tmcts.select_walk, tmcts.bit_step, tmcts.backup_walk = saved
    return {**calls, "stats": stats, "n": n}


# --- the JAX side -------------------------------------------------------------


def jax_tree(tree) -> jmcts.Tree:
    def conv(name, x):
        a = x.numpy()
        if name in ("parent", "pa", "root_child"):
            a = a.astype(np.int32)
        elif name == "planes":
            a = a.astype(np.uint32)
        return jnp.asarray(a)

    return jmcts.Tree(**{k: conv(k, v) for k, v in tree._asdict().items()})


@functools.partial(jax.jit, static_argnums=(5, 6))
def jax_expand(planes, compid, scalars, node_action, dst_slot, n, dense):
    """JAX's expansion of one simulation (mcts.py:371-383, 438): the parent
    slot gathered (the dense form or the gather, as ``dense`` says), stepped,
    the child's legal mask, the slot written."""
    node, action = node_action
    jt = jmcts.Tree(*([None] * 12), planes=planes, compid=compid, scalars=scalars)
    saved = jmcts._DENSE_GATHER_MAX_NODES
    jmcts._DENSE_GATHER_MAX_NODES = 10**6 if dense else 0  # read while tracing
    try:
        parent = jmcts._gather_node_state(jt, node)
    finally:
        jmcts._DENSE_GATHER_MAX_NODES = saved
    child = jbit.step_bits(parent, n, action)
    player = jnp.clip(child.current_player, 0, 1)
    legal = jnp.moveaxis(jbit.bit_legal_mask_flat(child, player, n), 0, -1)
    jt = jmcts._set_node_state(jt, dst_slot, child)
    return jt.planes, jt.compid, jt.scalars, legal


@functools.partial(jax.jit, static_argnums=4)
def jax_select(jt, a0, k0, kt0, c_puct):
    """JAX's selection walk (mcts.py:352-368)."""
    def sel_cond(carry):
        return jnp.any(carry[4])

    def sel_body(carry):
        node, action, kid, kid_term, can, ct = carry
        descend = can & (kid >= 0) & ~kid_term
        node = jnp.where(descend, jnp.maximum(kid, 0), node)
        a, k, kt = jmcts._best_edge(jt, node, c_puct)
        action = jnp.where(descend, a, action)
        kid = jnp.where(descend, k, kid)
        kid_term = jnp.where(descend, kt, kid_term)
        return node, action, kid, kid_term, descend, ct + 1

    node0 = jnp.zeros(a0.shape, jnp.int32)
    node, action, kid, _, _, ct = jax.lax.while_loop(
        sel_cond, sel_body, (node0, a0, k0, kt0, jnp.ones(a0.shape, bool), 0))
    return node, action, kid, ct


@jax.jit
def jax_backup(visit, vsum, parent, node_id, value):
    """JAX's walk backup (mcts.py:496-511)."""
    env = jnp.arange(node_id.shape[0])

    def bk_cond(carry):
        return jnp.any(carry[2] >= 0)

    def bk_body(carry):
        visit, vsum, node, v, ct = carry
        live = node >= 0
        idx = jnp.maximum(node, 0)
        visit = visit.at[env, idx].add(jnp.where(live, 1, 0).astype(jnp.int32))
        vsum = vsum.at[env, idx].add(jnp.where(live, v, 0.0))
        node = jnp.where(live, jmcts._cell(parent, idx), jmcts.NO_NODE)
        return visit, vsum, node, -v, ct + 1

    visit, vsum, _, _, ct = jax.lax.while_loop(bk_cond, bk_body,
                                               (visit, vsum, node_id, value, 0))
    return visit, vsum, ct


def i32(x):
    return jnp.asarray(np.asarray(x).astype(np.int32))


def same_bits(port: torch.Tensor, want) -> bool:
    """Equal element for element, float32 by bit pattern (the sign of zero
    included)."""
    a, w = port.numpy(), np.asarray(want)
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), w.astype(np.float32).view(np.int32))
    return np.array_equal(a.astype(np.int64), w.astype(np.int64))


# --- synthetic calls on the recorded trees ----------------------------------


def linked_slots(tree, rng, *, nonterminal: bool) -> torch.Tensor:
    """One random linked slot an env (slot 0 where none other fits)."""
    ok = tree.linked & (~tree.terminal if nonterminal else True)
    out = []
    for row in ok.numpy():
        choice = np.flatnonzero(row)
        out.append(int(rng.choice(choice)) if len(choice) else 0)
    return torch.tensor(out, dtype=torch.int64)


def synthetic_steps(tree, n, rng):
    """(src slot, action) an env: a random non-terminal linked node, and for
    every other env an action whose child already exists (a revisit's step)
    where the node has one, else a random action."""
    src = linked_slots(tree, rng, nonterminal=True)
    actions, revisits = [], 0
    for b, s in enumerate(src.tolist()):
        kids = np.flatnonzero((tree.parent[b] == s).numpy() & tree.linked[b].numpy())
        if b % 2 == 0 and len(kids):
            actions.append(int(tree.pa[b, int(rng.choice(kids))]))
            revisits += 1
        else:
            actions.append(int(rng.integers(n * n)))
    return src, torch.tensor(actions, dtype=torch.int64), revisits


def forced_root_entries(tree, rng):
    """Gumbel's root entry (mcts.py:672-676) for a random legal root action."""
    b = tree.visit.shape[0]
    env = torch.arange(b)
    legal = (tree.uprior[:, 0] >= 0) | (tree.root_child >= 0)
    a0 = torch.tensor([int(rng.choice(np.flatnonzero(row))) for row in legal.numpy()])
    k0 = tree.root_child[env, a0]
    kt0 = (k0 >= 0) & tree.terminal[env, k0.clamp_min(0)]
    return a0, k0, kt0


# --- S1a: bit_step ------------------------------------------------------------


def step_calls(name, seed=0):
    """The search's expansions, then synthetic ones on the trees of its last
    three simulations (a simulation's select call sees the tree its step
    reads)."""
    rec = recorded(name)
    n = rec["n"]
    calls = list(rec["step"])
    rng = np.random.default_rng(seed)
    revisits = 0
    for (tree, *_), (src, _, _, dst_slot) in list(zip(rec["select"], rec["step"]))[-3:]:
        slot, action, r = synthetic_steps(tree, n, rng)
        revisits += r
        calls.append((src, slot, action, dst_slot))
    return n, calls, revisits


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "gather"])
@pytest.mark.parametrize("name", list(CASES))
def test_bit_step_reference_matches_jax(name, dense):
    n, calls, revisits = step_calls(name)
    assert revisits > 0
    for src, slot, action, dst_slot in calls:
        dst = tuple(x.clone() for x in src)
        legal = tstep.bit_step_reference(src, slot, action, dst, dst_slot, n)
        planes, compid, scalars, want_legal = jax_expand(
            jnp.asarray(src[0].numpy().astype(np.uint32)), jnp.asarray(src[1].numpy()),
            jnp.asarray(src[2].numpy()), (i32(slot), i32(action)), jnp.int32(dst_slot), n, dense)
        for got, want in zip(dst, (planes, compid, scalars)):
            assert same_bits(got, want)
        assert same_bits(legal.contiguous(), want_legal)


def test_bit_step_wrapper_on_cpu_is_the_plain_version():
    rec = recorded("n5-table-walk")
    before = tstep.bit_step.launches
    for src, slot, action, dst_slot in rec["step"][:4]:
        a, b = tuple(x.clone() for x in src), tuple(x.clone() for x in src)
        got = tstep.bit_step(a, slot, action, a, dst_slot, 5)
        want = tstep.bit_step_reference(src, slot, action, b, dst_slot, 5)
        assert torch.equal(got, want)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tstep.bit_step.launches == before == 0


def test_step_bits_dispatch_on_cpu():
    n = 8
    bs = tbit.bit_random_rollout(5, n, 20, tbit.bit_reset(n, 16, "cpu"))[0]
    action = torch.arange(16, dtype=torch.int32) * 3 % (n * n)
    got = tbit.step_bits(bs, n, action)
    want = tbit.step_bits_reference(bs, n, action)
    for a, b in zip(tbit.bitstate_leaves(got), tbit.bitstate_leaves(want)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tstep.step_state(bs, n, action)


@pytest.mark.parametrize("n, shape", [(5, (16,)), (5, (2, 3)), (8, (12,)), (8, (3, 4)),
                                      (12, (7,)), (16, (5,)), (20, (2, 2)), (24, (6,))])
def test_step_state_slot_packing(n, shape):
    """``step_state``'s packing (the card's ``step_bits``), run through
    ``bit_step``'s plain version: the env batch as slot 0 of new buffers
    (``one_slot``) and back (``slot_as``) is the identity, and a step from
    slot 0 into fresh buffers equals ``step_bits_reference``."""
    b = int(np.prod(shape))
    flat = tbit.bit_random_rollout(n, n, 2 * n, tbit.bit_reset(n, b, "cpu"))[0]
    action = tbit.sample_bits(flat, n, tbit.rollout_noise(n, 0, torch.arange(b)))
    want = tbit.bitstate_leaves(tbit.step_bits_reference(flat, n, action))
    bs = tbit.bitstate_from_leaves(x.reshape(x.shape[:-1] + shape)
                                   for x in tbit.bitstate_leaves(flat))
    src = tstep.one_slot(bs)
    p = tbit.bitstate_leaves(bs)[0].shape[0]
    assert [tuple(x.shape) for x in src] == [(1, 16, p, b), (1, n, n, b), (1, 5, b)]
    for got, leaf in zip(tbit.bitstate_leaves(tstep.slot_as(src, shape)),
                         tbit.bitstate_leaves(bs)):
        assert torch.equal(got, leaf)
    dst = tuple(torch.empty_like(x) for x in src)
    assert tstep.bit_step(src, None, action, dst, 0, n, legal=False) is None
    for got, leaf in zip(tbit.bitstate_leaves(tstep.slot_as(dst, shape)), want):
        assert tuple(got.shape) == tuple(leaf.shape[:-1]) + shape
        assert torch.equal(got.reshape(leaf.shape), leaf)


FINISH_CASES = {
    # lengths, root sums before, iters before -> root sums after, iters after
    "equal-lengths": ([2, 2], [-0.0, -0.0], 0, [-0.0, -0.0], 2),
    "shorter-walks": ([1, 3, 3], [-0.0, -0.0, 1.5], 0, [0.0, -0.0, 1.5], 3),
    "nonzero-roots": ([1, 2, 4], [-2.5, 0.25, -0.0], 1, [-2.5, 0.25, -0.0], 4),
    "count-kept": ([1, 2], [-0.0, 3.0], 5, [0.0, 3.0], 5),
}


@pytest.mark.parametrize("name", list(FINISH_CASES))
def test_finish_backup(name):
    """The backup wrapper's fix-up after the kernel's walks: +0.0 at slot 0
    of the envs whose walk is shorter than the longest (the plain loop's
    trailing adds), slot 0 of the others and every other slot untouched,
    the count raised to the longest walk."""
    lengths, roots, iters0, want_roots, want_iters = FINISH_CASES[name]
    b = len(lengths)
    value_sum = torch.full((b, 3), -0.0)
    value_sum[:, 0] = torch.tensor(roots)
    tree = tmcts.Tree(*([None] * len(tmcts.Tree._fields)))._replace(value_sum=value_sum)
    iters = torch.tensor(iters0, dtype=torch.int32)
    twalk._finish_backup(tree, torch.tensor(lengths, dtype=torch.int32), iters)
    assert same_bits(value_sum[:, 0], np.array(want_roots, np.float32))
    assert same_bits(value_sum[:, 1:], np.full((b, 2), -0.0, np.float32))
    assert int(iters) == want_iters


def test_bit_step_slot_layout_model():
    """The kernel's flat indexing: word j of env b's slot s at
    ``(s*16P + j)*B + b`` (compid at ``(s*n*n + c)*B + b``), the stepped
    state stored at slot ``dst`` the same way, and the legal mask's bit of
    action a at row a // n + PAD, bit a % n + PAD of the mover's plane."""
    n, calls, _ = step_calls("n8-table-walk")
    src, slot, action, dst_slot = calls[-1]
    planes, compid, scalars = (x.numpy() for x in src)
    s_in, _, p, b = planes.shape
    words, cells = 16 * p, n * n
    flat_p, flat_c = planes.reshape(-1), compid.reshape(-1)
    env = np.arange(b)
    loaded = np.stack([flat_p[(slot.numpy() * words + j) * b + env] for j in range(words)])
    parent = tstep.gather_slots(src, slot)
    assert np.array_equal(loaded.reshape(16, p, b), tstep.stack_planes(parent).numpy())
    loaded_c = np.stack([flat_c[(slot.numpy() * cells + c) * b + env] for c in range(cells)])
    assert np.array_equal(loaded_c.reshape(n, n, b), parent.compid.numpy())

    dst = tuple(x.clone() for x in src)
    legal = tstep.bit_step_reference(src, slot, action, dst, dst_slot, n)
    out = dst[0].numpy().reshape(-1)
    stored = np.stack([out[(dst_slot * words + j) * b + env] for j in range(words)])
    child = tstep.slot_state(dst[0][dst_slot], dst[1][dst_slot], dst[2][dst_slot])
    assert np.array_equal(stored.reshape(16, p, b), tstep.stack_planes(child).numpy())
    mover = 10 + child.current_player.clamp(0, 1).numpy()
    pl = dst[0][dst_slot].numpy()
    model = np.zeros((b, cells), bool)
    for e in range(b):
        for a in range(cells):
            model[e, a] = (pl[mover[e], a // n + 3, e] >> (a % n + 3)) & 1
    assert np.array_equal(model, legal.numpy())


# --- S1b: select_walk ---------------------------------------------------------


def select_calls(name, seed=1):
    rec = recorded(name)
    calls = list(rec["select"])
    rng = np.random.default_rng(seed)
    for tree, *_ in rec["select"][-4:]:
        calls.append((tree, *forced_root_entries(tree, rng)))
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_select_walk_reference_matches_jax(name):
    descended = 0
    for tree, a0, k0, kt0 in select_calls(name):
        iters = torch.zeros((), dtype=torch.int32)
        node, action, kid = twalk.select_walk_reference(tree, a0, k0, kt0, C_PUCT, iters)
        w_node, w_action, w_kid, w_ct = jax_select(jax_tree(tree), i32(a0), i32(k0),
                                                   jnp.asarray(kt0.numpy()), C_PUCT)
        assert same_bits(node, w_node) and same_bits(action, w_action)
        assert same_bits(kid, w_kid)
        assert int(iters) == int(w_ct)
        descended += int(iters) > 1
    assert descended > 0


def test_search_counts_walks_on_the_device_counter():
    """The stats of a search equal the plain walks' own counts: 1 + the
    deepest descent a simulation, and the longest backup."""
    rec = recorded("n5-table-walk")
    sel = bk = 0
    for tree, a0, k0, kt0 in rec["select"]:
        iters = torch.zeros((), dtype=torch.int32)
        twalk.select_walk_reference(clone_tree(tree), a0, k0, kt0, C_PUCT, iters)
        sel += int(iters)
    for tree, node, value in rec["backup"]:
        iters = torch.zeros((), dtype=torch.int32)
        twalk.backup_walk_reference(clone_tree(tree), node, value, iters)
        bk += int(iters)
    assert rec["stats"] == {"sel_iters": sel, "backup_iters": bk}
    assert recorded("n5-uniform-amask")["stats"]["backup_iters"] == 0


def better(a, ia, b, ib) -> bool:
    """The kernel's order: NaN the largest value, then the lower index."""
    an, bn = np.isnan(a), np.isnan(b)
    if an or bn:
        return bool(an and (not bn or ia < ib))
    return bool(a > b or (a == b and ia < ib))


def warp_argmax(scores) -> tuple:
    """The kernel's pass: lane l keeps the best of elements l, l+32, ...;
    a butterfly of shuffles (xor 16, 8, 4, 2, 1) leaves every lane the
    best.  Returns (value, index)."""
    lanes = [(np.float32(-np.inf), INT_MAX)] * WARP
    for k, sc in enumerate(scores):
        if better(sc, k, *lanes[k % WARP]):
            lanes[k % WARP] = (sc, k)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[x ^ o] if better(*lanes[x ^ o], *lanes[x]) else lanes[x]
                 for x in range(WARP)]
    assert len(set(i for _, i in lanes)) == 1
    return lanes[0]


def model_select_walk(tree, a0, k0, kt0, c_puct):
    """csrc/search.cu's select_walk_kernel, one env at a time, in float32
    with the kernel's operation order."""
    c = np.float32(c_puct)
    t = {k: v.numpy() for k, v in tree._asdict().items()}
    out, longest = [], 0
    for b in range(a0.shape[0]):
        node, action, kid, kt, descents = 0, int(a0[b]), int(k0[b]), bool(kt0[b]), 0
        while kid >= 0 and not kt and descents < len(t["visit"][b]):
            node = kid
            sq = np.sqrt(np.float32(max(int(t["visit"][b, node]), 1)))
            up = t["uprior"][b, node]
            bu, bu_a = warp_argmax([c * p * sq if p >= 0 else np.float32(-np.inf) for p in up])
            scores = []
            for s in range(len(t["visit"][b])):
                if t["linked"][b, s] and t["parent"][b, s] == node:
                    v = int(t["visit"][b, s])
                    q = t["tval"][b, s] if t["terminal"][b, s] else \
                        -t["value_sum"][b, s] / np.float32(max(v, 1))
                    u = c * t["e_prior"][b, s] * sq / (np.float32(1.0) + np.float32(v))
                    scores.append(np.float32(q + u))
                else:
                    scores.append(np.float32(-np.inf))
            bc, c_star = warp_argmax(scores)
            bc_a = int(t["pa"][b, c_star])
            wins = bc > bu or (bc == bu and bc_a < bu_a)
            action = bc_a if wins else bu_a
            kid = c_star if wins else -1
            kt = wins and bool(t["terminal"][b, c_star])
            descents += 1
        out.append((node, action, kid))
        longest = max(longest, descents + 1)
    node, action, kid = (torch.tensor(x) for x in zip(*out))
    return node, action, kid, longest


@pytest.mark.parametrize("name", list(CASES))
def test_select_walk_kernel_model(name):
    for tree, a0, k0, kt0 in select_calls(name)[::3]:
        iters = torch.zeros((), dtype=torch.int32)
        want = twalk.select_walk_reference(tree, a0, k0, kt0, C_PUCT, iters)
        *got, longest = model_select_walk(tree, a0, k0, kt0, C_PUCT)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert longest == int(iters)


def test_select_walk_kernel_model_ties_and_nan():
    """Equal scores (within a lane's two actions too), an all -inf prior
    row and NaN values: the model's shuffle argmax makes the reference's
    (torch's) choices."""
    tree = clone_tree(recorded("n8-table-walk")["select"][-1][0])  # two actions a lane
    b = tree.visit.shape[0]
    env = torch.arange(b)
    # root entries into an expanded, non-terminal child wherever one exists
    ok = (tree.root_child >= 0) & ~tree.terminal[env[:, None], tree.root_child.clamp_min(0)]
    a0 = ok.long().argmax(-1)
    k0 = torch.where(ok.any(-1), tree.root_child[env, a0], -1)
    kt0 = torch.zeros(b, dtype=torch.bool)
    tree.uprior.copy_(torch.where(tree.uprior >= 0, 0.25, -1.0))  # equal unexpanded edges
    tree.value_sum[0::2] = 0.0  # and equal children
    tree.e_prior[0::2] = 0.125
    tree.visit[0::2] = torch.where(tree.linked[0::2], 3, tree.visit[0::2])
    tree.uprior[1].fill_(-1.0)  # env 1: no unexpanded edge left anywhere
    slots = np.random.default_rng(7).integers(1, tree.visit.shape[1], size=4)
    tree.value_sum[3, slots] = float("nan")  # env 3: NaN child values
    iters = torch.zeros((), dtype=torch.int32)
    want = twalk.select_walk_reference(tree, a0, k0, kt0, C_PUCT, iters)
    *got, longest = model_select_walk(tree, a0, k0, kt0, C_PUCT)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert longest == int(iters) > 1


# --- S1c: backup_walk ---------------------------------------------------------


def backup_calls(name, seed=2):
    rec = recorded(name)
    calls = list(rec["backup"])
    rng = np.random.default_rng(seed)
    for tree, *_ in rec["select"][-3:]:
        b = tree.visit.shape[0]
        node = linked_slots(tree, rng, nonterminal=False)
        value = rng.uniform(-1, 1, b).astype(np.float32)
        value[::3] = 0.0
        value[1::3] = -0.0
        tree = clone_tree(tree)
        tree.value_sum[:, 0] = torch.where(torch.arange(b) % 2 == 0, -0.0, tree.value_sum[:, 0])
        calls.append((tree, node, torch.from_numpy(value)))
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_backup_walk_reference_matches_jax(name):
    for tree, node, value in backup_calls(name):
        want = jax_backup(jnp.asarray(tree.visit.numpy()), jnp.asarray(tree.value_sum.numpy()),
                          i32(tree.parent), i32(node), jnp.asarray(value.numpy()))
        tree = clone_tree(tree)
        iters = torch.zeros((), dtype=torch.int32)
        twalk.backup_walk_reference(tree, node, value, iters)
        assert same_bits(tree.visit, want[0])
        assert same_bits(tree.value_sum, want[1])
        assert int(iters) == int(want[2])


def model_backup_walk(visit, vsum, parent, node_id, value) -> np.ndarray:
    """csrc/search.cu's backup_walk_kernel: a thread an env walks its chain
    and writes its length."""
    lengths = []
    for b in range(node_id.shape[0]):
        node, v, length = int(node_id[b]), np.float32(value[b]), 0
        while node >= 0 and length < visit.shape[1]:
            visit[b, node] += 1
            vsum[b, node] = np.float32(vsum[b, node] + v)
            node, v, length = int(parent[b, node]), -v, length + 1
        lengths.append(length)
    return np.array(lengths, np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_backup_walk_kernel_model(name):
    """The kernel's walks, then the wrapper's own fix-up (``_finish_backup``,
    the trailing +0.0 and the count), equal the plain loop."""
    zeros = 0
    for tree, node, value in backup_calls(name):
        visit, vsum = tree.visit.numpy().copy(), tree.value_sum.numpy().copy()
        lengths = model_backup_walk(visit, vsum, tree.parent.numpy(), node.numpy(),
                                    value.numpy())
        got = tree._replace(visit=torch.from_numpy(visit), value_sum=torch.from_numpy(vsum))
        got_iters = torch.zeros((), dtype=torch.int32)
        twalk._finish_backup(got, torch.from_numpy(lengths), got_iters)
        tree = clone_tree(tree)
        iters = torch.zeros((), dtype=torch.int32)
        twalk.backup_walk_reference(tree, node, value, iters)
        assert np.array_equal(visit, tree.visit.numpy())
        assert same_bits(got.value_sum, tree.value_sum.numpy())
        assert int(got_iters) == int(iters)
        zeros += int((tree.value_sum[:, 0] == 0).sum())
    assert zeros > 0  # zero sums at the roots, whose sign the trailing +0.0 decides


# --- the wrappers: dispatch, checks, the build ------------------------------


def test_no_fallback_off_cpu():
    tree, a0, k0, kt0 = recorded("n5-table-walk")["select"][0]
    src, slot, action, dst_slot = recorded("n5-table-walk")["step"][0]
    meta = tmcts.Tree(*(x.to("meta") for x in tree))
    with pytest.raises(ValueError, match="no kernel"):
        twalk.select_walk(meta, a0.to("meta"), k0.to("meta"), kt0.to("meta"), C_PUCT)
    with pytest.raises(ValueError, match="no kernel"):
        twalk.backup_walk(meta, k0.to("meta"), torch.zeros(k0.shape, device="meta"))
    meta_bufs = tuple(x.to("meta") for x in src)
    with pytest.raises(ValueError, match="no kernel"):
        tstep.bit_step(meta_bufs, slot.to("meta"), action.to("meta"), meta_bufs, dst_slot, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tstep._launch(src, slot, action, src, dst_slot, 5, True)
    assert tstep.bit_step.launches == twalk.select_walk.launches == 0
    assert twalk.backup_walk.launches == 0


def test_wrapper_checks():
    tree, a0, k0, kt0 = recorded("n5-table-walk")["select"][0]
    src, slot, action, dst_slot = recorded("n5-table-walk")["step"][0]
    b, nodes = tree.visit.shape
    twalk._check_tree(tree, tree.visit.device, ("uprior", *twalk._SLOT_FIELDS))
    with pytest.raises(ValueError, match="tree.parent"):
        twalk._check_tree(tree._replace(parent=tree.parent.int()), tree.visit.device,
                          ("parent",))
    with pytest.raises(ValueError, match="contiguous"):
        twalk._check_tree(tree._replace(visit=tree.visit.t().contiguous().t()),
                          tree.visit.device, ("visit",))
    with pytest.raises(ValueError, match="kid"):
        twalk._env_vector(k0.int(), b, torch.int64, k0.device, "kid")
    with pytest.raises(ValueError, match="iters"):
        twalk._iters_ptr(torch.zeros(2, dtype=torch.int32), k0.device)
    tstep._check_bufs(src, 5, b, src[0].device, "source")
    with pytest.raises(ValueError, match="source compid"):
        tstep._check_bufs((src[0], src[1].int(), src[2]), 5, b, src[0].device, "source")
    with pytest.raises(ValueError, match="source planes"):
        tstep._check_bufs(src, 6, b, src[0].device, "source")
    with pytest.raises(ValueError, match="outside"):
        tstep._check_bufs(src, 25, b, src[0].device, "source")


def test_kernel_sources_and_flags():
    """Both sources build with the same flags, none of which relaxes float
    arithmetic; the walk's scores use the round-to-nearest intrinsics (no
    contraction), and each library exports its error strings."""
    flags = " ".join(_cuda.NVCC_FLAGS)
    for relax in ("fast_math", "ftz=true", "prec-div=false", "prec-sqrt=false"):
        assert relax not in flags
    search = (_cuda.CSRC / "search.cu").read_text()
    for op in ("__fmul_rn", "__fdiv_rn", "__fadd_rn", "__fsqrt_rn"):
        assert op in search
    for name in ("bit_step", "search", "fused_bit_rollout"):
        text = (_cuda.CSRC / f"{name}.cu").read_text()
        assert "twixt_cuda_error_string" in text
    # K1 and S1a run one step: the header's, included by both
    for name in ("bit_step", "fused_bit_rollout"):
        text = (_cuda.CSRC / f"{name}.cu").read_text()
        assert '#include "bit_step.cuh"' in text
        assert not re.search(r"__device__ int step_bits\(", text)
