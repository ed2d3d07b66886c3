"""The search's kernels (S1a ``bit_step``, S1b ``select_walk``, S1c
``backup_walk``): their plain versions against the JAX search's own
functions, bit for bit, and models of the kernels' designs against the
plain versions, on the CPU.

Inputs are the calls a port search makes: ``search_batch`` runs on numpy-
seeded roots (``bit_random_rollout`` from reset, part-way into games, so
that terminal children and revisits occur) with the table or uniform
evaluator of ``tests/test_mcts_exact.py``, and every call of the three
wrappers is recorded with a copy of its inputs (the selection from the
root: the PUCT search's entry is the walk's own).  Synthetic calls on the
recorded trees add what a search reaches rarely: revisits (an action whose
child exists), Gumbel-style forced root entries, values of +-0.0.

  * ``bit_step_reference`` (slot gather, step, legal mask, slot write)
    against JAX ``_gather_node_state`` + ``step_bits`` +
    ``bit_legal_mask_flat`` + ``_set_node_state``
    (``twixt_for_open_spiel_tpu/models/mcts.py:191, 228``) in both of
    JAX's gather forms;
  * ``select_walk_reference``, from a forced entry or from the root,
    against JAX ``_best_edge`` (at node 0 for the root entry, ``:672``)
    iterated in the ``while_loop`` of ``mcts.py:352-368``, with its
    iteration count;
  * ``backup_walk_reference`` against the ``while_loop`` of
    ``mcts.py:496-511`` (the sign of a zero sum included), with its count.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each to its
plain version there); the models here pin, per env, the kernels'
algorithms: S1b's staged slot rows, its child-side pass over them and the
prior row's pass, each with the warp's strided lanes and its shuffle
argmax (the first maximum, NaN above all), and the from-root entry; S1c's
path through the staged parent row, its lane-parallel signed adds, and
the last block's trailing +0.0 and count; the slot indexing.
"""

import ctypes
import functools
import re
import types

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
from twixt_for_open_spiel_tpu_torch.ops import geometry as tgeo
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
    "n8-table-amask": (8, 12, 24, "table", "amask", 30, 4),
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
        entry = tuple(None if x is None else x.clone() for x in (action, kid, kid_term))
        calls["select"].append((clone_tree(tree), *entry))
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
    """JAX's expansion of one simulation (mcts.py:371-391, 438): the parent
    slot gathered (the dense form or the gather, as ``dense`` says), stepped,
    the child's terminal flag and value (mcts.py:380-388), the child's legal
    mask, the slot written."""
    node, action = node_action
    jt = jmcts.Tree(*([None] * 12), planes=planes, compid=compid, scalars=scalars)
    saved = jmcts._DENSE_GATHER_MAX_NODES
    jmcts._DENSE_GATHER_MAX_NODES = 10**6 if dense else 0  # read while tracing
    try:
        parent = jmcts._gather_node_state(jt, node)
    finally:
        jmcts._DENSE_GATHER_MAX_NODES = saved
    child = jbit.step_bits(parent, n, action)
    child_terminal = child.result != jmcts.geo.RESULT_OPEN
    parent_player = jnp.clip(parent.current_player, 0, 1)
    res = child.result
    term_val = jnp.where(
        res == jmcts.geo.RESULT_RED_WIN + parent_player,
        1.0,
        jnp.where(res == jmcts.geo.RESULT_DRAW, 0.0, -1.0),
    )
    term_val = jnp.where(child_terminal, term_val, 0.0)
    player = jnp.clip(child.current_player, 0, 1)
    legal = jnp.moveaxis(jbit.bit_legal_mask_flat(child, player, n), 0, -1)
    jt = jmcts._set_node_state(jt, dst_slot, child)
    return jt.planes, jt.compid, jt.scalars, legal, child_terminal, term_val


@functools.partial(jax.jit, static_argnums=4)
def jax_select(jt, a0, k0, kt0, c_puct):
    """JAX's selection walk (mcts.py:352-368), from the given entry or, with
    ``a0`` None, from the PUCT root entry: ``_best_edge`` at node 0
    (mcts.py:672)."""
    if a0 is None:
        a0, k0, kt0 = jmcts._best_edge(jt, jnp.zeros(jt.visit.shape[:1], jnp.int32), c_puct)

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


def jax_entry(a0, k0, kt0) -> tuple:
    """A root entry for :func:`jax_select` (None stays None: from the root)."""
    if a0 is None:
        return None, None, None
    return i32(a0), i32(k0), jnp.asarray(kt0.numpy())


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


def outcome_rows(src) -> tuple:
    """The tree's terminal and tval rows for ``src``'s slots, [B, S], filled
    with values no step writes (True, 7.0)."""
    slots, b = src[0].shape[0], src[0].shape[-1]
    return torch.ones((b, slots), dtype=torch.bool), torch.full((b, slots), 7.0)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "gather"])
@pytest.mark.parametrize("name", list(CASES))
def test_bit_step_reference_matches_jax(name, dense):
    n, calls, revisits = step_calls(name)
    assert revisits > 0
    terminals = 0
    for src, slot, action, dst_slot in calls:
        dst = tuple(x.clone() for x in src)
        terminal, tval = outcome_rows(src)
        legal = tstep.bit_step_reference(src, slot, action, dst, dst_slot, n,
                                         outcome=(terminal, tval))
        planes, compid, scalars, want_legal, want_term, want_tval = jax_expand(
            jnp.asarray(src[0].numpy().astype(np.uint32)), jnp.asarray(src[1].numpy()),
            jnp.asarray(src[2].numpy()), (i32(slot), i32(action)), jnp.int32(dst_slot), n, dense)
        for got, want in zip(dst, (planes, compid, scalars)):
            assert same_bits(got, want)
        assert same_bits(legal.contiguous(), want_legal)
        # the child's terminal flag and value in column dst_slot, no other
        assert same_bits(terminal[:, dst_slot].contiguous(), want_term)
        assert same_bits(tval[:, dst_slot].contiguous(), want_tval)
        others = torch.arange(terminal.shape[1]) != dst_slot
        assert bool(terminal[:, others].all()) and bool((tval[:, others] == 7.0).all())
        terminals += int(terminal[:, dst_slot].sum())
    assert terminals > 0 or n > 5  # board 5's searches reach terminal children


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


def bit_step_constants() -> dict:
    """S1a's launch and shared-memory constants as ``csrc/bit_step.cu`` and
    the step's header set them."""
    text = (_cuda.CSRC / "bit_step.cu").read_text() + (_cuda.CSRC / "bit_step.cuh").read_text()
    out = {name: int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))
           for name in ("ENVS_PER_BLOCK", "SCALAR_WORDS", "PAD", "NUM_PLANES", "NUM_SCALARS",
                        "MIN_N", "MAX_N")}
    out["SMEM_LIMIT"] = eval(re.search(r"constexpr int SMEM_LIMIT = ([\d *]+);", text).group(1))
    out["GEO_LEN"] = eval(re.search(r"constexpr int GEO_LEN = ([\d +*]+);", text).group(1))
    return out


S1A = bit_step_constants()


def round_up(v, a):
    return (v + a - 1) // a * a


def s1a_layout(n: int) -> dict:
    """S1a's shared memory for board ``n`` (bytes): the geometry table, then
    a region an env (its Env: planes and compid; the compid words as
    copied, a u32 a cell; its scalars) of ``stride`` bytes."""
    p = n + 2 * S1A["PAD"]
    env_bytes = round_up(S1A["NUM_PLANES"] * p * 4 + n * n * 2, 16)
    scalars = env_bytes + n * n * 4
    stride = round_up(scalars + S1A["SCALAR_WORDS"] * 4, 32) + 16
    geo_bytes = round_up(S1A["GEO_LEN"] * 4, 16)
    return {"stage": env_bytes, "scalars": scalars, "stride": stride, "geo": geo_bytes,
            "total": geo_bytes + S1A["ENVS_PER_BLOCK"] * stride}


def test_bit_step_kernel_constants():
    """Eight envs a block (a planes word of eight envs is one 32-byte
    sector), every board's block within 48 KB (no opt-in), each env's region
    4 mod 8 words long, so that a warp's copy (8 envs x 4 rows) meets 32
    banks."""
    assert S1A["ENVS_PER_BLOCK"] * 4 == 32 and S1A["SMEM_LIMIT"] == 48 * 1024
    envs = S1A["ENVS_PER_BLOCK"]
    for n in range(S1A["MIN_N"], S1A["MAX_N"] + 1):
        lay = s1a_layout(n)
        assert lay["total"] <= S1A["SMEM_LIMIT"]
        assert lay["stride"] % 32 == 16 and lay["geo"] % 16 == 0
        words = lay["stride"] // 4
        for warp in range(envs):
            t = np.arange(warp * WARP, (warp + 1) * WARP)
            banks = ((t % envs) * words + t // envs) % 32
            assert len(set(banks.tolist())) == WARP


def test_bit_step_geometry_table_is_k1s(monkeypatch):
    """S1a's ``__constant__`` geometry table has no copy of its own in the
    source: the wrapper fills it once a device from ``_cuda.geo_table``,
    K1's table (``geometry``'s OFFSETS then CROSSERS), GEO_LEN ints."""
    text = (_cuda.CSRC / "bit_step.cu").read_text()
    assert re.search(r"__constant__ int GEO_TABLE\[GEO_LEN\];", text)
    assert "int twixt_bit_step_set_geometry(const int* table, int len)" in text
    assert "int twixt_bit_step_envs_per_block() { return ENVS_PER_BLOCK; }" in text
    seen = []

    def set_geometry(ptr, count):
        seen.append(list((ctypes.c_int32 * count).from_address(ptr)))
        return 0

    monkeypatch.setattr(_cuda, "load", lambda name: types.SimpleNamespace(
        twixt_bit_step_set_geometry=set_geometry))
    monkeypatch.setattr(tstep, "_GEOMETRY_SET", set())
    tstep._set_geometry(3)
    assert seen == [list(tgeo.OFFSETS.reshape(-1)) + list(tgeo.CROSSERS.reshape(-1))]
    assert len(seen[0]) == S1A["GEO_LEN"] and tstep._GEOMETRY_SET == {3}


def model_copy_in(src, slot, n: int, offset: int = 0) -> dict:
    """csrc/bit_step.cu's copy-in, thread by thread: thread t of block k
    copies rows t // 8, t // 8 + 32, ... of env 8k + t % 8 (planes words, the
    5 scalars, and for each compid cell the aligned u32 that holds the env's
    half, whose half it keeps: the low one at an address 0 mod 4), each from
    its env's slot; compid starts ``offset`` halves past a 4-byte boundary,
    and a half whose word holds no other half of the tensor (its first, its
    last) is read alone.  Returns each env's staged planes [B, 16P], compid
    [B, n*n], scalars [B, 5], how often each word was copied, the halves
    read alone and whether every warp's copy of a row spans 8 neighbouring
    envs."""
    planes, compid, scalars = (x.numpy() for x in src)
    slots, _, p, b = planes.shape
    words, cells, envs = 16 * p, n * n, S1A["ENVS_PER_BLOCK"]
    flat_p, flat_s = planes.reshape(-1), scalars.reshape(-1)
    flat_c = compid.reshape(-1).view(np.uint16)
    last = flat_c.size - 1
    # the memory around the tensor: its 4-byte words, whatever lies beside it
    memory = np.full(round_up(offset + flat_c.size, 2), 0xBEEF, np.uint16)
    memory[offset:offset + flat_c.size] = flat_c
    pairs = memory.view(np.uint32)
    got = {"planes": np.zeros((b, words), np.int32), "compid": np.zeros((b, cells), np.int16),
           "scalars": np.zeros((b, 5), np.int32), "cover": np.zeros((b, words + cells + 5), int),
           "alone": set(), "neighbours": True}
    for block in range(-(-b // envs)):
        for t in range(envs * WARP):
            cw, row0 = t % envs, t // envs
            env = block * envs + cw
            if env >= b:
                continue
            s = 0 if slot is None else int(slot[env])
            assert 0 <= s < slots
            for j in range(row0, words, WARP):
                got["planes"][env, j] = flat_p[(s * words + j) * b + env]
                got["cover"][env, j] += 1
            for c in range(row0, cells, WARP):
                e = (s * cells + c) * b + env
                high = (offset + e) & 1
                if (e > 0) if high else (e < last):
                    half = (int(pairs[(offset + e) >> 1]) >> (16 * high)) & 0xFFFF
                else:
                    half = int(flat_c[e])
                    got["alone"].add(e)
                got["compid"][env, c] = np.uint16(half).view(np.int16)
                got["cover"][env, words + c] += 1
            if row0 < 5:
                got["scalars"][env, row0] = flat_s[(s * 5 + row0) * b + env]
                got["cover"][env, words + cells + row0] += 1
    # a warp's rows: threads 8r..8r+7 copy one row of the block's 8 envs,
    # whose destination words (and, from one slot, source words) neighbour
    for t0 in range(0, envs * WARP, envs):
        got["neighbours"] &= [t % envs for t in range(t0, t0 + envs)] == list(range(envs))
    return got


def copy_in_cases():
    """Recorded and synthetic S1a inputs, B=13 slices (not a multiple of the
    envs a block) and ``src=None`` (one slot)."""
    out = []
    for name in ("n5-table-walk", "n8-table-amask"):
        n, calls, _ = step_calls(name)
        for src, slot, action, dst_slot in calls[::7]:
            out.append((n, src, slot))
            b13 = tuple(x[..., :13].contiguous() for x in src)
            out.append((n, b13, slot[:13]))
            out.append((n, tuple(x[:1].contiguous() for x in b13), None))
    return out


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset-half"])
def test_bit_step_copy_in_model(offset):
    """The kernel's copy-in gathers each env's source slot: every planes
    word, compid cell and scalar of it once, equal to ``gather_slots``
    (slot 0 of one-slot buffers with ``src=None``), wherever compid starts;
    only the tensor's first and last halves can be read alone: the last of
    an odd count at a 4-byte boundary (board 5, B=13, one slot: 325
    halves), the first past one."""
    alone = set()
    cases = copy_in_cases()
    assert any(x[1][0].shape[-1] == 13 for x in cases)
    for n, src, slot in cases:
        got = model_copy_in(src, slot, n, offset)
        assert (got["cover"] == 1).all() and got["neighbours"]
        want = (tstep.slot_state(*(x[0] for x in src)) if slot is None
                else tstep.gather_slots(src, slot))
        b = src[0].shape[-1]
        assert np.array_equal(got["planes"].T, tstep.stack_planes(want).numpy().reshape(-1, b))
        assert np.array_equal(got["compid"].T, want.compid.numpy().reshape(-1, b))
        assert np.array_equal(got["scalars"].T, tstep.stack_scalars(want).numpy())
        last = src[1].numel() - 1
        assert got["alone"] <= {0, last}
        alone |= {"first" if e == 0 else "last" for e in got["alone"]}
    assert alone == ({"last"} if offset == 0 else {"first", "last"})


# --- S1b: select_walk ---------------------------------------------------------


def select_calls(name, seed=1):
    """The search's selection calls (from the root), then forced root
    entries on the trees of its last four simulations."""
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
        w_node, w_action, w_kid, w_ct = jax_select(jax_tree(tree), *jax_entry(a0, k0, kt0),
                                                   C_PUCT)
        assert same_bits(node, w_node) and same_bits(action, w_action)
        assert same_bits(kid, w_kid)
        assert int(iters) == int(w_ct)
        descended += int(iters) > 1
    assert descended > 0


@pytest.mark.parametrize("name", list(CASES))
def test_select_walk_from_root_is_puct_root_entry(name):
    """The from-root mode's plain path is the old PUCT entry (``best_edge``
    at slot 0 of every env) followed by the walk from that entry, with the
    same count; and it is what the search recorded (every PUCT call)."""
    calls = recorded(name)["select"]
    assert calls and all(a0 is None for _, a0, _, _ in calls)
    for tree, *_ in calls:
        b = tree.visit.shape[0]
        entry = twalk.best_edge(tree, torch.arange(b), torch.zeros(b, dtype=torch.int64), C_PUCT)
        want_iters = torch.zeros((), dtype=torch.int32)
        want = twalk.select_walk_reference(tree, *entry, C_PUCT, want_iters)
        iters = torch.zeros((), dtype=torch.int32)
        got = twalk.select_walk_reference(tree, None, None, None, C_PUCT, iters)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int(iters) == int(want_iters)
        assert all(torch.equal(g, w) for g, w in zip(twalk.root_entry(tree, C_PUCT), entry))


@pytest.mark.parametrize("name", list(CASES))
def test_select_walk_from_root_matches_jax(name):
    """From the root, on every recorded tree: JAX's ``_best_edge`` at node 0
    iterated in the ``while_loop``, with its count."""
    descended = 0
    for tree, *_ in select_calls(name):
        iters = torch.zeros((), dtype=torch.int32)
        got = twalk.select_walk(tree, None, None, None, C_PUCT, iters)
        *want, w_ct = jax_select(jax_tree(tree), None, None, None, C_PUCT)
        for g, w in zip(got, want):
            assert same_bits(g, w)
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


def stage_slots(t: dict, b: int, c) -> dict:
    """select_walk_kernel's staging of env ``b``'s slot rows into shared
    memory: the terms of a child's score that do not depend on its parent,
    in float32 in the kernel's operation order, and each slot's key (its
    parent where linked, else -1)."""
    nodes = len(t["visit"][b])
    visit = t["visit"][b]
    parent = t["parent"][b]
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(t["terminal"][b], t["tval"][b],
                     -t["value_sum"][b] / np.maximum(visit, 1).astype(np.float32))
    key = np.where(t["linked"][b] & (parent >= 0) & (parent < nodes), parent, -1)
    return {"q": q.astype(np.float32), "cpe": (c * t["e_prior"][b]).astype(np.float32),
            "den": (np.float32(1.0) + visit.astype(np.float32)).astype(np.float32),
            "key": key.astype(np.int32), "visit": visit.astype(np.int32),
            "pa": t["pa"][b].astype(np.int32), "term": t["terminal"][b].copy()}


def model_edge(s: dict, up, node: int, c) -> tuple:
    """A level of the kernel's walk at ``node``: the child-side pass over the
    staged slots, the prior row's pass, the tie between them."""
    sq = np.sqrt(np.float32(max(int(s["visit"][node]), 1)))
    with np.errstate(divide="ignore", invalid="ignore"):
        child = s["q"] + (s["cpe"] * sq) / s["den"]
        prior = np.where(up >= 0, (c * up) * sq, np.float32(-np.inf))
    bc, c_star = warp_argmax(np.where(s["key"] == node, child, np.float32(-np.inf)))
    bu, bu_a = warp_argmax(prior.astype(np.float32))
    bc_a = int(s["pa"][c_star])
    wins = bc > bu or (bc == bu and bc_a < bu_a)
    return (bc_a, c_star, bool(s["term"][c_star])) if wins else (bu_a, -1, False)


def model_select_walk(tree, a0, k0, kt0, c_puct):
    """csrc/search.cu's select_walk_kernel, one env (warp) at a time: the
    staged rows, the root entry from ``a0, k0, kt0`` or, with ``a0`` None,
    the best edge at slot 0, then a level a descent."""
    c = np.float32(c_puct)
    t = {k: v.numpy() for k, v in tree._asdict().items()}
    out, longest = [], 0
    for b in range(t["visit"].shape[0]):
        nodes = t["visit"].shape[1]
        s = stage_slots(t, b, c)
        if a0 is None:
            action, kid, kt = model_edge(s, t["uprior"][b, 0], 0, c)
        else:
            action, kid, kt = int(a0[b]), int(k0[b]), bool(kt0[b])
        node, descents = 0, 0
        while 0 <= kid < nodes and not kt and descents < nodes:
            node = kid
            action, kid, kt = model_edge(s, t["uprior"][b, node], node, c)
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


def tie_tree():
    """A recorded tree made of ties: equal unexpanded edges (within a
    lane's two actions too), equal children, an env with no unexpanded edge
    left, NaN child values; and root entries into an expanded, non-terminal
    child wherever one exists."""
    tree = clone_tree(recorded("n8-table-walk")["select"][-1][0])  # two actions a lane
    b = tree.visit.shape[0]
    env = torch.arange(b)
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
    return tree, a0, k0, kt0


def test_select_walk_kernel_model_ties_and_nan():
    """Equal scores (within a lane's two actions too), an all -inf prior
    row and NaN values: the model's shuffle argmax makes the reference's
    (torch's) choices."""
    tree, a0, k0, kt0 = tie_tree()
    iters = torch.zeros((), dtype=torch.int32)
    want = twalk.select_walk_reference(tree, a0, k0, kt0, C_PUCT, iters)
    *got, longest = model_select_walk(tree, a0, k0, kt0, C_PUCT)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert longest == int(iters) > 1


def test_select_walk_kernel_model_ties_and_nan_from_root():
    """The same ties from the root entry, with every root child's value NaN
    in one env and equal in the others."""
    tree, *_ = tie_tree()
    tree.value_sum[5] = torch.where(tree.parent[5] == 0, float("nan"), tree.value_sum[5])
    iters = torch.zeros((), dtype=torch.int32)
    want = twalk.select_walk_reference(tree, None, None, None, C_PUCT, iters)
    *got, longest = model_select_walk(tree, None, None, None, C_PUCT)
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


def model_fix_up(vsum, scratch, iters: int) -> int:
    """The last block's work: +0.0 at slot 0 of every env whose walk is
    shorter than the longest (at least 1, as the plain loop runs once),
    the count raised to it, the scratch's counters zeroed.  Returns the
    count."""
    longest = max(1, int(scratch[0]))
    for e in range(vsum.shape[0]):
        if scratch[2 + e] < longest:
            vsum[e, 0] = np.float32(vsum[e, 0] + np.float32(0.0))
    scratch[:2] = 0
    return max(iters, longest)


def model_backup_walk(visit, vsum, parent, node_id, value, scratch, iters: int = 0,
                      envs_per_block: int = 4, order=None) -> int:
    """csrc/search.cu's backup_walk_kernel, its blocks run in ``order``
    (default: in turn): per env (warp) the parent row staged, the path
    followed from the leaf in it, lane i % 32 adding to the path's node i
    (+v at even i, -v at odd); each env's length and the device-wide
    maximum in ``scratch``; then each block's ticket, and the last block's
    fix-up (:func:`model_fix_up`).  Returns the count."""
    batch, nodes = visit.shape
    blocks = -(-batch // envs_per_block)
    for blk in range(blocks) if order is None else order:
        for env in range(blk * envs_per_block, min(batch, (blk + 1) * envs_per_block)):
            par = np.where((parent[env] >= 0) & (parent[env] < nodes), parent[env], -1)
            path, node = [], int(node_id[env]) if 0 <= node_id[env] < nodes else -1
            while node >= 0 and len(path) < nodes:
                path.append(node)
                node = int(par[node])
            v = np.float32(value[env])
            for i, nd in enumerate(path):
                visit[env, nd] += 1
                vsum[env, nd] = np.float32(vsum[env, nd] + (-v if i & 1 else v))
            scratch[2 + env] = len(path)
            scratch[0] = max(scratch[0], len(path))
        ticket = scratch[1]
        scratch[1] += 1
        if ticket == blocks - 1:
            iters = model_fix_up(vsum, scratch, iters)
    return iters


@pytest.mark.parametrize("name", list(CASES))
def test_backup_walk_kernel_model(name):
    """The kernel's walks, then its last block's fix-up (the trailing +0.0
    and the count), in any order of blocks, equal the plain loop; the
    scratch's counters end at 0."""
    zeros = 0
    rng = np.random.default_rng(5)
    for tree, node, value in backup_calls(name):
        visit, vsum = tree.visit.numpy().copy(), tree.value_sum.numpy().copy()
        b = visit.shape[0]
        scratch = np.zeros(2 + b, np.int64)
        got_iters = model_backup_walk(visit, vsum, tree.parent.numpy(), node.numpy(),
                                      value.numpy(), scratch, order=rng.permutation(-(-b // 4)))
        tree = clone_tree(tree)
        iters = torch.zeros((), dtype=torch.int32)
        twalk.backup_walk_reference(tree, node, value, iters)
        assert np.array_equal(visit, tree.visit.numpy())
        assert same_bits(torch.from_numpy(vsum), tree.value_sum.numpy())
        assert got_iters == int(iters)
        assert not scratch[:2].any()
        zeros += int((tree.value_sum[:, 0] == 0).sum())
    assert zeros > 0  # zero sums at the roots, whose sign the trailing +0.0 decides


FIX_UP_CASES = {
    # walk lengths, root sums before, count before -> root sums after, count after
    "equal-lengths": ([2, 2], [-0.0, -0.0], 0, [-0.0, -0.0], 2),
    "shorter-walks": ([1, 3, 3], [-0.0, -0.0, 1.5], 0, [0.0, -0.0, 1.5], 3),
    "nonzero-roots": ([1, 2, 4], [-2.5, 0.25, -0.0], 1, [-2.5, 0.25, -0.0], 4),
    "count-kept": ([1, 2], [-0.0, 3.0], 5, [0.0, 3.0], 5),
    "no-walk": ([0, 0], [-0.0, 2.0], 0, [0.0, 2.0], 1),
    "none-and-one": ([0, 1, 1], [-0.0, -0.0, 0.5], 0, [0.0, -0.0, 0.5], 1),
    "one-env": ([5], [-0.0], 2, [-0.0], 5),
    "two-blocks": ([1, 1, 1, 1, 2], [-0.0] * 5, 0, [0.0, 0.0, 0.0, 0.0, -0.0], 2),
}


@pytest.mark.parametrize("name", list(FIX_UP_CASES))
def test_backup_fix_up_model(name):
    """The kernel's fix-up after the walks (the last block's): +0.0 at slot
    0 of the envs whose walk is shorter than the longest (the plain loop's
    trailing adds; every env when no walk ran, since the loop runs once),
    slot 0 of the others and every other slot untouched, the count raised
    to the longest walk.  Then the whole kernel model against the plain
    loop on chain trees of those lengths (a leaf at depth length - 1, none
    at length 0), values +-0.0."""
    lengths, roots, iters0, want_roots, want_iters = FIX_UP_CASES[name]
    b = len(lengths)
    vsum = np.full((b, 3), -0.0, np.float32)
    vsum[:, 0] = roots
    scratch = np.array([max(lengths), 7, *lengths], np.int64)
    assert model_fix_up(vsum, scratch, iters0) == want_iters
    assert same_bits(torch.from_numpy(vsum[:, 0]), np.array(want_roots, np.float32))
    assert same_bits(torch.from_numpy(vsum[:, 1:]), np.full((b, 2), -0.0, np.float32))
    assert not scratch[:2].any()

    nodes = max(lengths) + 1
    parent = torch.arange(-1, nodes - 1, dtype=torch.int64).expand(b, nodes).contiguous()
    tree = tmcts.Tree(*([None] * len(tmcts.Tree._fields)))._replace(
        visit=torch.ones((b, nodes), dtype=torch.int32), parent=parent,
        value_sum=torch.full((b, nodes), -0.0))
    tree.value_sum[:, 0] = torch.tensor(roots)
    node = torch.tensor(lengths, dtype=torch.int64) - 1
    value = torch.tensor([0.0, -0.0] * b)[:b]
    visit, got = tree.visit.numpy().copy(), tree.value_sum.numpy().copy()
    scratch = np.zeros(2 + b, np.int64)
    got_iters = model_backup_walk(visit, got, parent.numpy(), node.numpy(), value.numpy(),
                                  scratch, iters0, envs_per_block=2)
    iters = torch.tensor(iters0, dtype=torch.int32)
    twalk.backup_walk_reference(tree, node, value, iters)
    assert np.array_equal(visit, tree.visit.numpy())
    assert same_bits(torch.from_numpy(got), tree.value_sum.numpy())
    assert got_iters == int(iters) == want_iters


# --- the wrappers: dispatch, checks, the build ------------------------------


def test_no_fallback_off_cpu():
    tree, *_ = recorded("n5-table-walk")["select"][0]
    a0, k0, kt0 = forced_root_entries(tree, np.random.default_rng(0))
    src, slot, action, dst_slot = recorded("n5-table-walk")["step"][0]
    meta = tmcts.Tree(*(x.to("meta") for x in tree))
    with pytest.raises(ValueError, match="no kernel"):
        twalk.select_walk(meta, a0.to("meta"), k0.to("meta"), kt0.to("meta"), C_PUCT)
    with pytest.raises(ValueError, match="no kernel"):
        twalk.select_walk(meta, None, None, None, C_PUCT)
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
    tree, *_ = recorded("n5-table-walk")["select"][0]
    _, k0, _ = forced_root_entries(tree, np.random.default_rng(0))
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
    # one env's staged rows must fit a block's shared memory: the launcher
    # decides from the device's limit (on the card: 9,297 slots for the
    # selection, 29,056 for the backup, chip_smoke.py phase 13) and returns
    # its own code, which the wrapper raises as an error naming the slots
    twalk._check_rc(0, "select_walk", 65)
    with pytest.raises(ValueError, match="select_walk: 9298 slots: .* shared memory"):
        twalk._check_rc(twalk.TOO_MANY_SLOTS, "select_walk", 9298)
    with pytest.raises(ValueError, match="backup_walk: 29057 slots: .* shared memory"):
        twalk._check_rc(twalk.TOO_MANY_SLOTS, "backup_walk", 29_057)
    tstep._check_bufs(src, 5, b, src[0].device, "source")
    with pytest.raises(ValueError, match="source compid"):
        tstep._check_bufs((src[0], src[1].int(), src[2]), 5, b, src[0].device, "source")
    with pytest.raises(ValueError, match="source planes"):
        tstep._check_bufs(src, 6, b, src[0].device, "source")
    with pytest.raises(ValueError, match="outside"):
        tstep._check_bufs(src, 25, b, src[0].device, "source")


def test_bit_step_wrapper_checks_outcome():
    """The outcome rows must be the destination's [B, S_out] bool and
    float32 rows."""
    src, _, _, _ = recorded("n5-table-walk")["step"][0]
    slots, b = src[0].shape[0], src[0].shape[-1]
    terminal, tval = outcome_rows(src)
    assert len(tstep._check_outcome((terminal, tval), b, slots, terminal.device)) == 2
    with pytest.raises(ValueError, match="outcome tval"):
        tstep._check_outcome((terminal, tval.double()), b, slots, terminal.device)
    with pytest.raises(ValueError, match="outcome terminal"):
        tstep._check_outcome((terminal[:, :-1], tval), b, slots, terminal.device)
    with pytest.raises(ValueError, match="outcome terminal"):
        tstep._check_outcome((terminal.t().contiguous().t(), tval), b, slots, terminal.device)


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
    # the launchers' code for one env past a block's shared memory is the
    # wrapper's, and the library names it
    assert f"constexpr int TOO_MANY_SLOTS = {twalk.TOO_MANY_SLOTS};" in search
    assert "if (code == TOO_MANY_SLOTS) return" in search
    for name in ("bit_step", "search", "fused_bit_rollout"):
        text = (_cuda.CSRC / f"{name}.cu").read_text()
        assert "twixt_cuda_error_string" in text
    # K1 and S1a run one step: the header's, included by both
    for name in ("bit_step", "fused_bit_rollout"):
        text = (_cuda.CSRC / f"{name}.cu").read_text()
        assert '#include "bit_step.cuh"' in text
        assert not re.search(r"__device__ int step_bits\(", text)
