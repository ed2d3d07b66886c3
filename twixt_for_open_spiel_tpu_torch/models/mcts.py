"""Batched AlphaZero searches on the bitboard engine
(``twixt_for_open_spiel_tpu/models/mcts.py``): one array-of-trees search
over the env batch, as PUCT (``search_batch``), Gumbel sequential halving
(``gumbel_search_batch``) or PUCT with tree reuse across moves
(``search_batch_reuse``), which share one simulation body below the root.

Every tree array carries a leading ``[B]`` env axis and every phase of a
simulation is a whole-batch operation, as in the JAX search: child-side
best-edge scoring over the ``[B, nodes]`` slots, a masked-prior array
``uprior`` whose ``-1`` marks an illegal or already-expanded edge, one
batched engine step per simulation for the expansion, one batched
evaluator call, and either backup (ancestor masks or the parent-chain
walk).  The float32 PUCT scores keep the JAX search's order of operations
and its three tie rules, so with deterministic evaluators and no root noise
the root visit counts equal JAX's integer for integer; Gumbel's candidate
rankings keep ``jax.lax.top_k``'s order of ties (a stable sort).

Kernels.  A simulation runs the selection walk
(``ops/search_walk.py::select_walk``, S1b, the PUCT root entry included),
the expansion (``ops/bit_step.py::bit_step``, S1a: the parent slot's step,
the child's legal mask, its slot write, its terminal flag and value), the
evaluator, the tree's writes and the backup (the ancestor masks as torch
ops, or ``backup_walk``, S1c).  On the card each of S1a-S1c is one CUDA
launch and a simulation makes no host read; on the CPU their plain
versions run, whose walks read ``any()`` once an iteration, as JAX's
``while_loop``s test it.  ``return_stats`` counts
the walks' lockstep iterations (the deepest env's depth plus one) on the
device and reads them once, at the end.

Randomness comes from one ``torch.Generator`` on the search's device, used
in turn by the evaluator and the Dirichlet root noise (gamma draws by
Marsaglia and Tsang) or the Gumbels.  ``jax.random`` streams cannot be matched bit for bit,
so those parts agree with JAX in distribution only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from twixt_for_open_spiel_tpu_torch.models.network import masked_policy
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.bit_step import (
    bit_step,
    outcome_value,
    slot_state,
    stack_planes,
    stack_scalars,
)
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    BitState,
    bit_legal_mask_flat,
    bitstate_from_leaves,
    bitstate_leaves,
    from_state,
    rollout_noise,
    sample_bits,
    step_bits,
)
from twixt_for_open_spiel_tpu_torch.ops.observe import bit_observation_nchw
from twixt_for_open_spiel_tpu_torch.ops.search_walk import NO_NODE, backup_walk, select_walk
from twixt_for_open_spiel_tpu_torch.utils.profiling import annotate

_I32 = torch.int32
_I64 = torch.int64

# "auto" backup takes the ancestor masks up to this many tree nodes and the
# parent-chain walk above (JAX's setting, chosen on the TPU; on the card the
# two read within their spread of each other at 64-256 simulations, PERF.md).
_AMASK_MAX_NODES = 160


def _resolve_backup(backup: str, nodes: int) -> bool:
    """True for the ancestor-mask backup, False for the walk."""
    if backup not in ("auto", "amask", "walk"):
        raise ValueError(f"backup must be auto, amask or walk, not {backup!r}")
    if backup == "auto":
        return nodes <= _AMASK_MAX_NODES
    return backup == "amask"


class Tree(NamedTuple):
    """Flat search trees for the whole env batch (the JAX ``Tree``).

    Stats are batch-leading; node states are stacked buffers with a leading
    ``[nodes]`` axis over the engine's batch-trailing layout.  Node ids and
    actions are int64 here (torch indexes with int64), int32 in JAX.
    """

    visit: torch.Tensor      # int32 [B, nodes]
    value_sum: torch.Tensor  # f32 [B, nodes]
    uprior: torch.Tensor     # f32 [B, nodes, A] masked prior (-1 = dead)
    parent: torch.Tensor     # int64 [B, nodes]
    pa: torch.Tensor         # int64 [B, nodes] action taken at the parent
    e_prior: torch.Tensor    # f32 [B, nodes] prior of the edge into a node
    terminal: torch.Tensor   # bool [B, nodes]
    # value of a terminal node from the perspective of the player to move
    # at its PARENT; 0 for non-terminal
    tval: torch.Tensor       # f32 [B, nodes]
    linked: torch.Tensor     # bool [B, nodes] slot actually in the tree
    root_child: torch.Tensor  # int64 [B, A] child node id of root edges / -1
    # root-path sets and depths for the amask backup; [B, 1, 1] and [B, 1]
    # placeholders under the walk backup
    amask: torch.Tensor      # bool [B, nodes, nodes] or [B, 1, 1]
    depth: torch.Tensor      # int32 [B, nodes] or [B, 1]
    planes: torch.Tensor     # int32 [nodes, 16, P, B] packed bitplanes
    compid: torch.Tensor     # int16 [nodes, N, N, B]
    scalars: torch.Tensor    # int32 [nodes, 5, B]


def _init_tree(bs: BitState, batch: int, nodes: int, a_dim: int, root_value,
               root_uprior, use_amask: bool = False) -> Tree:
    """Fresh array-of-trees state: root at slot 0, one visit, given prior;
    every node slot holds a copy of the root state."""
    dev = bs.red.device

    def alloc(x):
        return x.unsqueeze(0).expand((nodes,) + x.shape).clone()

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if use_amask:
        amask = full((batch, nodes, nodes), False, torch.bool)
        amask[:, 0, 0] = True
        depth = full((batch, nodes), 0, _I32)
    else:
        amask = full((batch, 1, 1), False, torch.bool)
        depth = full((batch, 1), 0, _I32)
    visit = full((batch, nodes), 0, _I32)
    visit[:, 0] = 1
    value_sum = full((batch, nodes), 0.0, torch.float32)
    value_sum[:, 0] = root_value
    uprior = full((batch, nodes, a_dim), -1.0, torch.float32)
    uprior[:, 0] = root_uprior
    linked = full((batch, nodes), False, torch.bool)
    linked[:, 0] = True
    return Tree(
        visit=visit,
        value_sum=value_sum,
        uprior=uprior,
        parent=full((batch, nodes), NO_NODE, _I64),
        pa=full((batch, nodes), 0, _I64),
        e_prior=full((batch, nodes), 0.0, torch.float32),
        terminal=full((batch, nodes), False, torch.bool),
        tval=full((batch, nodes), 0.0, torch.float32),
        linked=linked,
        root_child=full((batch, a_dim), NO_NODE, _I64),
        amask=amask,
        depth=depth,
        planes=alloc(stack_planes(bs)),
        compid=alloc(bs.compid),
        scalars=alloc(stack_scalars(bs)),
    )


def _make_simulate(*, params, generator, evaluator, board_size: int, batch: int,
                   nodes: int, a_dim: int, c_puct: float, use_amask: bool, dev,
                   root_entry=None, fresh_base: int = 1, iters=None):
    """One simulation (selection -> expansion -> evaluation -> backup) as
    ``simulate(sim, tree)``; it updates ``tree`` in place.

    ``root_entry(tree, sim) -> (action, kid, kid_term)`` chooses the root
    edge of simulation ``sim``, a forced candidate
    (:func:`gumbel_search_batch`); None takes the PUCT best edge at slot 0
    (:func:`search_batch`, :func:`search_batch_reuse`), which the selection
    walk computes itself (S1b's from-root mode).  Below the root every
    search shares the lockstep PUCT walk, the expansion and the backup.
    Simulation ``sim`` expands into slot ``fresh_base + sim`` in every env:
    1 for a cold tree, ``reuse_cap`` for a re-rooted one whose survivors
    hold the slots below.
    ``iters`` (int32 [2, simulations], zeroed) takes simulation ``sim``'s
    selection and walk-backup iteration counts in column ``sim``.
    """
    env = torch.arange(batch, device=dev)
    iota_a = torch.arange(a_dim, device=dev)
    iota_n = torch.arange(nodes, device=dev)

    def simulate(sim: int, tree: Tree) -> None:
        new_node = fresh_base + sim  # next free slot (uniform over envs)

        # --- selection: every env walks down from its root entry until its
        # best edge is unexpanded or leads to a terminal child
        with annotate("search.select"):
            entry = (None, None, None) if root_entry is None else root_entry(tree, sim)
            leaf_parent, action, existing_kid = select_walk(
                tree, *entry, c_puct, None if iters is None else iters[0, sim])
        # an existing child here is terminal (selection stops only on a
        # missing or terminal child): no expansion, its exact value is
        # backed up again
        revisit = existing_kid >= 0

        # --- expansion: one batched engine step from the parent slots into
        # slot new_node, unconditionally, with the child's terminal flag and
        # value (the parent's view) in column new_node; for revisit envs the
        # slot holds unlinked garbage (linked=False keeps it out of every
        # child-side pass)
        with annotate("search.expand"):
            bufs = (tree.planes, tree.compid, tree.scalars)
            child_legal = bit_step(bufs, leaf_parent, action, bufs, new_node, board_size,
                                   outcome=(tree.terminal, tree.tval))
            child_state = slot_state(tree.planes[new_node], tree.compid[new_node],
                                     tree.scalars[new_node])
        child_terminal = tree.terminal[:, new_node]

        with annotate("search.evaluate"):
            logits, value = evaluator(params, child_state, generator)
            prior = masked_policy(logits, child_legal)
        # leaf value from the perspective of the player to move at the
        # child; a terminal value is the parent's, so negated
        backup_value = torch.where(child_terminal, -tree.tval[:, new_node], value)
        node_id = torch.where(revisit, existing_kid, new_node)

        with annotate("search.backup"):
            e_prior_new = tree.uprior[env, leaf_parent, action]  # >= 0: live edge
            if use_amask:
                parent_amask = tree.amask[env, leaf_parent]  # [B, nodes]
                parent_depth = tree.depth[env, leaf_parent]
                tree.amask[:, new_node] = parent_amask | (iota_n == new_node)
                tree.depth[:, new_node] = parent_depth + 1
            # retire the expanded edge (a no-op re-retire for revisit envs): a
            # fill, where an indexed store of a Python number would copy it to
            # the card and wait for the copy
            tree.uprior.view(-1).index_fill_(0, (env * nodes + leaf_parent) * a_dim + action, -1.0)
            tree.uprior[:, new_node] = torch.where(child_legal, prior, -1.0)
            tree.parent[:, new_node] = leaf_parent
            tree.pa[:, new_node] = action
            tree.e_prior[:, new_node] = e_prior_new
            tree.linked[:, new_node] = ~revisit
            root_edge = (~revisit & (leaf_parent == 0))[:, None] & (action[:, None] == iota_a)
            tree.root_child.masked_fill_(root_edge, new_node)

            # --- backup: values alternate sign per level, +backup_value at the
            # leaf; one float add per path node in both variants
            if use_amask:
                path = tree.amask[env, node_id]                      # [B, nodes]
                leaf_depth = tree.depth[env, node_id]
                sign = 1.0 - 2.0 * ((leaf_depth[:, None] - tree.depth) & 1).float()
                tree.visit.add_(path.to(_I32))
                tree.value_sum.add_(torch.where(path, backup_value[:, None] * sign, 0.0))
            else:
                backup_walk(tree, node_id, backup_value, None if iters is None else iters[1, sim])

    return simulate


def net_evaluator(net_apply, board_size: int):
    """Batched leaf evaluator backed by a policy/value net.

    Evaluators map (params, bitstate [.., B], generator) -> (logits [B, A],
    value [B]), the value from the perspective of the player to move.
    ``net_apply(params, obs)`` runs the net (``network.call_net`` for a
    torch module passed as ``params``)."""

    def evaluate(params, bs: BitState, generator):
        del generator
        return net_apply(params, bit_observation_nchw(bs, board_size))

    return evaluate


def one_rollout(bs: BitState, board_size: int, seed) -> torch.Tensor:
    """One lockstep uniform random playout of every env to its end: +1 if
    the player to move at ``bs`` wins, 0 on a draw, -1 on a loss (float32
    [B]).  Move i of env e draws from ``rollout_noise(seed, i, e)``, the
    counter hash of the JAX rollout evaluator, so a u32 ``seed`` (an int or
    an int64 tensor) gives JAX's values bit for bit.  Finished envs are
    frozen; the host reads ``any(open)`` once a move."""
    n = board_size
    to_move = bs.current_player.clamp(0, 1)
    env = torch.arange(bs.current_player.shape[-1], dtype=_I64, device=bs.red.device)
    s = bs
    for i in range(n * n):  # >= any remaining game length (MaxGameLength = n*n-3)
        open_ = s.result == geo.RESULT_OPEN
        if not bool(open_.any()):
            break
        a = sample_bits(s, n, rollout_noise(seed, i, env))
        nxt = step_bits(s, n, a)
        s = bitstate_from_leaves(
            torch.where(open_, new, old)
            for new, old in zip(bitstate_leaves(nxt), bitstate_leaves(s))
        )
    return outcome_value(s.result, to_move)


def rollout_evaluator(board_size: int, rollout_count: int = 1):
    """Batched leaf evaluator backed by uniform random playouts (vanilla
    MCTS, OpenSpiel's RandomRolloutEvaluator): the mean of
    ``rollout_count`` :func:`one_rollout` values, each from a u32 seed
    drawn from the generator; priors are uniform (zero logits)."""
    n = board_size

    def evaluate(params, bs: BitState, generator):
        del params
        batch = bs.current_player.shape[-1]
        total = torch.zeros(batch, dtype=torch.float32, device=bs.red.device)
        for _ in range(rollout_count):
            seed = torch.randint(0, 1 << 32, (), generator=generator,
                                 device=bs.red.device, dtype=_I64)
            total = total + one_rollout(bs, n, seed)
        logits = torch.zeros((batch, n * n), dtype=torch.float32, device=bs.red.device)
        return logits, total / rollout_count

    return evaluate


def _log_gamma(generator, alpha: float, shape, device) -> torch.Tensor:
    """log of Gamma(alpha, 1) draws, float32: Marsaglia and Tsang's
    rejection at shape alpha (alpha + 1 below 1, then scaled by
    U**(1/alpha)), redrawn until every element is accepted (one host read
    a round)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    while True:
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(v)  # nan where v <= 0, which rejects
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        out = torch.where(ok & ~done, math.log(d) + log_v, out)
        done = done | ok
        if bool(done.all()):
            break
    if alpha < 1.0:
        u = torch.rand(shape, generator=generator, device=device)
        out = out + torch.log(u) / alpha
    return out


def dirichlet(generator, alpha: float, shape, device) -> torch.Tensor:
    """Symmetric Dirichlet(alpha) draws over the last axis of ``shape``
    (float32): gamma draws normalised per row, in log space so that small
    ``alpha`` cannot underflow a row to zero."""
    lg = _log_gamma(generator, alpha, shape, device)
    return torch.softmax(lg, dim=-1)


@torch.no_grad()
def search_batch(params, bs: BitState, generator, *, evaluator, board_size: int,
                 num_simulations: int, c_puct: float = 1.4,
                 dirichlet_alpha: float = 0.3, dirichlet_frac: float = 0.25,
                 return_stats: bool = False, backup: str = "auto"):
    """Run MCTS from a batch of root BitStates (batch-trailing, 1-D batch).

    Roots must be non-terminal.  ``generator`` is a ``torch.Generator`` on
    the states' device.  Returns (visit_probs [B, A], root_q [B]); with
    ``return_stats`` also ``{"sel_iters", "backup_iters"}``, the lockstep
    selection and backup walk iterations summed over the simulations
    (counted on the device, read once at the end; backup_iters is 0 under
    the amask backup).
    """
    if bs.current_player.ndim != 1:
        raise ValueError("search_batch wants a 1-D env batch")
    a_dim = board_size * board_size
    nodes = num_simulations + 1
    batch = bs.current_player.shape[-1]
    dev = bs.red.device
    with annotate("search.root"):
        root_player = bs.current_player.clamp(0, 1)
        root_legal = bit_legal_mask_flat(bs, root_player, board_size).T  # [B, A]
        root_logits, root_value = evaluator(params, bs, generator)
        noise = dirichlet(generator, dirichlet_alpha, (batch, a_dim), dev)
        root_prior = masked_policy(root_logits, root_legal)
        root_prior = torch.where(
            root_legal,
            (1 - dirichlet_frac) * root_prior + dirichlet_frac * noise,
            0.0,
        )
        root_prior = root_prior / root_prior.sum(-1, keepdim=True).clamp_min(1e-9)

        use_amask = _resolve_backup(backup, nodes)
        tree = _init_tree(bs, batch, nodes, a_dim, root_value,
                          torch.where(root_legal, root_prior, -1.0), use_amask)
        iters = None
        if return_stats:
            iters = torch.zeros((2, num_simulations), dtype=_I32, device=dev)
        simulate = _make_simulate(
            params=params, generator=generator, evaluator=evaluator,
            board_size=board_size, batch=batch, nodes=nodes, a_dim=a_dim,
            c_puct=c_puct, use_amask=use_amask, dev=dev, iters=iters,
        )
    for sim in range(num_simulations):
        simulate(sim, tree)

    visit_probs, root_q = _root_result(tree, root_legal)
    if return_stats:
        sel_ct, bk_ct = iters.sum(1).tolist()
        return visit_probs, root_q, {"sel_iters": sel_ct, "backup_iters": bk_ct}
    return visit_probs, root_q


def _root_visits(tree: Tree) -> torch.Tensor:
    """Visit count of each root edge's child, child-side ([B, A] int32; 0
    for an unexpanded edge)."""
    kid = tree.root_child
    return torch.where(kid >= 0, tree.visit.gather(1, kid.clamp_min(0)), 0)


def _root_q(tree: Tree) -> torch.Tensor:
    """Mean value of the root's visits ([B] float32)."""
    return tree.value_sum[:, 0] / tree.visit[:, 0].clamp_min(1).float()


def _root_result(tree: Tree, root_legal: torch.Tensor):
    """(visit_probs [B, A], root_q [B]) of a finished PUCT search."""
    kid_visits = torch.where(root_legal, _root_visits(tree), 0)
    visit_probs = kid_visits.float() / kid_visits.sum(-1, keepdim=True).clamp_min(1).float()
    return visit_probs, _root_q(tree)


def _halving_schedule(max_considered: int, a_dim: int, num_simulations: int):
    """Static sequential-halving schedule: ``(m, [(live, per), ...])``, the
    candidate count (clamped) and, a phase each, the live candidates and
    the forced simulations each gets (JAX's ``_halving_schedule``, copied
    and pinned equal to it).

    ``m`` halves until one visit per live candidate per phase fits the
    budget; each phase aims at an equal share of the budget, remainders go
    to later phases, and the last phase (a live pair) spends the rest, so
    at most one simulation is left unspent."""
    if num_simulations < 2:
        raise ValueError(
            "gumbel search needs num_simulations >= 2 (a 1-simulation budget "
            "would pick by g + logits alone)")

    def lives_of(m):
        # the halving sequence, ending at a live pair: 6 -> [6, 3, 2]
        lives, live = [], m
        while live >= 2:
            lives.append(live)
            if live == 2:
                break
            live = max(2, live // 2)
        return lives

    m = max(2, min(max_considered, a_dim, num_simulations))
    while m > 2 and sum(lives_of(m)) > num_simulations:
        m = max(2, m // 2)

    lives = lives_of(m)
    n_phases = len(lives)
    share = num_simulations // n_phases
    schedule = []
    remaining = num_simulations
    for i, live in enumerate(lives):
        rest_min = sum(lives[i + 1:])  # one visit a candidate in later phases
        if i == n_phases - 1:
            per = remaining // live
        else:
            per = min(max(1, share // live), (remaining - rest_min) // live)
        schedule.append((live, per))
        remaining -= per * live
    return m, schedule


def _draw_gumbel(generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws, float32: ``-log(-log(U))`` with U uniform on
    [tiny, 1), as ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _top(x: torch.Tensor, k: int):
    """The ``k`` largest of each row and their indices, largest first and
    equal values by the lower index (``jax.lax.top_k``'s order; torch.topk
    leaves ties unordered)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


@torch.no_grad()
def gumbel_search_batch(params, bs: BitState, generator, *, evaluator, board_size: int,
                        num_simulations: int, max_considered: int = 16,
                        c_puct: float = 1.4, c_visit: float = 50.0, c_scale: float = 1.0,
                        gumbel_noise=None, backup: str = "auto"):
    """Gumbel sequential-halving root search (JAX's ``gumbel_search_batch``).

    One Gumbel a root action (``gumbel_noise`` [B, A] if given, else drawn
    from ``generator`` after the root evaluation) picks the top
    ``max_considered`` candidates by ``g + logits``; the budget is spent in
    the phases of :func:`_halving_schedule`, each live candidate getting the
    same number of forced root simulations (candidate ``(sim - offset) %
    live`` at simulation ``sim``), and the field halves by ``g + logits +
    sigma(qhat)``, ``sigma(q) = (c_visit + max visits) * c_scale * q``.
    Below the root the PUCT walk of ``_make_simulate`` runs unchanged.

    Returns ``(action, improved_policy, root_q)``: the surviving candidate
    [B], ``softmax(logits + sigma(completed Q))`` over the legal actions
    [B, A] (a visited child's Q, else the root value), and the mean value of
    the root's visits [B].
    """
    if bs.current_player.ndim != 1:
        raise ValueError("gumbel_search_batch wants a 1-D env batch")
    a_dim = board_size * board_size
    m, schedule = _halving_schedule(max_considered, a_dim, num_simulations)
    nodes = num_simulations + 1
    batch = bs.current_player.shape[-1]
    dev = bs.red.device
    env = torch.arange(batch, device=dev)
    with annotate("search.root"):
        root_player = bs.current_player.clamp(0, 1)
        root_legal = bit_legal_mask_flat(bs, root_player, board_size).T  # [B, A]
        root_logits, root_value = evaluator(params, bs, generator)
        root_logits = torch.where(root_legal, root_logits, -math.inf)
        root_prior = masked_policy(root_logits, root_legal)
        if gumbel_noise is None:
            gumbel_noise = _draw_gumbel(generator, (batch, a_dim), dev)
        base = torch.where(root_legal, gumbel_noise + root_logits, -math.inf)

        cand_base, cand_actions = _top(base, m)                      # [B, m]
        # envs with fewer than m legal actions: the leader fills the tail (its
        # extra forced simulations are ordinary revisits and descents)
        cand_valid = torch.isfinite(cand_base)
        cand_actions = torch.where(cand_valid, cand_actions, cand_actions[:, :1])
        cand_base = torch.where(cand_valid, cand_base, cand_base[:, :1])

        use_amask = _resolve_backup(backup, nodes)
        tree = _init_tree(bs, batch, nodes, a_dim, root_value,
                          torch.where(root_legal, root_prior, -1.0), use_amask)

    def node_q(tree):
        """Each node's value from its parent's perspective ([B, nodes])."""
        return torch.where(tree.terminal, tree.tval,
                           -tree.value_sum / tree.visit.clamp_min(1).float())

    def cand_qhat(tree, actions):
        """Completed Q of each candidate: its child's Q if expanded, else
        the root value."""
        kid = tree.root_child.gather(1, actions)
        q = node_q(tree).gather(1, kid.clamp_min(0))
        return torch.where(kid >= 0, q, root_value[:, None])

    def sigma_scale(tree):
        maxvisit = _root_visits(tree).amax(-1).float()               # [B]
        return (c_visit + maxvisit) * c_scale

    offset = 0
    for phase_i, (live, per) in enumerate(schedule):
        live_actions = cand_actions[:, :live]

        def root_entry(tree, sim, live_actions=live_actions, offset=offset, live=live):
            a0 = live_actions[:, (sim - offset) % live]
            k0 = tree.root_child[env, a0]
            kt0 = (k0 >= 0) & tree.terminal[env, k0.clamp_min(0)]
            return a0, k0, kt0

        simulate = _make_simulate(
            params=params, generator=generator, evaluator=evaluator,
            board_size=board_size, batch=batch, nodes=nodes, a_dim=a_dim,
            c_puct=c_puct, use_amask=use_amask, dev=dev, root_entry=root_entry,
        )
        for sim in range(offset, offset + live * per):
            simulate(sim, tree)
        offset += live * per

        if phase_i + 1 < len(schedule):
            # shrink the field to the next phase's live count by
            # g + logits + sigma(qhat); survivors first, the leader pads
            score = (cand_base[:, :live]
                     + sigma_scale(tree)[:, None] * cand_qhat(tree, live_actions))
            keep = schedule[phase_i + 1][0]
            _, top_idx = _top(score, keep)
            new_actions = live_actions.gather(1, top_idx)
            new_base = cand_base[:, :live].gather(1, top_idx)
            cand_actions = torch.cat(
                [new_actions, new_actions[:, :1].expand(batch, m - keep)], dim=1)
            cand_base = torch.cat([new_base, new_base[:, :1].expand(batch, m - keep)], dim=1)

    # the final pick: every schedule ends with a live pair, best two first
    live_actions = cand_actions[:, :2]
    sig = sigma_scale(tree)
    final_score = cand_base[:, :2] + sig[:, None] * cand_qhat(tree, live_actions)
    action = live_actions.gather(1, final_score.argmax(-1, keepdim=True))[:, 0]

    # the improved policy over every action: logits + sigma(completed Q)
    kid = tree.root_child
    q_all = torch.where(kid >= 0, node_q(tree).gather(1, kid.clamp_min(0)), 0.0)
    visited = (kid >= 0) & (_root_visits(tree) > 0)
    q_completed = torch.where(visited, q_all, root_value[:, None])
    inner = torch.where(root_legal, root_logits, 0.0) + sig[:, None] * q_completed
    improved = torch.where(root_legal, masked_policy(inner, root_legal), 0.0)
    return action, improved, _root_q(tree)


def reuse_nodes(num_simulations: int, reuse_cap: int | None = None) -> int:
    """Slot count of a reuse tree: ``reuse_cap`` survivor slots (the new
    root at 0) and one fresh slot a simulation."""
    cap = num_simulations + 1 if reuse_cap is None else reuse_cap
    return cap + num_simulations


def init_reuse_tree(bs: BitState, *, board_size: int, num_simulations: int,
                    reuse_cap: int | None = None, backup: str = "auto") -> Tree:
    """An empty tree of the reuse layout (nothing linked, no root child):
    the seed of :func:`search_batch_reuse`'s carry, whose first call finds
    nothing to reuse and starts every env cold."""
    nodes = reuse_nodes(num_simulations, reuse_cap)
    a_dim = board_size * board_size
    batch = bs.current_player.shape[-1]
    dev = bs.red.device
    tree = _init_tree(bs, batch, nodes, a_dim,
                      torch.zeros(batch, dtype=torch.float32, device=dev),
                      torch.full((batch, a_dim), -1.0, device=dev),
                      _resolve_backup(backup, nodes))
    tree.visit.zero_()
    tree.linked.zero_()
    return tree


def _descendant_mask(tree: Tree, kid: torch.Tensor, nodes: int, use_amask: bool):
    """bool [B, nodes]: the linked nodes whose root path passes through (or
    is) ``kid``, the subtree that survives a re-root on ``kid``.

    Under the amask backup, the column ``kid`` of the stored root-path sets;
    under the walk, pointer doubling over the parent array,
    ``max(1, (nodes - 1).bit_length())`` rounds of [B, nodes] gathers."""
    if use_amask:
        idx = kid.clamp_min(0)[:, None, None].expand(-1, nodes, 1)
        return tree.amask.gather(2, idx)[:, :, 0] & tree.linked
    iota = torch.arange(nodes, device=kid.device)
    reach = iota[None, :] == kid[:, None]
    ptr = tree.parent
    for _ in range(max(1, (nodes - 1).bit_length())):
        up = ptr.clamp_min(0)
        reach = reach | (reach.gather(1, up) & (ptr >= 0))
        ptr = torch.where(ptr >= 0, ptr.gather(1, up), NO_NODE)
    return reach & tree.linked


@torch.no_grad()
def search_batch_reuse(params, bs: BitState, generator, tree: Tree, played, was_done, *,
                       evaluator, board_size: int, num_simulations: int,
                       reuse_cap: int | None = None, c_puct: float = 1.4,
                       dirichlet_alpha: float = 0.3, dirichlet_frac: float = 0.25,
                       backup: str = "auto", return_stats: bool = False):
    """PUCT search that reuses the tree across moves (JAX's
    ``search_batch_reuse``): re-root the previous call's trees on the action
    each env then played (``played`` [B], -1 for none), keep the surviving
    subtree's visits, values and priors, and spend the new budget on top.
    Returns ``(visit_probs [B, A], root_q [B], tree)``; pass that tree, the
    action played next and the env's auto-reset flag (``was_done`` [B]) to
    the next call, and :func:`init_reuse_tree` to the first.

    Slots ``[0, reuse_cap)`` hold the survivors, compacted per env (the
    played child at 0, the rest in slot order); simulation ``sim`` expands
    into slot ``reuse_cap + sim``.  An env starts cold, exactly as
    :func:`search_batch` does, when its played action has no child, it
    auto-reset, or the subtree holds more than ``reuse_cap`` nodes.  The new
    root's prior (unexpanded edges from its masked-prior row, expanded ones
    from their children's edge priors) gets the fresh root's Dirichlet mix
    and renormalisation again; the noise is drawn even at
    ``dirichlet_frac=0``.  ``reuse_cap`` defaults to ``num_simulations + 1``.

    With ``return_stats`` also ``{"reused_envs", "inherited_visits"}``: the
    envs that re-rooted and the root visits they carried over (1 for each
    cold root), as Python ints.
    """
    if bs.current_player.ndim != 1:
        raise ValueError("search_batch_reuse wants a 1-D env batch")
    a_dim = board_size * board_size
    cap = num_simulations + 1 if reuse_cap is None else reuse_cap
    nodes = cap + num_simulations
    batch = bs.current_player.shape[-1]
    dev = bs.red.device
    if tuple(tree.visit.shape) != (batch, nodes):
        raise ValueError(
            "tree layout mismatch: build the carry with init_reuse_tree at the same "
            "num_simulations and reuse_cap")
    with annotate("search.root"):
        use_amask = _resolve_backup(backup, nodes)
        root_player = bs.current_player.clamp(0, 1)
        root_legal = bit_legal_mask_flat(bs, root_player, board_size).T  # [B, A]
        root_logits, root_value = evaluator(params, bs, generator)
        noise = dirichlet(generator, dirichlet_alpha, (batch, a_dim), dev)

        def mix_prior(p):
            mixed = torch.where(root_legal, (1 - dirichlet_frac) * p + dirichlet_frac * noise, 0.0)
            return mixed / mixed.sum(-1, keepdim=True).clamp_min(1e-9)

        # the cold root (search_batch's)
        fresh_prior = mix_prior(masked_policy(root_logits, root_legal))
        fresh = _init_tree(bs, batch, nodes, a_dim, root_value,
                           torch.where(root_legal, fresh_prior, -1.0), use_amask)

        # --- which envs re-root?
        iota = torch.arange(nodes, device=dev)
        played = played.long()
        kid = tree.root_child.gather(1, played.clamp(0, a_dim - 1)[:, None])[:, 0]
        desc = _descendant_mask(tree, kid, nodes, use_amask)
        k_cnt = desc.sum(-1)
        kid_ok = (kid >= 0) & ~tree.terminal.gather(1, kid.clamp_min(0)[:, None])[:, 0]
        reuse = ~was_done & (played >= 0) & kid_ok & (k_cnt <= cap)
        desc = desc & reuse[:, None]

        # --- the compaction permutation: kid -> 0, other survivors in slot
        # order; every other slot scatters into the dump column ``nodes``
        not_kid = desc & (iota[None, :] != kid[:, None])
        new_id = torch.where(iota[None, :] == kid[:, None], 0, not_kid.long().cumsum(1))
        tgt = torch.where(desc, new_id, nodes)
        oon = torch.zeros((batch, nodes + 1), dtype=_I64, device=dev).scatter_(
            1, tgt, iota.expand(batch, nodes))[:, :nodes]  # old slot of each new slot
        valid = (iota[None, :] < k_cnt[:, None]) & reuse[:, None]

        def g(arr):  # [B, nodes] permute
            return arr.gather(1, oon)

        visit_p = torch.where(valid, g(tree.visit), 0)
        vsum_p = torch.where(valid, g(tree.value_sum), 0.0)
        pa_p = torch.where(valid, g(tree.pa), 0)
        e_prior_p = torch.where(valid, g(tree.e_prior), 0.0)
        term_p = valid & g(tree.terminal)
        tval_p = torch.where(valid, g(tree.tval), 0.0)
        parent_p = torch.where(valid & (iota[None, :] > 0),
                               new_id.gather(1, g(tree.parent).clamp_min(0)), NO_NODE)
        uprior_p = torch.where(valid[:, :, None],
                               tree.uprior.gather(1, oon[:, :, None].expand(-1, -1, a_dim)), -1.0)

        # --- the new root's prior, noised again (the fresh root's mix); root
        # children scatter by action, everything else into the dump column a_dim
        up0 = uprior_p[:, 0, :]                                      # [B, A]
        child_mask = valid & (parent_p == 0) & (iota[None, :] > 0)
        col = torch.where(child_mask, pa_p, a_dim)
        pe = torch.zeros((batch, a_dim + 1), device=dev).scatter_(1, col, e_prior_p)[:, :a_dim]
        renorm = mix_prior(torch.where(up0 >= 0, up0, 0.0) + pe)
        uprior_p[:, 0, :] = torch.where(up0 >= 0, renorm, -1.0)
        e_prior_p = torch.where(child_mask, renorm.gather(1, pa_p.clamp(0, a_dim - 1)), e_prior_p)
        root_child_p = torch.full((batch, a_dim + 1), NO_NODE, dtype=_I64, device=dev).scatter_(
            1, col, iota.expand(batch, nodes))[:, :a_dim]

        # --- node states: a node-axis permute per env (batch trailing)
        def gn(buf):
            idx = oon.T.reshape((nodes,) + (1,) * (buf.ndim - 2) + (batch,))
            return buf.gather(0, idx.expand(buf.shape))

        # --- per env: the re-rooted tree where it reuses, the cold root elsewhere
        def sel_b(re_arr, fr_arr):  # batch-leading leaves
            return torch.where(reuse.reshape((batch,) + (1,) * (re_arr.ndim - 1)), re_arr, fr_arr)

        def sel_t(re_arr, fr_arr):  # batch-trailing leaves (node states)
            return torch.where(reuse.reshape((1,) * (re_arr.ndim - 1) + (batch,)), re_arr, fr_arr)

        if use_amask:
            am = tree.amask.gather(1, oon[:, :, None].expand(-1, -1, nodes))
            am = am.gather(2, oon[:, None, :].expand(-1, nodes, -1))
            amask = sel_b(am & valid[:, :, None] & valid[:, None, :], fresh.amask)
            depth_kid = tree.depth.gather(1, kid.clamp_min(0)[:, None])
            depth = sel_b(torch.where(valid, g(tree.depth) - depth_kid, 0), fresh.depth)
        else:
            amask, depth = fresh.amask, fresh.depth
        tree = Tree(
            visit=sel_b(visit_p, fresh.visit),
            value_sum=sel_b(vsum_p, fresh.value_sum),
            uprior=sel_b(uprior_p, fresh.uprior),
            parent=sel_b(parent_p, fresh.parent),
            pa=sel_b(pa_p, fresh.pa),
            e_prior=sel_b(e_prior_p, fresh.e_prior),
            terminal=sel_b(term_p, fresh.terminal),
            tval=sel_b(tval_p, fresh.tval),
            linked=sel_b(valid, fresh.linked),
            root_child=sel_b(root_child_p, fresh.root_child),
            amask=amask,
            depth=depth,
            planes=sel_t(gn(tree.planes), fresh.planes),
            compid=sel_t(gn(tree.compid), fresh.compid),
            scalars=sel_t(gn(tree.scalars), fresh.scalars),
        )
        if return_stats:
            # root visits carried over (1 for a cold root), the reuse diagnostic
            stats = {"reused_envs": int(reuse.sum()),
                     "inherited_visits": int(tree.visit[:, 0].sum())}

        # --- the budget, PUCT below the root
        simulate = _make_simulate(
            params=params, generator=generator, evaluator=evaluator,
            board_size=board_size, batch=batch, nodes=nodes, a_dim=a_dim,
            c_puct=c_puct, use_amask=use_amask, dev=dev, fresh_base=cap,
        )
    for sim in range(num_simulations):
        simulate(sim, tree)

    visit_probs, root_q = _root_result(tree, root_legal)
    if return_stats:
        return visit_probs, root_q, tree, stats
    return visit_probs, root_q, tree


def batched_search(params, states, generator, **kw):
    """Search from canonical tensor states (``ops/state.State``, trailing
    env batch): packs to BitState and runs :func:`search_batch`."""
    return search_batch(params, from_state(states), generator, **kw)
