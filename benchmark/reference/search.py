"""The plain PUCT search of the self-play cell, and the draws of its
random stream: the benchmark's frozen copy of the port's plain versions
(the slot step, the selection walk, the ancestor-mask backup, the masked
prior, the Dirichlet root noise and the Gumbel-max draw of a ply).  It
imports nothing of the port.

``search`` takes the root noise as an input, so the same noise can be
handed to it that the program drew: :func:`ply_draws` replays one ply's
draws from a ``torch.Generator`` in the order the self-play ply makes them
(the root's Dirichlet noise, then the exponential draws of the move).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import engine
from benchmark.reference.engine import BitState, bit_legal_mask_flat, step_bits_reference

_I32 = torch.int32
_I64 = torch.int64


def stack_planes(bs: BitState) -> torch.Tensor:
    return torch.stack((bs.red, bs.blue) + bs.links + bs.blocked + bs.legal + bs.flags)


def stack_scalars(bs: BitState) -> torch.Tensor:
    return torch.stack([bs.current_player, bs.move_counter, bs.move_one,
                        bs.swapped, bs.result])


def slot_state(planes, compid, scalars) -> BitState:
    """The BitState of one slot's buffers ([16, P, ...], [n, n, ...], [5, ...]),
    as views."""
    return BitState(
        red=planes[0],
        blue=planes[1],
        links=tuple(planes[2 + i] for i in range(4)),
        blocked=tuple(planes[6 + i] for i in range(4)),
        legal=(planes[10], planes[11]),
        flags=tuple(planes[12 + i] for i in range(4)),
        compid=compid,
        current_player=scalars[0],
        move_counter=scalars[1],
        move_one=scalars[2],
        swapped=scalars[3],
        result=scalars[4],
    )


def gather_slots(bufs: tuple, slot: torch.Tensor) -> BitState:
    """Per-env slot state: [S, ..., B] buffers x slot [B] -> [..., B], a
    per-element gather of each env's slot."""
    def leaf(buf):
        idx = slot.reshape((1,) * (buf.ndim - 1) + slot.shape)
        return buf.gather(0, idx.expand((1,) + buf.shape[1:]))[0]

    return slot_state(*(leaf(buf) for buf in bufs))


def outcome_value(result: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """+1 if ``player`` won, 0 on a draw, -1 otherwise (float32)."""
    return torch.where(
        result == engine.RESULT_RED_WIN + player, 1.0,
        torch.where(result == engine.RESULT_DRAW, 0.0, -1.0),
    )


def expand(bufs: tuple, src_slot, action, dst_slot: int, board_size: int, outcome):
    """The expansion: gather each env's source slot, step it, write slot
    ``dst_slot`` of ``bufs`` and of ``outcome``'s rows (the child's terminal
    flag and its value from the parent's mover's view); returns the new
    mover's legal mask, bool [B, n*n]."""
    parent = gather_slots(bufs, src_slot)
    child = step_bits_reference(parent, board_size, action)
    planes, compid, scalars = bufs
    planes[dst_slot] = stack_planes(child)
    compid[dst_slot] = child.compid
    scalars[dst_slot] = stack_scalars(child)
    terminal, tval = outcome
    child_terminal = child.result != engine.RESULT_OPEN
    mover = parent.current_player.clamp(0, 1)
    terminal[:, dst_slot] = child_terminal
    tval[:, dst_slot] = torch.where(child_terminal, outcome_value(child.result, mover), 0.0)
    return bit_legal_mask_flat(child, child.current_player.clamp(0, 1), board_size).T


NO_NODE = -1


def best_edge(tree, env: torch.Tensor, node: torch.Tensor, c_puct: float):
    """Best PUCT edge at each env's ``node``: (action, kid, kid_term).

    ``kid`` is the chosen child slot (-1 when the best edge is unexpanded);
    ``kid_term`` marks a chosen terminal child.  Expanded edges are scored
    child-side: one ``[B, nodes]`` pass masks the slots whose ``parent`` is
    the current node.
    """
    up_row = tree.uprior[env, node]                            # [B, A]
    tot = tree.visit[env, node]
    sq = torch.sqrt(tot.clamp_min(1).float())                  # [B]

    # unexpanded edges: masked prior row (-1 = illegal or expanded); the
    # first of equal scores is the lowest action
    sc_u = torch.where(up_row >= 0, c_puct * up_row * sq[:, None], -math.inf)
    bu_s = sc_u.amax(-1)
    bu_a = sc_u.argmax(-1)

    # expanded edges, child-side over all node slots; ties go to the lowest
    # slot (creation order)
    valid = tree.linked & (tree.parent == node[:, None])      # [B, nodes]
    # child value stored from the child's mover's perspective; the parent
    # wants -Q; terminal children hold their exact value for the parent
    q = torch.where(
        tree.terminal, tree.tval,
        -tree.value_sum / tree.visit.clamp_min(1).float(),
    )
    u = c_puct * tree.e_prior * sq[:, None] / (1.0 + tree.visit.float())
    sc_c = torch.where(valid, q + u, -math.inf)
    bc_s = sc_c.amax(-1)
    c_star = sc_c.argmax(-1)
    bc_a = tree.pa[env, c_star]
    bc_t = tree.terminal[env, c_star]

    # a tie between an expanded and an unexpanded edge goes to the lower action
    expanded_wins = (bc_s > bu_s) | ((bc_s == bu_s) & (bc_a < bu_a))
    action = torch.where(expanded_wins, bc_a, bu_a)
    kid = torch.where(expanded_wins, c_star, NO_NODE)
    kid_term = expanded_wins & bc_t
    return action, kid, kid_term


def root_entry(tree, c_puct: float):
    """The PUCT root entry: the best edge at slot 0 of every env."""
    batch = tree.visit.shape[0]
    dev = tree.visit.device
    node0 = torch.zeros(batch, dtype=_I64, device=dev)
    return best_edge(tree, torch.arange(batch, device=dev), node0, c_puct)


def select_walk(tree, c_puct: float):
    """The selection: the root's best edge, then every env walks down in
    lockstep until its best edge is unexpanded or leads to a terminal
    child, one host read an iteration.  Returns (leaf_parent, action,
    existing_kid)."""
    action, kid, kid_term = root_entry(tree, c_puct)
    batch = kid.shape[0]
    dev = kid.device
    env = torch.arange(batch, device=dev)
    node = torch.zeros(batch, dtype=_I64, device=dev)
    can = torch.ones(batch, dtype=torch.bool, device=dev)
    while True:
        descend = can & (kid >= 0) & ~kid_term
        node = torch.where(descend, kid.clamp_min(0), node)
        a, k, kt = best_edge(tree, env, node, c_puct)
        action = torch.where(descend, a, action)
        kid = torch.where(descend, k, kid)
        kid_term = torch.where(descend, kt, kid_term)
        can = descend
        if not bool(can.any()):
            break
    return node, action, kid



def masked_policy(logits, legal_mask):
    """Softmax over legal actions only (illegal logits become -1e9):
    ``exp(x - max) / sum``."""
    x = torch.where(legal_mask, logits, torch.full_like(logits, -1e9))
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def categorical(exp_draws, logits):
    """One draw per row from softmax(logits) by Gumbel-max, from the
    exponential draws ``exp_draws``; actions at -inf are never drawn."""
    return torch.where(logits == -torch.inf, logits, logits - exp_draws.log()).argmax(-1)


def log_gamma(generator, alpha: float, shape, device) -> torch.Tensor:
    """log of Gamma(alpha, 1) draws, float32: Marsaglia and Tsang's
    rejection at shape alpha (alpha + 1 below 1, then scaled by
    U**(1/alpha)), redrawn until every element is accepted."""
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


def ply_draws(generator, batch: int, a_dim: int, alpha: float, device):
    """One self-play ply's draws, in the order the ply makes them: the
    root's symmetric Dirichlet(alpha) noise [B, A] (gamma draws normalised
    in log space), then the move's exponential draws [B, A], drawn in the
    layout the ply's move logits have."""
    noise = torch.softmax(log_gamma(generator, alpha, (batch, a_dim), device), dim=-1)
    # the ply's move logits lie action-major in memory (its legal mask is
    # the engine's [A, B] mask transposed), and the draws fill memory order
    exp_draws = torch.empty((a_dim, batch), dtype=torch.float32,
                            device=device).exponential_(generator=generator).T
    return noise, exp_draws


class Tree(NamedTuple):
    """Flat search trees for a batch of roots (batch-leading stats; node
    states stacked on a leading ``[nodes]`` axis over the engine's
    batch-trailing layout)."""

    visit: torch.Tensor      # int32 [B, nodes]
    value_sum: torch.Tensor  # f32 [B, nodes]
    uprior: torch.Tensor     # f32 [B, nodes, A] masked prior (-1 = dead)
    parent: torch.Tensor     # int64 [B, nodes]
    pa: torch.Tensor         # int64 [B, nodes] action taken at the parent
    e_prior: torch.Tensor    # f32 [B, nodes] prior of the edge into a node
    terminal: torch.Tensor   # bool [B, nodes]
    tval: torch.Tensor       # f32 [B, nodes] a terminal node's value, parent's view
    linked: torch.Tensor     # bool [B, nodes] slot actually in the tree
    root_child: torch.Tensor  # int64 [B, A] child node id of root edges / -1
    amask: torch.Tensor      # bool [B, nodes, nodes] root-path sets
    depth: torch.Tensor      # int32 [B, nodes]
    planes: torch.Tensor     # int32 [nodes, 16, P, B]
    compid: torch.Tensor     # int16 [nodes, N, N, B]
    scalars: torch.Tensor    # int32 [nodes, 5, B]


def _init_tree(bs: BitState, nodes: int, a_dim: int, root_value, root_uprior) -> Tree:
    batch = bs.current_player.shape[-1]
    dev = bs.red.device

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def alloc(x):
        return x.unsqueeze(0).expand((nodes,) + x.shape).clone()

    amask = full((batch, nodes, nodes), False, torch.bool)
    amask[:, 0, 0] = True
    visit = full((batch, nodes), 0, _I32)
    visit[:, 0] = 1
    value_sum = full((batch, nodes), 0.0, torch.float32)
    value_sum[:, 0] = root_value
    uprior = full((batch, nodes, a_dim), -1.0, torch.float32)
    uprior[:, 0] = root_uprior
    linked = full((batch, nodes), False, torch.bool)
    linked[:, 0] = True
    return Tree(
        visit=visit, value_sum=value_sum, uprior=uprior,
        parent=full((batch, nodes), NO_NODE, _I64), pa=full((batch, nodes), 0, _I64),
        e_prior=full((batch, nodes), 0.0, torch.float32),
        terminal=full((batch, nodes), False, torch.bool),
        tval=full((batch, nodes), 0.0, torch.float32), linked=linked,
        root_child=full((batch, a_dim), NO_NODE, _I64), amask=amask,
        depth=full((batch, nodes), 0, _I32),
        planes=alloc(stack_planes(bs)), compid=alloc(bs.compid), scalars=alloc(stack_scalars(bs)),
    )


def observation(bs: BitState, board_size: int) -> torch.Tensor:
    """The net's input, float32 [B, 12, n, n-2], from the packed planes."""
    pk = engine.bit_observation_packed_lanes(bs, board_size).permute(2, 0, 1)
    return engine.unpack_observation_nchw(pk, board_size)


@torch.no_grad()
def search(net, bs: BitState, noise, *, board_size: int, num_simulations: int,
           dirichlet_frac: float, c_puct: float = 1.4):
    """PUCT from a batch of non-terminal roots (1-D batch) with the root
    noise ``noise`` [B, A] mixed into the prior at ``dirichlet_frac``;
    ``net(obs) -> (logits [B, A], value [B])``.  The ancestor-mask backup,
    one visit a simulation.  Returns the root's visit distribution [B, A]."""
    a_dim = board_size * board_size
    nodes = num_simulations + 1
    batch = bs.current_player.shape[-1]
    dev = bs.red.device
    root_legal = bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), board_size).T
    root_logits, root_value = net(observation(bs, board_size))
    root_prior = masked_policy(root_logits, root_legal)
    root_prior = torch.where(root_legal, (1 - dirichlet_frac) * root_prior + dirichlet_frac * noise,
                             0.0)
    root_prior = root_prior / root_prior.sum(-1, keepdim=True).clamp_min(1e-9)
    tree = _init_tree(bs, nodes, a_dim, root_value, torch.where(root_legal, root_prior, -1.0))
    env = torch.arange(batch, device=dev)
    iota_a = torch.arange(a_dim, device=dev)
    iota_n = torch.arange(nodes, device=dev)
    bufs = (tree.planes, tree.compid, tree.scalars)
    for sim in range(num_simulations):
        new_node = 1 + sim
        leaf_parent, action, existing_kid = select_walk(tree, c_puct)
        revisit = existing_kid >= 0
        child_legal = expand(bufs, leaf_parent, action, new_node, board_size,
                             (tree.terminal, tree.tval))
        child = slot_state(tree.planes[new_node], tree.compid[new_node], tree.scalars[new_node])
        child_terminal = tree.terminal[:, new_node]
        logits, value = net(observation(child, board_size))
        prior = masked_policy(logits, child_legal)
        # a terminal child's value is its parent's, so negated for the child
        backup_value = torch.where(child_terminal, -tree.tval[:, new_node], value)
        node_id = torch.where(revisit, existing_kid, new_node)
        e_prior_new = tree.uprior[env, leaf_parent, action]
        tree.amask[:, new_node] = tree.amask[env, leaf_parent] | (iota_n == new_node)
        tree.depth[:, new_node] = tree.depth[env, leaf_parent] + 1
        tree.uprior[env, leaf_parent, action] = -1.0
        tree.uprior[:, new_node] = torch.where(child_legal, prior, -1.0)
        tree.parent[:, new_node] = leaf_parent
        tree.pa[:, new_node] = action
        tree.e_prior[:, new_node] = e_prior_new
        tree.linked[:, new_node] = ~revisit
        root_edge = (~revisit & (leaf_parent == 0))[:, None] & (action[:, None] == iota_a)
        tree.root_child.masked_fill_(root_edge, new_node)
        # values alternate sign a level, +backup_value at the leaf
        path = tree.amask[env, node_id]
        sign = 1.0 - 2.0 * ((tree.depth[env, node_id][:, None] - tree.depth) & 1).float()
        tree.visit.add_(path.to(_I32))
        tree.value_sum.add_(torch.where(path, backup_value[:, None] * sign, 0.0))
    kid = tree.root_child
    visits = torch.where(kid >= 0, tree.visit.gather(1, kid.clamp_min(0)), 0)
    visits = torch.where(root_legal, visits, 0)
    return visits.float() / visits.sum(-1, keepdim=True).clamp_min(1).float()
