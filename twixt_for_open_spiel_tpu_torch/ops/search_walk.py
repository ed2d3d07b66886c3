"""The batched search's two walks in CUDA kernels, and their plain versions:
the lockstep PUCT selection (:func:`select_walk`, S1b), from a root entry
or from the root's own best edge, and the parent-chain backup
(:func:`backup_walk`, S1c), both in ``csrc/search.cu``.

The JAX search runs each walk as a ``lax.while_loop`` inside its jitted
simulation (``twixt_for_open_spiel_tpu/models/mcts.py:368`` and ``:511``),
its PUCT root entry as ``_best_edge`` at slot 0 (``:672``).  The plain
versions here are host loops of torch ops that read the device once an
iteration (``any()``); the kernels run each walk in one launch and read
nothing back, so a simulation on the card makes no host read.

Both take the search's ``Tree`` (``models/mcts.py``; any object with its
fields): ``uprior`` f32 [B, nodes, A], ``visit`` int32, ``value_sum`` f32,
``parent`` and ``pa`` int64, ``e_prior`` f32, ``terminal`` bool, ``tval``
f32 and ``linked`` bool [B, nodes].  ``iters``, an int32 0-dim tensor (a
slot of a per-simulation counter), takes the maximum of itself and the
walk's lockstep iteration count: what the plain loop counts.

Dispatch by the tensors' device, with no fallback: CPU tensors run the
plain version; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.utils.profiling import annotate

NO_NODE = -1
_I32 = torch.int32
_I64 = torch.int64
_SLOT_FIELDS = {"visit": _I32, "value_sum": torch.float32, "parent": _I64, "pa": _I64,
                "e_prior": torch.float32, "terminal": torch.bool, "tval": torch.float32,
                "linked": torch.bool}
# the launchers' return code where one env's staged rows do not fit a
# block's shared memory (csrc/search.cu's TOO_MANY_SLOTS; the kernels' layout
# and the device's limit decide it there)
TOO_MANY_SLOTS = -1


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


def _raise_count(iters, count) -> None:
    if iters is not None:
        iters.copy_(torch.maximum(iters, torch.as_tensor(count, dtype=_I32,
                                                         device=iters.device)))


def select_walk_reference(tree, action, kid, kid_term, c_puct: float, iters=None):
    """The plain torch version of :func:`select_walk`: the root entry
    (:func:`root_entry` when ``action`` is None), then every env walks down
    in lockstep until its best edge is unexpanded or leads to a terminal
    child, one host read an iteration; the first iteration runs
    unconditionally, as the JAX loop's first test always holds."""
    if action is None:
        action, kid, kid_term = root_entry(tree, c_puct)
    batch = kid.shape[0]
    dev = kid.device
    env = torch.arange(batch, device=dev)
    node = torch.zeros(batch, dtype=_I64, device=dev)
    can = torch.ones(batch, dtype=torch.bool, device=dev)
    steps = 0
    while True:
        descend = can & (kid >= 0) & ~kid_term
        node = torch.where(descend, kid.clamp_min(0), node)
        a, k, kt = best_edge(tree, env, node, c_puct)
        action = torch.where(descend, a, action)
        kid = torch.where(descend, k, kid)
        kid_term = torch.where(descend, kt, kid_term)
        can = descend
        steps += 1
        if not bool(can.any()):
            break
    _raise_count(iters, steps)
    return node, action, kid


def select_walk(tree, action, kid, kid_term, c_puct: float, iters=None):
    """The PUCT selection: from each env's root entry (``action`` int64 [B],
    ``kid`` int64 [B] its child slot or -1, ``kid_term`` bool [B]; all three
    None for the best edge at slot 0, :func:`root_entry`), walk down while
    the chosen child exists and is not terminal, taking the best edge
    (:func:`best_edge`) at each node.  Returns ``(leaf_parent, action,
    existing_kid)``, int64 [B]: the node the walk stopped at, its chosen
    edge and that edge's child (-1 when unexpanded; else a terminal
    child)."""
    device = tree.visit.device
    with annotate("op.select_walk"):
        if device.type == "cpu":
            return select_walk_reference(tree, action, kid, kid_term, c_puct, iters)
        if device.type != "cuda":
            raise ValueError(f"select_walk: no kernel for device {device}")
        return _launch_select(tree, action, kid, kid_term, c_puct, iters)


select_walk.launches = 0  # kernel launches, counted by _launch_select


def backup_walk_reference(tree, node, value, iters=None) -> None:
    """The plain torch version of :func:`backup_walk`: the lockstep walk up
    the parent chains, one host read an iteration, until every env's walk
    has passed its root."""
    env = torch.arange(node.shape[0], device=node.device)
    v, steps = value, 0
    while True:
        live = node >= 0
        idx = node.clamp_min(0)
        tree.visit[env, idx] += live.to(_I32)
        tree.value_sum[env, idx] += torch.where(live, v, 0.0)
        node = torch.where(live, tree.parent[env, idx], NO_NODE)
        v = -v
        steps += 1
        if not bool((node >= 0).any()):
            break
    _raise_count(iters, steps)


def backup_walk(tree, node, value, iters=None) -> None:
    """Back ``value`` (f32 [B], from the perspective of the player to move at
    ``node``) up from each env's ``node`` (int64 [B], >= 0) to its root: a
    visit and the value, negated at each level, added to every node of the
    path, in place in ``tree.visit`` and ``tree.value_sum``; and +0.0 added
    at slot 0 of every env whose walk is shorter than the longest, as the
    lockstep loop does."""
    device = node.device
    if device.type == "cpu":
        return backup_walk_reference(tree, node, value, iters)
    if device.type != "cuda":
        raise ValueError(f"backup_walk: no kernel for device {device}")
    return _launch_backup(tree, node, value, iters)


backup_walk.launches = 0  # kernel launches, counted by _launch_backup


def _check_tree(tree, device, fields) -> tuple:
    """(batch, nodes, a_dim) of a tree the kernels take; raise otherwise."""
    batch, nodes = tree.visit.shape
    a_dim = tree.uprior.shape[-1]
    want = {name: ((batch, nodes), dtype) for name, dtype in _SLOT_FIELDS.items()}
    want["uprior"] = ((batch, nodes, a_dim), torch.float32)
    for name in fields:
        buf = getattr(tree, name)
        shape, dtype = want[name]
        if (tuple(buf.shape), buf.dtype) != (shape, dtype):
            raise ValueError(f"tree.{name}: want shape {shape} dtype {dtype}, got "
                             f"{tuple(buf.shape)} {buf.dtype}")
        if buf.device != device or not buf.is_contiguous():
            raise ValueError(f"tree.{name}: want a contiguous tensor on {device}")
    return batch, nodes, a_dim


def _env_vector(x, batch: int, dtype, device, what: str) -> torch.Tensor:
    if tuple(x.shape) != (batch,) or x.dtype != dtype or x.device != device:
        raise ValueError(f"{what}: want {dtype} [{batch}] on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def _iters_ptr(iters, device):
    if iters is None:
        return None
    if iters.shape != () or iters.dtype != _I32 or iters.device != device:
        raise ValueError(f"iters: want an int32 0-dim tensor on {device}")
    return iters.data_ptr()


@functools.cache
def _kernels():
    lib = _cuda.load("search")
    select = lib.twixt_select_walk
    select.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p]
    select.restype = ctypes.c_int
    backup = lib.twixt_backup_walk
    backup.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    backup.restype = ctypes.c_int
    return select, backup


# the backup kernel's scratch a (device, stream): int32 [2 + B], its counters
# zeroed once here and by the last block of every launch after; launches on
# one stream run in order, so none finds another's counters set
_SCRATCH: dict = {}


def _backup_scratch(device, stream: int, batch: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < 2 + batch:
        buf = _SCRATCH[key] = torch.zeros(2 + batch, dtype=_I32, device=device)
    return buf


def _check_rc(rc: int, what: str, nodes: int) -> None:
    if rc == TOO_MANY_SLOTS:
        raise ValueError(f"{what}: {nodes} slots: one env's staged rows do not fit a block's "
                         "shared memory")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: " + _cuda.error_string("search", rc))


def _launch_select(tree, action, kid, kid_term, c_puct, iters):
    device = tree.visit.device
    fields = ("uprior", *_SLOT_FIELDS)
    batch, nodes, a_dim = _check_tree(tree, device, fields)
    if action is None:
        entry = (None, None, None)
    else:
        action = _env_vector(action, batch, _I64, device, "action")
        kid = _env_vector(kid, batch, _I64, device, "kid")
        kid_term = _env_vector(kid_term, batch, torch.bool, device, "kid_term")
        entry = (action.data_ptr(), kid.data_ptr(), kid_term.data_ptr())
    out = torch.empty((3, batch), dtype=_I64, device=device)
    with torch.cuda.device(device):
        rc = _kernels()[0](
            *(getattr(tree, name).data_ptr() for name in fields), *entry,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            _iters_ptr(iters, device), c_puct, nodes, a_dim, batch,
            torch.cuda.current_stream(device).cuda_stream,
        )
        _check_rc(rc, "select_walk", nodes)
        select_walk.launches += 1
    return out[0], out[1], out[2]


def _launch_backup(tree, node, value, iters):
    device = node.device
    batch, nodes, _ = _check_tree(tree, device, ("visit", "value_sum", "parent"))
    node = _env_vector(node, batch, _I64, device, "node")
    value = _env_vector(value, batch, torch.float32, device, "value")
    iters_ptr = _iters_ptr(iters, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        scratch = _backup_scratch(device, stream, batch)
        rc = _kernels()[1](
            tree.visit.data_ptr(), tree.value_sum.data_ptr(), tree.parent.data_ptr(),
            node.data_ptr(), value.data_ptr(), scratch.data_ptr(), iters_ptr, nodes, batch,
            stream,
        )
        _check_rc(rc, "backup_walk", nodes)
        backup_walk.launches += 1
