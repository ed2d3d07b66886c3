"""TwixT game state as a fixed-shape tuple of tensors, and ``reset``
(``twixt_for_open_spiel_tpu/ops/state.py``).

The canonical state of the JAX package: struct-of-arrays over the padded
``[P, P]`` board (P = board_size + 2*PAD), the same 11 leaves in the same
field order and dtypes, so a JAX ``State`` and a port ``State`` compare leaf
by leaf.  A batch of envs appends trailing axes to every leaf (``[P, P, B]``
boards, ``[B]`` scalars).  The per-size constant boards come from
``geometry.board_masks``; the JAX module's ``board_consts`` and its
``wide``/``bshape`` arguments exist only for Mosaic and are not ported (the
int32 working layout of the fused kernel is its wrapper's business,
``ops/fused_tensor_rollout.py``).

The action codecs work on Python ints and on integer torch tensors alike
(``//`` and ``%`` floor in both, as in jnp).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo


class State(NamedTuple):
    """Complete TwixT game state; see the JAX ``State`` for each field's
    reference counterpart.

      color          int8  [P,P]   COLOR_* per cell
      links          uint8 [P,P]   bit d set => link in compass dir d
      blocked        uint8 [P,P]   bit d set => same-colour neighbour in dir d
                                   blocked by a crossing link
      compid         int16 [P,P]   link-component id (-1 on halo/corners)
      flags          uint8 [P,P]   border-connectivity bits of the component
      legal          bool  [2,P,P] per-player legal-action masks
      current_player int32 []      player to move, or TERMINAL_PLAYER_ID
      move_counter   int32 []
      move_one       int32 []      action id of the first move (-1 before it)
      swapped        bool  []
      result         int32 []      RESULT_*
    """

    color: torch.Tensor
    links: torch.Tensor
    blocked: torch.Tensor
    compid: torch.Tensor
    flags: torch.Tensor
    legal: torch.Tensor
    current_player: torch.Tensor
    move_counter: torch.Tensor
    move_one: torch.Tensor
    swapped: torch.Tensor
    result: torch.Tensor


def padded_size(board_size: int) -> int:
    return board_size + 2 * geo.PAD


def reset(board_size: int, device="cuda") -> State:
    """Start-of-game state of one env (reference Board ctor,
    twixtboard.cc:168-174), on ``device``."""
    m = geo.board_masks(board_size)
    p = padded_size(board_size)

    def board(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def scalar(v, dtype=torch.int32):
        return torch.tensor(v, dtype=dtype, device=device)

    zeros = torch.zeros((p, p), dtype=torch.uint8, device=device)
    return State(
        color=board(m["init_color"], torch.int8),
        links=zeros,
        blocked=zeros.clone(),
        compid=board(m["init_compid"], torch.int16),
        flags=board(m["init_flags"], torch.uint8),
        legal=board(np.stack([m["legal0"], m["legal1"]]), torch.bool),
        current_player=scalar(geo.RED),
        move_counter=scalar(0),
        move_one=scalar(-1),
        swapped=scalar(False, torch.bool),
        result=scalar(geo.RESULT_OPEN),
    )


def state_digest(leaves) -> str:
    """sha256 of every leaf in order, cast to int64 (little-endian), C
    order.  Values, not dtypes, enter the digest, so a JAX state carried
    over as numpy digests the same as the port's."""
    h = hashlib.sha256()
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().to("cpu", torch.int64).contiguous().numpy()
        h.update(np.ascontiguousarray(leaf, dtype="<i8").tobytes())
    return h.hexdigest()


def action_to_xy(action, board_size: int):
    """Action id -> (x, y) board coords (reference twixtboard.cc:599-601)."""
    return action // board_size, action % board_size


def xy_to_action(x, y, board_size: int):
    """(x, y) -> action id (reference twixtboard.cc:603-605)."""
    return x * board_size + y


def swap_rotate_action(action, board_size: int):
    """90-degree clockwise rotation applied on swap
    (reference twixtboard.cc:470-473): (x, y) -> (y, size-1-x)."""
    x, y = action_to_xy(action, board_size)
    return xy_to_action(y, board_size - 1 - x, board_size)


def onehot_board(action: torch.Tensor, board_size: int) -> torch.Tensor:
    """Bool [P, P, *B] mask, True exactly at each env's action cell
    (``action`` int [*B])."""
    p = padded_size(board_size)
    x, y = action_to_xy(action, board_size)
    tail = (1,) * x.ndim
    xs = torch.arange(p, device=x.device).reshape((p, 1) + tail)
    ys = torch.arange(p, device=x.device).reshape((1, p) + tail)
    return (xs == x + geo.PAD) & (ys == y + geo.PAD)


def legal_mask_flat(state: State, player, board_size: int) -> torch.Tensor:
    """Legal mask over the ``size*size`` action space, ascending action
    order (row-major over (x, y), the reference's insertion order,
    twixtboard.cc:260-275): bool [size*size, *B].  ``player`` is an int
    or an int tensor [*B]."""
    pad = geo.PAD
    legal = state.legal
    if isinstance(player, int):
        sel = legal[player]
    else:
        sel = torch.where(torch.as_tensor(player, device=legal.device) == 0,
                          legal[0], legal[1])
    core = sel[pad : pad + board_size, pad : pad + board_size]
    return core.reshape((board_size * board_size,) + tuple(core.shape[2:]))
