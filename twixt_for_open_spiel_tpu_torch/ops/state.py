"""Board sizes and action codecs (``twixt_for_open_spiel_tpu/ops/state.py``).

Only the framework-neutral helpers of the JAX module: the padded board width
and the action <-> (x, y) codecs.  They work on Python ints and on integer
torch tensors alike (``//`` and ``%`` floor in both, as in jnp).  The
per-size constant boards come from ``geometry.board_masks``.
"""

from __future__ import annotations

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo


def padded_size(board_size: int) -> int:
    return board_size + 2 * geo.PAD


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
