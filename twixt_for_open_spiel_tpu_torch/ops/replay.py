"""Batched history replay: reconstruct many states from action sequences
(``twixt_for_open_spiel_tpu/ops/replay.py``).

History replay is the canonical checkpoint/restore path of the reference
(any state is reconstructible from its action sequence — ``History()``,
reference playthrough.txt:674 and twixt.h:80-84); this module does it for a
whole batch of (padded) histories in one lockstep loop over time on the
bitboard engine.  JAX runs the loop as a ``fori_loop`` that XLA compiles;
here it is a host loop of plain torch ops on the actions' device.

Also the engine-vs-engine soak harness: trajectories generated by the
native C host engine replay through this path and must land on identical
states.
"""

from __future__ import annotations

import numpy as np
import torch

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    BitState,
    bit_reset,
    bitstate_from_leaves,
    bitstate_leaves,
    step_bits,
)


@torch.no_grad()
def bit_replay(board_size: int, actions, *, device="cuda") -> BitState:
    """Replay padded action histories; returns the final batched BitState.

    ``actions`` is int [T, B]: column b is game b's history, padded at the
    tail with any negative value.  Padding steps (and steps after a game
    reached a terminal state) leave the state untouched, so ragged
    histories replay in one lockstep loop.  Those columns still step on
    action 0, a corner that is never legal, and the result is thrown away.
    The env batch lives on a tensor's own device; an array or a list goes
    to ``device``.
    """
    if not isinstance(actions, torch.Tensor):
        actions = torch.as_tensor(np.asarray(actions), device=device)
    _, batch = actions.shape
    bs = bit_reset(board_size, batch, actions.device)
    for a in actions.to(torch.int32):
        valid = (a >= 0) & (bs.result == geo.RESULT_OPEN)
        nxt = step_bits(bs, board_size, a.clamp(min=0))
        bs = bitstate_from_leaves(
            torch.where(valid, new, old)
            for new, old in zip(bitstate_leaves(nxt), bitstate_leaves(bs))
        )
    return bs
