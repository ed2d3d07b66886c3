"""Branch-free TwixT state transition on the canonical state
(``twixt_for_open_spiel_tpu/ops/step.py``).

The same whole-board tensor algebra as the JAX module, in plain torch:
the action becomes a one-hot board, the 8 neighbour and 72 crossing-link
probes are static shifts of whole boards (``geometry.CROSSERS``), and the
connectivity is the O(1)-merge union-find on ``compid`` (component id =
the smallest peg index of the component, merged flag byte stamped on every
member).  Every function takes trailing env batch axes (``[P, P, *B]``
boards, ``[*B]`` scalars); reductions run over axes (0, 1).

``step`` assumes ``action`` is legal for ``state.current_player`` and the
state is not terminal, as the JAX ``step`` does (``rollout.step_auto_reset``
handles terminal states in batched rollouts).

Reference semantics (the same lines as the JAX module): swap rule
twixtboard.cc:450-499, SetPegAndLinks twixtboard.cc:501-571, win/draw
twixtboard.cc:192-207, turn logic twixt.h:93-104.
"""

from __future__ import annotations

import torch

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.state import (
    State,
    onehot_board,
    swap_rotate_action,
)

_I32 = torch.int32
_BIG = 1 << 20  # sentinel above any component id


def _shift(arr: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[x, y] = arr[x + dx, y + dy] (static shift, wrap-around).  Every
    use is masked to cells whose source lies inside the PAD halo, where the
    wrap never shows."""
    return torch.roll(arr, shifts=(-dx, -dy), dims=(0, 1))


def _link_updates(color, links, me, player_c):
    """New link / blocked bits from placing a peg at ``me`` (vectorised
    SetPegAndLinks).  All 8 directions probe the pre-move ``links``; bits
    land on both endpoints."""
    new_links = torch.zeros_like(links)
    new_blocked = torch.zeros_like(links)
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        same = me & (_shift(color, dx, dy) == player_c)
        crossed = torch.zeros_like(me)
        for ox, oy, d2 in geo.CROSSERS[d]:
            probe = (_shift(links, int(ox), int(oy)) >> int(d2)) & 1
            crossed = crossed | (probe != 0)
        linked = same & ~crossed
        blocked = same & crossed
        od = geo.opp_dir(d)
        new_links = new_links | (linked.to(links.dtype) << d)
        new_links = new_links | (_shift(linked, -dx, -dy).to(links.dtype) << od)
        new_blocked = new_blocked | (blocked.to(links.dtype) << d)
        new_blocked = new_blocked | (_shift(blocked, -dx, -dy).to(links.dtype) << od)
    return new_links, new_blocked


def _board_max(x: torch.Tensor) -> torch.Tensor:
    """Max over the two board axes: [P, P, *B] -> [*B]."""
    return x.flatten(0, 1).amax(dim=0)


def _merge_components(compid, flags, me, eff, new_links):
    """Union the <= 8 components newly linked to the placed peg; returns
    (compid, flags, merged flag byte [*B])."""
    acc = flags
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        has_new = ((new_links >> d) & 1) != 0
        acc = acc | torch.where(has_new, _shift(flags, dx, dy), 0)
    # the merged flag byte: a masked max in int32, as in JAX
    nf = _board_max(torch.where(me, acc.to(_I32), 0)).to(flags.dtype)

    # the <= 8 neighbour component ids, -1 for "no new link"
    compid32 = compid.to(_I32)
    neighbor_ids = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        has_new = ((new_links >> d) & 1) != 0
        neighbor_ids.append(
            _board_max(torch.where(me & has_new, _shift(compid32, dx, dy), -1))
        )

    nid = eff.to(_I32)  # the peg's own action index
    for cid in neighbor_ids:
        nid = torch.minimum(nid, torch.where(cid >= 0, cid, _BIG))

    hit = me
    for cid in neighbor_ids:
        # cid >= 0: an unlinked direction's -1 must not match the halo's -1
        hit = hit | ((compid32 == cid) & (cid >= 0))
    compid = torch.where(hit, nid.to(compid.dtype), compid)
    flags = torch.where(hit, nf, flags)
    return compid, flags, nf


def step(state: State, board_size: int, action) -> State:
    """Apply ``action`` (int [*B]) for ``state.current_player``; returns the
    next state.  Mirrors Board::ApplyAction + TwixTState::DoApplyAction,
    including the swap rule and move one staying legal for one ply."""
    player = state.current_player
    player_c = player.to(state.color.dtype)
    mc = state.move_counter
    action = torch.as_tensor(action, dtype=_I32, device=player.device)

    is_swap = (mc == 1) & (action == state.move_one)

    # swap: undo move one (UndoFirstMove, twixtboard.cc:450-455).  The first
    # peg has no links and a singleton component, so clearing its colour is
    # a complete undo; the legal masks are untouched at move 2.
    m_one = onehot_board(state.move_one, board_size)
    color = torch.where(is_swap & m_one, geo.COLOR_EMPTY, state.color).to(
        state.color.dtype
    )

    # effective position: rotated on swap (twixtboard.cc:470-473)
    eff = torch.where(is_swap, swap_rotate_action(action, board_size), action)
    me = onehot_board(eff, board_size)

    # move 2 without swap: move one leaves both legal sets
    rm_one = ((mc == 1) & ~is_swap) & m_one
    legal = state.legal & ~rm_one.unsqueeze(0)

    # place the peg, create links / blocked bits
    color = torch.where(me, player_c, color)
    new_links, new_blocked = _link_updates(color, state.links, me, player_c)
    links = state.links | new_links
    blocked = state.blocked | new_blocked

    compid, flags, nf = _merge_components(
        state.compid, state.flags, me, eff, new_links
    )

    # legal bookkeeping: move one is remembered but stays legal for one ply
    legal = torch.where(mc == 0, legal, legal & ~me.unsqueeze(0))
    move_one = torch.where(mc == 0, eff, state.move_one)

    # result (UpdateResult, twixtboard.cc:192-207)
    shift = player * 2
    nf32 = nf.to(_I32)
    win = (((nf32 >> shift) & 1) != 0) & (((nf32 >> (shift + 1)) & 1) != 0)
    opp = 1 - player
    opp_legal = torch.where(opp == 0, legal[0], legal[1])
    opp_has_legal = _board_max(opp_legal.to(_I32)) != 0
    result = torch.where(
        win,
        geo.RESULT_RED_WIN + player,
        torch.where(opp_has_legal, geo.RESULT_OPEN, geo.RESULT_DRAW).to(_I32),
    )
    current_player = torch.where(
        result == geo.RESULT_OPEN, opp, geo.TERMINAL_PLAYER_ID
    )

    return State(
        color=color,
        links=links,
        blocked=blocked,
        compid=compid,
        flags=flags,
        legal=legal,
        current_player=current_player,
        move_counter=mc + 1,
        move_one=move_one,
        swapped=state.swapped | is_swap,
        result=result,
    )


def returns(state: State) -> torch.Tensor:
    """Terminal returns, float32 [2, *B] (TwixTState::Returns, twixt.h:50-63)."""
    r = state.result
    red = torch.where(
        r == geo.RESULT_RED_WIN,
        1.0,
        torch.where(r == geo.RESULT_BLUE_WIN, -1.0, 0.0),
    ).to(torch.float32)
    return torch.stack([red, -red])


def is_terminal(state: State) -> torch.Tensor:
    """TwixTState::IsTerminal (twixt.h:45-48)."""
    return state.result != geo.RESULT_OPEN
