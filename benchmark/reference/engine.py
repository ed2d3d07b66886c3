"""The plain TwixT bitboard engine, the learner wire and its decoders: the
benchmark's frozen copy of the port's plain torch versions (its geometry
tables, ``reset``, ``step_bits_reference``, the counter-hash sampler and
the packed observation wire with the mover's legal plane).  It imports
nothing of the port, so a change to the port cannot move the yardstick.

Shapes: planes ``[P, B]`` int32 (P = n + 2*PAD), ``compid`` ``[n, n, B]``
int16, scalars ``[B]`` int32; one trailing env axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_I32 = torch.int32
_I64 = torch.int64
NUM_LEAVES = 22  # red/blue, 4 links, 4 blocked, 2 legal, 4 flags, compid, 5 scalars


# --- players / colors / results (reference twixtcell.h:50-54, twixtboard.h:44-50)
RED = 0
BLUE = 1

COLOR_RED = 0
COLOR_BLUE = 1
COLOR_EMPTY = 2
COLOR_OFFBOARD = 3

RESULT_OPEN = 0
RESULT_RED_WIN = 1
RESULT_DRAW = 3

BORDER_START = 0
BORDER_END = 1

TERMINAL_PLAYER_ID = -4  # OpenSpiel kTerminalPlayerId

# Halo width of the padded board arrays.  Every offset used by the engine
# (knight-move targets: |d| <= 2; crossing-link origins: |d| <= 3) stays
# inside the halo, so shifted reads never go out of bounds.
PAD = 3

# --- the 8 knight-move link directions (reference twixtcell.h:58-68)
NUM_DIRS = 8
NNE, ENE, ESE, SSE, SSW, WSW, WNW, NNW = range(8)

# (dx, dy) per direction, index == Compass value.
OFFSETS = np.array(
    [
        [1, 2],    # NNE
        [2, 1],    # ENE
        [2, -1],   # ESE
        [1, -2],   # SSE
        [-1, -2],  # SSW
        [-2, -1],  # WSW
        [-2, 1],   # WNW
        [-1, 2],   # NNW
    ],
    dtype=np.int32,
)

def _cross(ox, oy, px, py) -> int:
    return ox * py - oy * px


def _segments_properly_intersect(a, b, c, d) -> bool:
    """True iff open segments ab and cd intersect (strict crossing).

    Knight-move segments are never collinear-overlapping unless equal, so the
    strict orientation test is exact for link blocking.
    """
    def orient(p, q, r):
        return _cross(q[0] - p[0], q[1] - p[1], r[0] - p[0], r[1] - p[1])

    o1 = orient(a, b, c)
    o2 = orient(a, b, d)
    o3 = orient(c, d, a)
    o4 = orient(c, d, b)
    return (o1 * o2 < 0) and (o3 * o4 < 0)


def _build_crossing_table():
    """For each direction d, the links that geometrically cross link ((0,0),d).

    Returns int32 array [8, 9, 3] of (dx, dy, dir2): link ((0,0),d) is crossed
    by link ((dx,dy),dir2).  dir2 is canonicalised to the four east-side
    directions (NNE..SSE) so each geometric crossing link appears exactly
    once; because links are stored symmetrically on both endpoints, probing
    the bit at the (dx,dy) endpoint is sufficient at runtime.

    This is the derived equivalent of the reference's kLinkDescriptorTable
    blocking_links lists (twixtboard.cc:38-144); test_geometry.py checks the
    derived sets match the hand-written ones exactly.
    """
    table = np.zeros((NUM_DIRS, 9, 3), dtype=np.int32)
    for d in range(NUM_DIRS):
        a = (0, 0)
        b = tuple(OFFSETS[d])
        found = []
        # Candidate origins within the reachable window; canonical east dirs.
        for d2 in (NNE, ENE, ESE, SSE):
            for ox in range(-3, 4):
                for oy in range(-3, 4):
                    c = (ox, oy)
                    e = (ox + int(OFFSETS[d2][0]), oy + int(OFFSETS[d2][1]))
                    if _segments_properly_intersect(a, b, c, e):
                        found.append((ox, oy, d2))
        assert len(found) == 9, (d, found)
        table[d] = np.array(sorted(found), dtype=np.int32)
    return table


# [8, 9, 3]: (dx, dy, canonical direction) of the 9 links crossing each
# direction's link.
CROSSERS = _build_crossing_table()


def board_masks(size: int):
    """Per-board-size constant masks on the padded grid, as numpy bools.

    Returns a dict with [P, P] arrays (P = size + 2*PAD):
      on_board     cell is playable or a border cell (corners excluded)
      corner       the four corner cells
      legal0       initial legal mask for red  (reference twixtboard.cc:252-276)
      legal1       initial legal mask for blue
      init_flags   uint8 border-connectivity flag bits for empty border cells
                   (reference twixtboard.cc:219-231)
      init_color   int8 initial colors (EMPTY / OFFBOARD, halo OFFBOARD)
    """
    p = size + 2 * PAD
    xs = np.arange(p)[:, None] - PAD  # board x coordinate
    ys = np.arange(p)[None, :] - PAD  # board y coordinate
    in_bounds = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
    x_edge = (xs == 0) | (xs == size - 1)
    y_edge = (ys == 0) | (ys == size - 1)
    corner = in_bounds & x_edge & y_edge
    on_board = in_bounds & ~corner

    legal0 = on_board & ~x_edge  # red may not play the blue (x) border columns
    legal1 = on_board & ~y_edge  # blue may not play the red (y) border rows

    # Border connectivity flag bit for (player, border): 1 << (player*2+border).
    # Mirrors the exclusive elif chain in reference twixtboard.cc:222-231
    # (order irrelevant off the corners, which are off-board).
    flags = np.zeros((p, p), dtype=np.uint8)
    flags[on_board & (xs == 0)] |= flag_bit(BLUE, BORDER_START)
    flags[on_board & (xs == size - 1)] |= flag_bit(BLUE, BORDER_END)
    flags[on_board & (ys == 0)] |= flag_bit(RED, BORDER_START)
    flags[on_board & (ys == size - 1)] |= flag_bit(RED, BORDER_END)

    color = np.full((p, p), COLOR_OFFBOARD, dtype=np.int8)
    color[on_board] = COLOR_EMPTY

    # Connectivity bookkeeping (see ops/step.py): every cell starts as its
    # own component, identified by its action index x*size+y; off-board halo
    # and corner cells get a sentinel id that never matches a live component.
    compid = np.full((p, p), -1, dtype=np.int16)
    compid[on_board] = (xs * size + ys)[on_board].astype(np.int16)

    return {
        "on_board": on_board,
        "corner": corner,
        "legal0": legal0,
        "legal1": legal1,
        "init_flags": flags,
        "init_color": color,
        "init_compid": compid,
    }


def flag_bit(player: int, border: int) -> int:
    """Bit used in the packed border-connectivity flag byte."""
    return 1 << (player * 2 + border)


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
    return board_size + 2 * PAD


def reset(board_size: int, device="cuda") -> State:
    """Start-of-game state of one env (reference Board ctor,
    twixtboard.cc:168-174), on ``device``."""
    m = board_masks(board_size)
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
        current_player=scalar(RED),
        move_counter=scalar(0),
        move_one=scalar(-1),
        swapped=scalar(False, torch.bool),
        result=scalar(RESULT_OPEN),
    )


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


_BIG = 1 << 20


_M32 = 0xFFFFFFFF


class BitState(NamedTuple):
    """Bit-packed TwixT state; field names and tuple structure of the JAX
    ``BitState`` (see there for each field's meaning).

      red, blue                int32 [P, B] peg planes
      links, blocked           4-tuples of int32 [P, B] canonical east planes
      legal                    2-tuple of int32 [P, B] per-player legal planes
      flags                    4-tuple of int32 [P, B] border-connectivity bits
      compid                   int16 [n, n, B] union-find component ids
      current_player, move_counter, move_one, swapped, result   int32 [B]
    """

    red: torch.Tensor
    blue: torch.Tensor
    links: tuple
    blocked: tuple
    legal: tuple
    flags: tuple
    compid: torch.Tensor
    current_player: torch.Tensor
    move_counter: torch.Tensor
    move_one: torch.Tensor
    swapped: torch.Tensor
    result: torch.Tensor


def bitstate_leaves(bs: BitState) -> list:
    """The 22 leaves in ``jax.tree_util.tree_leaves`` order."""
    return [
        bs.red, bs.blue, *bs.links, *bs.blocked, *bs.legal, *bs.flags,
        bs.compid, bs.current_player, bs.move_counter, bs.move_one,
        bs.swapped, bs.result,
    ]


def bitstate_from_leaves(leaves) -> BitState:
    x = list(leaves)
    if len(x) != NUM_LEAVES:
        raise ValueError(f"expected {NUM_LEAVES} leaves, got {len(x)}")
    return BitState(
        red=x[0], blue=x[1], links=tuple(x[2:6]), blocked=tuple(x[6:10]),
        legal=tuple(x[10:12]), flags=tuple(x[12:16]), compid=x[16],
        current_player=x[17], move_counter=x[18], move_one=x[19],
        swapped=x[20], result=x[21],
    )


def _pack_bool(board: torch.Tensor) -> torch.Tensor:
    """[P, P, *B] bool -> [P, *B] int32 bitplane (bit y = board[x, y])."""
    p = board.shape[1]
    ybits = torch.ones((), dtype=_I32) << torch.arange(p, dtype=_I32)
    ybits = ybits.to(board.device).reshape((1, p) + (1,) * (board.ndim - 2))
    return torch.where(board, ybits, 0).sum(dim=1, dtype=_I32)


def _shiftp(plane: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[x] bit y = plane[x + dx] bit (y + dy): a roll along x (the halo
    is empty) and a bit shift along y."""
    if dx:
        plane = torch.roll(plane, -dx, dims=0)
    if dy > 0:
        plane = plane >> dy
    elif dy < 0:
        plane = plane << -dy
    return plane


def expand_planes(planes4: tuple) -> tuple:
    """4 canonical planes -> 8 symmetric per-direction planes (west bit d
    at cell c == canonical bit d-4 at cell c + OFFSETS[d])."""
    out = list(planes4)
    for d in range(4, NUM_DIRS):
        dx, dy = (int(v) for v in OFFSETS[d])
        out.append(_shiftp(planes4[d - 4], dx, dy))
    return tuple(out)


def from_state(state: State) -> BitState:
    """Pack a canonical State into bitplanes (conversion, not hot): the
    canonical east link / blocked bits, the inner-board compid, and
    ``swapped`` as int32."""
    color = state.color

    def bits(board, k):
        return _pack_bool(((board >> k) & 1) != 0)

    n = color.shape[0] - 2 * PAD
    return BitState(
        red=_pack_bool(color == COLOR_RED),
        blue=_pack_bool(color == COLOR_BLUE),
        links=tuple(bits(state.links, d) for d in range(4)),
        blocked=tuple(bits(state.blocked, d) for d in range(4)),
        legal=(_pack_bool(state.legal[0]), _pack_bool(state.legal[1])),
        flags=tuple(bits(state.flags, b) for b in range(4)),
        compid=state.compid[PAD : PAD + n, PAD : PAD + n],
        current_player=state.current_player,
        move_counter=state.move_counter,
        move_one=state.move_one,
        swapped=state.swapped.to(_I32),
        result=state.result,
    )


def bit_reset(board_size: int, batch: int, device="cuda") -> BitState:
    """Initial BitState of ``batch`` envs (reference Board ctor,
    twixtboard.cc:168-174): the packed canonical reset, as in JAX."""
    one_env = from_state(reset(board_size, device))
    return bitstate_from_leaves(
        x.unsqueeze(-1).expand(x.shape + (batch,)).contiguous()
        for x in bitstate_leaves(one_env)
    )


def _onehot_bits(action: torch.Tensor, board_size: int, p: int) -> torch.Tensor:
    """int32 [P, B] bitplane with exactly the action's cell bit set."""
    x = action // board_size + PAD
    y = action % board_size + PAD
    xs = torch.arange(p, dtype=_I32, device=action.device).unsqueeze(1)
    return torch.where(xs == x, torch.ones_like(y) << y, 0)


def _any_bits(plane: torch.Tensor) -> torch.Tensor:
    """[P, B] -> [B] bool: any bit set."""
    return (plane != 0).any(dim=0)


def _row(plane: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Word at board row ``row`` ([B]) of a [P, B] plane, 0 off the plane
    (what the JAX engine's masked row reduction gives there)."""
    p = plane.shape[0]
    ok = (row >= 0) & (row < p)
    idx = row.clamp(0, p - 1).long().unsqueeze(0)
    return torch.where(ok, plane.gather(0, idx).squeeze(0), 0)


def _probe(word: torch.Tensor, ybit: torch.Tensor) -> torch.Tensor:
    return ((word >> ybit) & 1) != 0


def _cell(compid: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """compid[cx, cy] per env ([B] int16), or the sentinel -20000 off the
    inner board (below any live id, which is >= -1)."""
    n = compid.shape[0]
    ok = (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n)
    idx = (cx.clamp(0, n - 1) * n + cy.clamp(0, n - 1)).long().unsqueeze(0)
    raw = compid.reshape(n * n, -1).gather(0, idx).squeeze(0)
    return torch.where(ok, raw, -20000)


def step_bits_reference(bs: BitState, board_size: int, action) -> BitState:
    """The plain torch version of :func:`step_bits`, on any device, written
    with per-env row gathers where the JAX engine uses masked row
    reductions."""
    n = board_size
    p = bs.red.shape[0]
    dev = bs.red.device
    player = bs.current_player
    mc = bs.move_counter
    action = torch.as_tensor(action, dtype=_I32, device=dev)

    is_swap = (mc == 1) & (action == bs.move_one)

    # swap undo (twixtboard.cc:450-455): clear move one's peg
    m_one = _onehot_bits(bs.move_one, n, p)
    undo = torch.where(is_swap, m_one, 0)
    red = bs.red & ~undo
    blue = bs.blue & ~undo

    eff = torch.where(is_swap, swap_rotate_action(action, n), action)
    me = _onehot_bits(eff, n, p)

    # move 2 without swap: move one leaves both legal sets
    # (twixtboard.cc:475-480)
    rm1 = torch.where((mc == 1) & ~is_swap, m_one, 0)
    legal = tuple(plane & ~rm1 for plane in bs.legal)

    # place the peg
    is_red = player == 0
    red = torch.where(is_red, red | me, red)
    blue = torch.where(is_red, blue, blue | me)
    mine = torch.where(is_red, red, blue)

    px = eff // n  # inner coords (no halo)
    py = eff % n
    pxp = px + PAD
    pyp = py + PAD

    rows = {}

    def row(name, plane, dx):
        key = (name, dx)
        if key not in rows:
            rows[key] = _row(plane, pxp + dx)
        return rows[key]

    # --- links / blocked (SetPegAndLinks, twixtboard.cc:501-571): all 8
    # directions read the pre-move links; results land in the canonical
    # plane of each pair's west endpoint
    links = list(bs.links)
    blocked = list(bs.blocked)
    linked_s = []
    for d in range(NUM_DIRS):
        dx, dy = (int(v) for v in OFFSETS[d])
        same = _probe(row("mine", mine, dx), pyp + dy)
        crossed = torch.zeros_like(same)
        for ox, oy, d2 in CROSSERS[d]:
            d2, ox, oy = int(d2), int(ox), int(oy)
            crossed = crossed | _probe(
                row(("links", d2), bs.links[d2], ox), pyp + oy
            )
        linked = same & ~crossed
        blkd = same & crossed
        linked_s.append(linked)
        if d < 4:
            links[d] = links[d] | torch.where(linked, me, 0)
            blocked[d] = blocked[d] | torch.where(blkd, me, 0)
        else:
            tgt = _shiftp(me, -dx, -dy)
            links[d - 4] = links[d - 4] | torch.where(linked, tgt, 0)
            blocked[d - 4] = blocked[d - 4] | torch.where(blkd, tgt, 0)

    # --- merged flag byte: own cell's flags | flags of each newly linked
    # neighbour
    nf = torch.zeros_like(player)
    for b in range(4):
        got = _probe(row(("flags", b), bs.flags[b], 0), pyp)
        for d in range(NUM_DIRS):
            dx, dy = (int(v) for v in OFFSETS[d])
            got = got | (
                linked_s[d] & _probe(row(("flags", b), bs.flags[b], dx), pyp + dy)
            )
        nf = nf | torch.where(got, 1 << b, 0).to(_I32)

    # --- union-find merge on the inner-board compid: the new component id
    # is the smallest of the peg's own id and its linked neighbours' ids
    compid = bs.compid
    nid = eff
    cids = []
    for d in range(NUM_DIRS):
        dx, dy = (int(v) for v in OFFSETS[d])
        # sentinel -7 never equals a compid (ids are >= -1)
        cid = torch.where(linked_s[d], _cell(compid, px + dx, py + dy), -7)
        cids.append(cid)
        nid = torch.minimum(nid, torch.where(cid >= 0, cid.to(_I32), _BIG))

    xs = torch.arange(n, dtype=_I32, device=dev).reshape(n, 1, 1)
    ys = torch.arange(n, dtype=_I32, device=dev).reshape(1, n, 1)
    hit = (xs == px) & (ys == py)
    for cid in cids:
        hit = hit | ((compid == cid) & (cid >= 0))
    compid = torch.where(hit, nid.to(compid.dtype), compid)

    # stamp the merged flag byte on the whole united component
    ybits = torch.ones((), dtype=_I32, device=dev) << (ys + PAD)
    inner_bits = torch.where(hit, ybits, 0).sum(dim=1, dtype=_I32)
    zpad = torch.zeros((PAD,) + inner_bits.shape[1:], dtype=_I32, device=dev)
    hit_bits = torch.cat([zpad, inner_bits, zpad], dim=0)
    flags = tuple(
        torch.where(((nf >> b) & 1) != 0, bs.flags[b] | hit_bits, bs.flags[b])
        for b in range(4)
    )

    # --- legal bookkeeping: move one stays legal for one ply
    # (twixtboard.cc:485-493)
    rm = torch.where(mc == 0, 0, me)
    legal = tuple(plane & ~rm for plane in legal)
    move_one = torch.where(mc == 0, eff, bs.move_one)

    # --- result (UpdateResult, twixtboard.cc:192-207)
    shift = player * 2
    win = (((nf >> shift) & 1) != 0) & (((nf >> (shift + 1)) & 1) != 0)
    opp = 1 - player
    opp_has_legal = _any_bits(torch.where(opp == 0, legal[0], legal[1]))
    open_or_draw = torch.where(
        opp_has_legal, RESULT_OPEN, RESULT_DRAW
    ).to(_I32)
    result = torch.where(win, RESULT_RED_WIN + player, open_or_draw)
    current_player = torch.where(
        result == RESULT_OPEN, opp, TERMINAL_PLAYER_ID
    )

    return BitState(
        red=red,
        blue=blue,
        links=tuple(links),
        blocked=tuple(blocked),
        legal=legal,
        flags=flags,
        compid=compid,
        current_player=current_player,
        move_counter=mc + 1,
        move_one=move_one,
        swapped=bs.swapped | is_swap.to(_I32),
        result=result,
    )


def bit_legal_mask_flat(bs: BitState, player, board_size: int) -> torch.Tensor:
    """Legal mask over the ``size*size`` action space, ascending action
    order: bool [size*size, B]."""
    n = board_size
    player = torch.as_tensor(player, device=bs.red.device)
    sel = torch.where(player == 0, bs.legal[0], bs.legal[1])
    core = sel[PAD : PAD + n]  # [n, B]
    ys = torch.arange(PAD, PAD + n, dtype=_I32, device=sel.device)
    bits = ((core.unsqueeze(1) >> ys.reshape((1, n) + (1,) * (core.ndim - 1))) & 1) != 0
    return bits.reshape((n * n,) + core.shape[1:])


def _mul_u32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) (int64 tensor or int), without
    int64 overflow: split ``c`` into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash_u32(x):
    """The engine's counter hash on u32 values held in int64 (or a Python
    int); bit-equal to the JAX ``_hash_u32`` on uint32."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of u32 words (any int dtype; read as u32) -> int32."""
    x = x.to(_I64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _M32) >> 24).to(_I32)


def _select_kth_bit(w: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Position of the (k+1)-th lowest set bit of the u32 word ``w``: a
    5-step halving search, as the JAX ``_select_kth_bit``."""
    w = w.to(_I64) & _M32
    pos = torch.zeros_like(k)
    kk = k
    for width in (16, 8, 4, 2, 1):
        cnt = _popcount((w >> pos) & ((1 << width) - 1))
        go_high = kk >= cnt
        kk = torch.where(go_high, kk - cnt, kk)
        pos = torch.where(go_high, pos + width, pos)
    return pos


def _mover_legal(bs: BitState) -> torch.Tensor:
    """The legal plane of the player to move ([P, B]; player clipped to
    0..1, as in the JAX sampler)."""
    p = bs.current_player.clamp(0, 1)
    return torch.where(p == 0, bs.legal[0], bs.legal[1])


def sample_bits(bs: BitState, board_size: int, noise: torch.Tensor) -> torch.Tensor:
    """Uniform random legal action per env (int32 [B]).  ``noise`` holds u32
    values in int64; k ~ U[0, popcount(legal)) from its hash, in float32 as
    in JAX, then the k-th set bit in ascending action order."""
    legal = _mover_legal(bs)  # [P, B]
    cnt = _popcount(legal)  # per column
    cum = cnt.cumsum(dim=0, dtype=_I32)
    total = cum[-1]

    bits = _hash_u32(noise)
    u = (bits >> 8).to(_I32).to(torch.float32) * (1.0 / 16777216.0)
    k = torch.minimum((u * total.to(torch.float32)).to(_I32), total - 1)
    k = k.clamp_min(0)

    # column = first row where cum > k; k_in_col = k - cum[prev]
    cum_prev = cum - cnt
    sel = (cum > k) & (cum_prev <= k)  # one-hot over columns
    xs = torch.arange(legal.shape[0], dtype=_I32, device=legal.device).unsqueeze(1)
    col = torch.where(sel, xs, _BIG).amin(dim=0)
    word = torch.where(sel, legal, 0).amax(dim=0)
    k_in_col = k - torch.where(sel, cum_prev, 0).amax(dim=0)
    y = _select_kth_bit(word, k_in_col)
    return (col - PAD) * board_size + (y - PAD)


def rollout_noise(seed: int, step: int, env: torch.Tensor) -> torch.Tensor:
    """Per-(step, env) noise of the rollout, u32 in int64:
    ``hash(seed + 2654435761*(step+1)) + env*0x9E3779B9`` mod 2^32, with
    ``env`` the global env index."""
    base = _hash_u32((seed + 2654435761 * (step + 1)) & _M32)
    return (base + _mul_u32(env, 0x9E3779B9)) & _M32


def _reset_done(nxt: BitState, init: BitState) -> BitState:
    done = nxt.result != RESULT_OPEN
    return bitstate_from_leaves(
        torch.where(done, a, b)
        for a, b in zip(bitstate_leaves(init), bitstate_leaves(nxt))
    )


def bit_observation_packed_lanes(bs, board_size: int) -> torch.Tensor:
    """Observation as packed column words in the engine's lane-major
    layout: int32 [12, P, B]."""
    any_link = bs.links[0]
    for plane in expand_planes(bs.links)[1:]:
        any_link = any_link | plane
    blocked_e = bs.blocked[0] | bs.blocked[1] | bs.blocked[2] | bs.blocked[3]
    packed = []
    for is_color in (bs.red, bs.blue):
        packed.append(is_color & ~any_link)  # plane 0 / 6
        for d in range(4):  # planes 1-4 / 7-10
            packed.append(is_color & bs.links[d])
        packed.append(is_color & blocked_e)  # plane 5 / 11
    return torch.stack(packed)


_LEGAL_CHUNK_BITS = 3


_LEGAL_CHUNK_PLANES = 8


def pack_legal_into_lanes(stack: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """OR the legal plane's 3-bit chunks into the low bits of obs planes
    0..7 (``stack`` [12, P, B], ``legal`` [P, B]), clearing those bits
    first.  Inverse: :func:`legal_words_from_obs`."""
    one_chunk = (1 << _LEGAL_CHUNK_BITS) - 1
    planes = []
    for k in range(_LEGAL_CHUNK_PLANES):
        chunk = (legal >> (PAD + _LEGAL_CHUNK_BITS * k)) & one_chunk
        planes.append((stack[k] & ~one_chunk) | chunk)
    return torch.cat([torch.stack(planes), stack[_LEGAL_CHUNK_PLANES:]], dim=0)


def legal_words_from_obs(pk: torch.Tensor) -> torch.Tensor:
    """Recover the packed legal words from wire words ([..., 12, P] with the
    legal chunks in planes 0..7's low bits) -> [..., P]."""
    one_chunk = (1 << _LEGAL_CHUNK_BITS) - 1
    legal = torch.zeros_like(pk[..., 0, :])
    for k in range(_LEGAL_CHUNK_PLANES):
        legal = legal | (
            (pk[..., k, :] & one_chunk) << (PAD + _LEGAL_CHUNK_BITS * k)
        )
    return legal


def bit_observation_packed_with_legal(bs, board_size: int) -> torch.Tensor:
    """The full self-play wire as one array: int32 [B, 12*P], the 12 packed
    planes with the mover's legal plane in their free low bits."""
    full = pack_legal_into_lanes(
        bit_observation_packed_lanes(bs, board_size), _mover_legal(bs)
    )
    return full.permute(2, 0, 1).reshape(full.shape[-1], -1)


def unpack_observation_nchw(pk: torch.Tensor, board_size: int,
                            dtype=torch.float32) -> torch.Tensor:
    """Decode packed words ([..., 12, P]) to the network layout
    [..., 12, size, size-2].  Red block: out[r, c] = bit(word[pad+c+1],
    pad+n-1-r); blue block: out[r, c] = bit(word[pad+n-1-r], pad+n-2-c)."""
    n = board_size
    pad = PAD
    lead = pk.shape[:-2]
    pk = pk.reshape((-1,) + pk.shape[-2:])
    dev = pk.device
    red_pk, blue_pk = pk[:, :6, :], pk[:, 6:, :]
    words_r = red_pk[:, :, pad + 1 : pad + n - 1]  # [B, 6, n-2]
    shifts_r = (pad + n - 1 - torch.arange(n, dtype=_I32, device=dev)).reshape(
        1, 1, n, 1
    )
    red_obs = (words_r.unsqueeze(2) >> shifts_r) & 1  # [B, 6, n, n-2]
    words_b = blue_pk[:, :, pad : pad + n].flip(-1)  # [B, 6, n]
    shifts_b = (
        pad + n - 2 - torch.arange(n - 2, dtype=_I32, device=dev)
    ).reshape(1, 1, 1, n - 2)
    blue_obs = (words_b.unsqueeze(3) >> shifts_b) & 1  # [B, 6, n, n-2]
    out = torch.cat([red_obs, blue_obs], dim=1).to(dtype)
    return out.reshape(lead + out.shape[1:])


def unpack_legal_words_flat(words: torch.Tensor, board_size: int) -> torch.Tensor:
    """Decode packed legal words ([..., P]) to the flat legal mask over the
    action space: bool [..., n*n], ascending action order."""
    n = board_size
    pad = PAD
    core = words[..., pad : pad + n]  # [..., n]
    ys = torch.arange(pad, pad + n, dtype=_I32, device=words.device)
    bits = ((core.unsqueeze(-1) >> ys) & 1) != 0  # [..., n, n]
    return bits.reshape(bits.shape[:-2] + (n * n,))


def rollout(seed: int, board_size: int, num_steps: int, bs: BitState, auto_reset: bool = True):
    """The lockstep random rollout with auto-reset, emitting every step's
    pre-move wire: ``num_steps`` steps of every env, move k of env e drawn
    from ``rollout_noise(seed, k, e)`` (``seed`` a u32).  Returns (final
    state, episodes int32 [], results int32 [4], wire int32 [T, 12, P, B]):
    the episodes that ended, and how many ended in each result.
    ``auto_reset=False`` is the control, which breaks the configuration's
    guarantee that a finished game restarts: a finished env stays as it
    ended."""
    dev = bs.red.device
    p, batch = bs.red.shape
    env = torch.arange(batch, dtype=_I64, device=dev)
    init = bit_reset(board_size, 1, dev)
    wire = torch.empty((num_steps, 12, p, batch), dtype=_I32, device=dev)
    episodes = torch.zeros((), dtype=_I32, device=dev)
    results = torch.zeros(4, dtype=_I32, device=dev)
    rs = torch.arange(4, dtype=_I32, device=dev).unsqueeze(1)
    for k in range(num_steps):
        wire[k] = pack_legal_into_lanes(bit_observation_packed_lanes(bs, board_size),
                                        _mover_legal(bs))
        actions = sample_bits(bs, board_size, rollout_noise(seed, k, env))
        nxt = step_bits_reference(bs, board_size, actions)
        done = nxt.result != RESULT_OPEN
        episodes = episodes + done.sum(dtype=_I32)
        results = results + (done & (nxt.result == rs)).sum(dim=1, dtype=_I32)
        bs = _reset_done(nxt, init) if auto_reset else nxt
    return bs, episodes, results, wire
