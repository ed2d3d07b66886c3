"""Bitboard engine in PyTorch (``twixt_for_open_spiel_tpu/ops/bitboard.py``).

The plain torch version of the rollout engine: the same bit-packed state,
the same transition, the same counter-hash sampler, bit for bit.  It runs on
CPU tensors in the tests, where it is pinned against the JAX engine, and on
the card as the reference that the CUDA kernel
(``ops/fused_bit_rollout.py``) is held to.

Storage.  Torch has no shifts or compares on ``uint32``, so every u32
bitplane of the JAX engine is an ``int32`` tensor here, bit-equal: a plane
holds P = n + 2*PAD <= 30 live bits, never bit 31, so its words are the
same non-negative numbers in both dtypes.  The counter hash needs full
32-bit wraparound and runs in ``int64`` masked to 32 bits.  ``swapped`` is
``int32`` (bool in the JAX engine's reset, int32 inside its Pallas kernel);
the numpy converters map both.

Shapes: planes ``[P, B]``, ``compid`` ``[n, n, B]``, scalars ``[B]``: one
trailing env axis, as in the JAX engine.  Word ``plane[x]`` holds cell
``(x, y)`` in bit ``y`` of the padded board.

Reference semantics (the same lines as the JAX module): swap rule
twixtboard.cc:450-499, SetPegAndLinks twixtboard.cc:501-571, win/draw
twixtboard.cc:192-207, turn logic twixt.h:93-104.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import state as canonical
from twixt_for_open_spiel_tpu_torch.ops.state import (
    State,
    padded_size,
    swap_rotate_action,
)

_I32 = torch.int32
_I64 = torch.int64
_BIG = 1 << 20
_M32 = 0xFFFFFFFF

NUM_LEAVES = 22  # red/blue, 4 links, 4 blocked, 2 legal, 4 flags, compid, 5 scalars
_COMPID_LEAF = 16
_SWAPPED_LEAF = 20


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


def bitstate_from_numpy(leaves, device="cuda") -> BitState:
    """A JAX ``BitState``, given as numpy arrays in ``tree_leaves`` order,
    as a port ``BitState`` on ``device`` (u32 planes -> int32, bool
    ``swapped`` -> int32, compid stays int16)."""
    out = []
    for i, leaf in enumerate(leaves):
        a = np.asarray(leaf)
        if a.dtype == np.uint32 and a.size and int(a.max()) > 0x7FFFFFFF:
            raise ValueError(f"leaf {i} has bit 31 set; not a bitplane")
        dt = np.int16 if i == _COMPID_LEAF else np.int32
        out.append(torch.from_numpy(a.astype(dt)).to(device))
    return bitstate_from_leaves(out)


def bitstate_to_numpy(bs: BitState) -> list:
    """The inverse of :func:`bitstate_from_numpy`: numpy leaves in the JAX
    engine's dtypes (u32 planes, int16 compid, int32 scalars, bool
    ``swapped``)."""
    out = []
    for i, leaf in enumerate(bitstate_leaves(bs)):
        a = leaf.detach().cpu().numpy()
        if i < _COMPID_LEAF:
            a = a.astype(np.uint32)
        elif i == _SWAPPED_LEAF:
            a = a != 0
        out.append(a)
    return out


def state_digest(bs: BitState) -> str:
    """sha256 of every leaf in field order (``state.state_digest``), in the
    ``[..., B]`` layout, so a JAX state carried over by
    :func:`bitstate_from_numpy` digests the same as the port's."""
    return canonical.state_digest(bitstate_leaves(bs))


def _pack_bool(board: torch.Tensor) -> torch.Tensor:
    """[P, P, *B] bool -> [P, *B] int32 bitplane (bit y = board[x, y])."""
    p = board.shape[1]
    ybits = torch.ones((), dtype=_I32) << torch.arange(p, dtype=_I32)
    ybits = ybits.to(board.device).reshape((1, p) + (1,) * (board.ndim - 2))
    return torch.where(board, ybits, 0).sum(dim=1, dtype=_I32)


def _unpack_bool(plane: torch.Tensor, p: int) -> torch.Tensor:
    """[P, *B] int32 -> [P, P, *B] bool."""
    ys = torch.arange(p, dtype=_I32, device=plane.device)
    ys = ys.reshape((1, p) + (1,) * (plane.ndim - 1))
    return ((plane.unsqueeze(1) >> ys) & 1) != 0


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
    for d in range(4, geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        out.append(_shiftp(planes4[d - 4], dx, dy))
    return tuple(out)


def from_state(state: State) -> BitState:
    """Pack a canonical State into bitplanes (conversion, not hot): the
    canonical east link / blocked bits, the inner-board compid, and
    ``swapped`` as int32."""
    color = state.color

    def bits(board, k):
        return _pack_bool(((board >> k) & 1) != 0)

    n = color.shape[0] - 2 * geo.PAD
    return BitState(
        red=_pack_bool(color == geo.COLOR_RED),
        blue=_pack_bool(color == geo.COLOR_BLUE),
        links=tuple(bits(state.links, d) for d in range(4)),
        blocked=tuple(bits(state.blocked, d) for d in range(4)),
        legal=(_pack_bool(state.legal[0]), _pack_bool(state.legal[1])),
        flags=tuple(bits(state.flags, b) for b in range(4)),
        compid=state.compid[geo.PAD : geo.PAD + n, geo.PAD : geo.PAD + n],
        current_player=state.current_player,
        move_counter=state.move_counter,
        move_one=state.move_one,
        swapped=state.swapped.to(_I32),
        result=state.result,
    )


def to_state(bs: BitState, board_size: int) -> State:
    """Unpack to the canonical State (for observation, rendering, parity):
    west link / blocked bits come back by :func:`expand_planes`, the halo
    and corners from the constant reset state."""
    p = padded_size(board_size)
    n = board_size
    red = _unpack_bool(bs.red, p)
    blue = _unpack_bool(bs.blue, p)
    init = canonical.reset(board_size, bs.red.device)
    tail = (1,) * (red.ndim - 2)
    on_board = (init.color != geo.COLOR_OFFBOARD).reshape((p, p) + tail)
    color = torch.where(
        red,
        geo.COLOR_RED,
        torch.where(
            blue,
            geo.COLOR_BLUE,
            torch.where(on_board, geo.COLOR_EMPTY, geo.COLOR_OFFBOARD),
        ),
    ).to(torch.int8)

    def unpack_bits(planes):
        acc = torch.zeros(color.shape, dtype=torch.uint8, device=color.device)
        for d, plane in enumerate(planes):
            acc = acc | (_unpack_bool(plane, p).to(torch.uint8) << d)
        return acc

    # the inner compid pasted into the constant halo (halo ids are -1 and
    # never change)
    compid = init.compid.reshape((p, p) + tail).expand(
        (p, p) + tuple(bs.compid.shape[2:])
    ).clone()
    compid[geo.PAD : geo.PAD + n, geo.PAD : geo.PAD + n] = bs.compid
    return State(
        color=color,
        links=unpack_bits(expand_planes(bs.links)),
        blocked=unpack_bits(expand_planes(bs.blocked)),
        compid=compid,
        flags=unpack_bits(bs.flags),
        legal=torch.stack([_unpack_bool(bs.legal[0], p),
                           _unpack_bool(bs.legal[1], p)]),
        current_player=bs.current_player,
        move_counter=bs.move_counter,
        move_one=bs.move_one,
        swapped=bs.swapped != 0,
        result=bs.result,
    )


def bit_reset(board_size: int, batch: int, device="cuda") -> BitState:
    """Initial BitState of ``batch`` envs (reference Board ctor,
    twixtboard.cc:168-174): the packed canonical reset, as in JAX."""
    one_env = from_state(canonical.reset(board_size, device))
    return bitstate_from_leaves(
        x.unsqueeze(-1).expand(x.shape + (batch,)).contiguous()
        for x in bitstate_leaves(one_env)
    )


def _onehot_bits(action: torch.Tensor, board_size: int, p: int) -> torch.Tensor:
    """int32 [P, B] bitplane with exactly the action's cell bit set."""
    x = action // board_size + geo.PAD
    y = action % board_size + geo.PAD
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


def step_bits(bs: BitState, board_size: int, action) -> BitState:
    """One move per env (int32 ``action`` [B]): the bit-packed transition of
    the JAX ``step_bits``.  CPU tensors run :func:`step_bits_reference`;
    CUDA tensors the one-step kernel (``ops/bit_step.py::step_state``), or
    raise."""
    device = bs.red.device
    if device.type == "cpu":
        return step_bits_reference(bs, board_size, action)
    # imported here: ops/bit_step.py imports this module
    from twixt_for_open_spiel_tpu_torch.ops.bit_step import step_state

    return step_state(bs, board_size, action)


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
    pxp = px + geo.PAD
    pyp = py + geo.PAD

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
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
        same = _probe(row("mine", mine, dx), pyp + dy)
        crossed = torch.zeros_like(same)
        for ox, oy, d2 in geo.CROSSERS[d]:
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
        for d in range(geo.NUM_DIRS):
            dx, dy = (int(v) for v in geo.OFFSETS[d])
            got = got | (
                linked_s[d] & _probe(row(("flags", b), bs.flags[b], dx), pyp + dy)
            )
        nf = nf | torch.where(got, 1 << b, 0).to(_I32)

    # --- union-find merge on the inner-board compid: the new component id
    # is the smallest of the peg's own id and its linked neighbours' ids
    compid = bs.compid
    nid = eff
    cids = []
    for d in range(geo.NUM_DIRS):
        dx, dy = (int(v) for v in geo.OFFSETS[d])
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
    ybits = torch.ones((), dtype=_I32, device=dev) << (ys + geo.PAD)
    inner_bits = torch.where(hit, ybits, 0).sum(dim=1, dtype=_I32)
    zpad = torch.zeros((geo.PAD,) + inner_bits.shape[1:], dtype=_I32, device=dev)
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
        opp_has_legal, geo.RESULT_OPEN, geo.RESULT_DRAW
    ).to(_I32)
    result = torch.where(win, geo.RESULT_RED_WIN + player, open_or_draw)
    current_player = torch.where(
        result == geo.RESULT_OPEN, opp, geo.TERMINAL_PLAYER_ID
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
    core = sel[geo.PAD : geo.PAD + n]  # [n, B]
    ys = torch.arange(geo.PAD, geo.PAD + n, dtype=_I32, device=sel.device)
    bits = ((core.unsqueeze(1) >> ys.reshape((1, n) + (1,) * (core.ndim - 1))) & 1) != 0
    return bits.reshape((n * n,) + core.shape[1:])


# --- sampling: exact popcount-rank selection on the legal bitplane ---------


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
    return (col - geo.PAD) * board_size + (y - geo.PAD)


# --- rollout driver ---------------------------------------------------------


def rollout_noise(seed: int, step: int, env: torch.Tensor) -> torch.Tensor:
    """Per-(step, env) noise of the rollout, u32 in int64:
    ``hash(seed + 2654435761*(step+1)) + env*0x9E3779B9`` mod 2^32, with
    ``env`` the global env index."""
    base = _hash_u32((seed + 2654435761 * (step + 1)) & _M32)
    return (base + _mul_u32(env, 0x9E3779B9)) & _M32


def _reset_done(nxt: BitState, init: BitState) -> BitState:
    done = nxt.result != geo.RESULT_OPEN
    return bitstate_from_leaves(
        torch.where(done, a, b)
        for a, b in zip(bitstate_leaves(init), bitstate_leaves(nxt))
    )


def bit_step_auto_reset(bs: BitState, action, board_size: int):
    """step_bits(); terminal next-states are replaced by fresh initial
    states.  Returns (state, done, pre-reset result)."""
    nxt = step_bits(bs, board_size, action)
    init = bit_reset(board_size, 1, bs.red.device)
    return _reset_done(nxt, init), nxt.result != geo.RESULT_OPEN, nxt.result


def _packed_wire_lanes(bs: BitState, board_size: int) -> torch.Tensor:
    """The pre-move packed wire of one step, lane-major: int32 [12, P, B]."""
    from twixt_for_open_spiel_tpu_torch.ops.observe import (
        bit_observation_packed_lanes,
        pack_legal_into_lanes,
    )

    return pack_legal_into_lanes(
        bit_observation_packed_lanes(bs, board_size), _mover_legal(bs)
    )


def rollout_loop(seed: int, board_size: int, num_steps: int, bs: BitState,
                 obs: torch.Tensor | None = None, emit=_packed_wire_lanes):
    """The lockstep random rollout, one plain torch step at a time (the
    whole-rollout kernel's plain version, so no kernel on the card).  Returns
    (final state, episodes int32 [], results int32 [4]).  With ``obs`` it
    also writes ``emit(state, board_size)`` of every step's pre-move state
    to ``obs[step]``: by default the packed wire, int32 [12, P, B]."""
    dev = bs.red.device
    env = torch.arange(bs.current_player.shape[-1], dtype=_I64, device=dev)
    init = bit_reset(board_size, 1, dev)
    episodes = torch.zeros((), dtype=_I32, device=dev)
    results = torch.zeros(4, dtype=_I32, device=dev)
    rs = torch.arange(4, dtype=_I32, device=dev).unsqueeze(1)
    for k in range(num_steps):
        if obs is not None:
            obs[k] = emit(bs, board_size)
        actions = sample_bits(bs, board_size, rollout_noise(seed, k, env))
        nxt = step_bits_reference(bs, board_size, actions)
        done = nxt.result != geo.RESULT_OPEN
        episodes = episodes + done.sum(dtype=_I32)
        results = results + (done & (nxt.result == rs)).sum(dim=1, dtype=_I32)
        bs = _reset_done(nxt, init)
    return bs, episodes, results


def bit_random_rollout(seed: int, board_size: int, num_steps: int, bs: BitState):
    """Lockstep random rollout; bit-identical to the JAX
    ``bit_random_rollout`` for the same seed.  Returns
    (final_state, {"episodes", "results"})."""
    bs, episodes, results = rollout_loop(seed, board_size, num_steps, bs)
    return bs, {"episodes": episodes, "results": results}


def bit_rollout_emit_obs(seed: int, board_size: int, num_steps: int, bs: BitState,
                         packed: bool = False):
    """The rollout emitting every step's pre-move observation, batch-leading,
    as the JAX ``bit_rollout_emit_obs``: the same transition and noise as
    :func:`bit_random_rollout`.  Returns (final_state, {"episodes"}, obs).

    ``packed=False``: obs is ``bit_observation_nchw`` in bfloat16 (binary
    planes, so exact), ``[T, B, 12, n, n-2]``.  ``packed=True``: obs is the
    packed learner wire, int32 ``[T, B, 12*P]``."""
    p, batch = bs.red.shape
    dev = bs.red.device
    if packed:
        obs = torch.empty((num_steps, 12, p, batch), dtype=_I32, device=dev)
        bs, episodes, _ = rollout_loop(seed, board_size, num_steps, bs, obs)
        wire = obs.permute(0, 3, 1, 2).reshape(num_steps, batch, 12 * p)
        return bs, {"episodes": episodes}, wire
    from twixt_for_open_spiel_tpu_torch.ops.observe import bit_observation_nchw

    n = board_size
    obs = torch.empty(
        (num_steps, batch, 12, n, n - 2), dtype=torch.bfloat16, device=dev
    )
    bs, episodes, _ = rollout_loop(
        seed, n, num_steps, bs, obs,
        emit=lambda s, size: bit_observation_nchw(s, size, torch.bfloat16),
    )
    return bs, {"episodes": episodes}, obs
