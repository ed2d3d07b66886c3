"""Static geometry tables for the TwixT engine, built with numpy at import time.

A copy of ``twixt_for_open_spiel_tpu/ops/geometry.py`` for the PyTorch port:
importing any module of the JAX package imports jax, so the port keeps its
own copy of these framework-neutral tables, and
``tests/test_torch_geometry.py`` pins every table equal to the JAX package's.

Equivalent of the reference's L1 primitives (C1/C2/C4/C5 in
SURVEY.md §2): the ``Compass`` directions (reference twixtcell.h:58-68), the
link-descriptor crossing table (reference twixtboard.cc:38-144) and the
``BlockerMap`` (reference twixtboard.h:142-151).

Instead of transcribing the reference's hand-written crossing table, the table
is *derived* from segment-intersection geometry: a link is a straight segment
between two pegs a knight's move apart, and two links block each other iff
their open segments properly intersect.  ``tests/test_geometry.py`` pins the
derived table against facts implied by the reference table (9 crossers per
direction, symmetry under direction reversal, exact offset sets).

Everything here is plain numpy computed once at import; the torch engine
turns the tables into small tensors, and the CUDA kernel receives
``CROSSERS`` as a constant table.

Coordinate conventions (reference twixtboard.h:153-213):
  * the board is ``size x size`` cells, ``x`` = column (points right),
    ``y`` = row (points up);
  * action id = ``x * size + y``;
  * player 0 ("x", red) connects the two ``y`` borders, player 1 ("o", blue)
    connects the two ``x`` borders;
  * the four corner cells are off-board.
"""

from __future__ import annotations

import numpy as np

# --- players / colors / results (reference twixtcell.h:50-54, twixtboard.h:44-50)
RED = 0
BLUE = 1
NUM_PLAYERS = 2

COLOR_RED = 0
COLOR_BLUE = 1
COLOR_EMPTY = 2
COLOR_OFFBOARD = 3

RESULT_OPEN = 0
RESULT_RED_WIN = 1
RESULT_BLUE_WIN = 2
RESULT_DRAW = 3

BORDER_START = 0
BORDER_END = 1

MIN_BOARD_SIZE = 5
MAX_BOARD_SIZE = 24
DEFAULT_BOARD_SIZE = 8
DEFAULT_ANSI_COLOR_OUTPUT = True

NUM_PLANES = 12  # observation planes (reference twixtboard.h:46)

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

DIR_NAMES = ("NNE", "ENE", "ESE", "SSE", "SSW", "WSW", "WNW", "NNW")


def opp_dir(d: int) -> int:
    """Opposite compass direction (reference twixtboard.cc:28-30)."""
    return (d + NUM_DIRS // 2) % NUM_DIRS


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
