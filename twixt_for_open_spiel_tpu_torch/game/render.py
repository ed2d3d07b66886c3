"""Byte-exact ASCII/ANSI board renderer, host side
(``twixt_for_open_spiel_tpu/game/render.py``, a pinned copy).

Reproduces ``Board::ToString`` and its append helpers (reference
twixtboard.cc:278-448) byte for byte, including ANSI color codes, glyph
overlap/fallback chains and trailing-space behavior — this string IS
``ObservationString`` / ``InformationStateString`` (reference twixt.h:65-75)
and appears verbatim in the golden playthrough.

This is observability/serialization code, not compute: it runs on host
Python over numpy copies of the state arrays.  The boards may be numpy
arrays or torch tensors on any device; a tensor comes to the host once a
call (``.cpu().numpy()``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from twixt_for_open_spiel_tpu_torch import native
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo

ANSI_RED = "\x1b[91m"
ANSI_BLUE = "\x1b[94m"
ANSI_DEFAULT = "\x1b[0m"

# direction constants for glyph probes
_NNE, _ENE, _ESE, _SSE, _SSW, _WSW, _WNW, _NNW = range(8)


def host(board) -> np.ndarray:
    """A board as a numpy array: a torch tensor is copied to the host."""
    if isinstance(board, torch.Tensor):
        return board.detach().cpu().numpy()
    return np.asarray(board)


class _BoardView:
    """Numpy view of one env's board arrays, addressed in board coords."""

    def __init__(self, color, links, size: int):
        self.color = host(color)
        self.links = host(links)
        self.n = size

    def off_board(self, x: int, y: int) -> bool:
        n = self.n
        if x < 0 or x >= n or y < 0 or y >= n:
            return True
        return (x in (0, n - 1)) and (y in (0, n - 1))

    def cell_color(self, x: int, y: int) -> int:
        return int(self.color[x + geo.PAD, y + geo.PAD])

    def has_link(self, x: int, y: int, d: int) -> bool:
        return bool((int(self.links[x + geo.PAD, y + geo.PAD]) >> d) & 1)


def render(
    color,
    links,
    size: int,
    swapped: bool,
    result: int,
    ansi_color_output: bool = True,
) -> str:
    """Render the board string (reference twixtboard.cc:278-335).

    Dispatches to the native C renderer when available (built lazily from
    native/render.c); falls back to the pure-Python implementation below.
    Both are byte-for-byte identical.  Tensors on the card come to the host
    once, here.
    """
    color, links = host(color), host(links)
    out = render_native(color, links, size, swapped, result,
                        ansi_color_output)
    if out is not None:
        return out
    return render_py(color, links, size, swapped, result, ansi_color_output)


def render_native(color, links, size, swapped, result, ansi_color_output):
    """C renderer via ctypes; returns None if the native lib is unavailable."""
    lib = native.load()
    if lib is None:
        return None
    core_color = np.ascontiguousarray(
        host(color)[geo.PAD : geo.PAD + size, geo.PAD : geo.PAD + size],
        dtype=np.int8,
    )
    core_links = np.ascontiguousarray(
        host(links)[geo.PAD : geo.PAD + size, geo.PAD : geo.PAD + size],
        dtype=np.uint8,
    )
    buf = ctypes.create_string_buffer(lib.twixt_render_capacity(size))
    n = lib.twixt_render(
        core_color.tobytes(),
        core_links.tobytes(),
        size,
        bool(swapped),
        int(result),
        bool(ansi_color_output),
        buf,
    )
    return buf.raw[:n].decode("ascii")


def render_py(
    color,
    links,
    size: int,
    swapped: bool,
    result: int,
    ansi_color_output: bool = True,
) -> str:
    """Pure-Python reference renderer (reference twixtboard.cc:278-335)."""
    b = _BoardView(color, links, size)
    out = []

    def colored(color_code: str, text: str) -> None:
        # AppendColorString (twixtboard.cc:350-355)
        if ansi_color_output:
            out.append(color_code)
        out.append(text)
        if ansi_color_output:
            out.append(ANSI_DEFAULT)

    def link_char(x: int, y: int, d: int, ch: str) -> bool:
        # AppendLinkChar (twixtboard.cc:337-348); returns True if appended
        if b.off_board(x, y) or not b.has_link(x, y, d):
            return False
        c = b.cell_color(x, y)
        if c == geo.COLOR_RED:
            colored(ANSI_RED, ch)
        elif c == geo.COLOR_BLUE:
            colored(ANSI_BLUE, ch)
        else:
            out.append(ch)
        return True

    def peg_char(x: int, y: int) -> None:
        # AppendPegChar (twixtboard.cc:357-377)
        c = b.cell_color(x, y)
        if c == geo.COLOR_RED:
            colored(ANSI_RED, "x")
        elif c == geo.COLOR_BLUE:
            colored(ANSI_BLUE, "o")
        elif b.off_board(x, y):
            out.append(" ")
        elif x == 0 or x == size - 1:
            colored(ANSI_BLUE, ".")
        elif y == 0 or y == size - 1:
            colored(ANSI_RED, ".")
        else:
            out.append(".")

    def before_row(x: int, y: int) -> None:
        # AppendBeforeRow (twixtboard.cc:379-403)
        any1 = link_char(x - 1, y, _ENE, "/")
        any1 |= link_char(x - 1, y - 1, _NNE, "/")
        any1 |= link_char(x, y, _WNW, "_")
        if not any1:
            out.append(" ")

        if not link_char(x, y, _NNE, "|"):
            if not link_char(x, y, _NNW, "|"):
                out.append(" ")

        any3 = link_char(x + 1, y, _WNW, "\\")
        any3 |= link_char(x + 1, y - 1, _NNW, "\\")
        any3 |= link_char(x, y, _ENE, "_")
        if not any3:
            out.append(" ")

    def peg_row(x: int, y: int) -> None:
        # AppendPegRow (twixtboard.cc:405-422)
        any1 = link_char(x - 1, y - 1, _NNE, "|")
        any1 |= link_char(x, y, _WSW, "_")
        if not any1:
            out.append(" ")

        peg_char(x, y)

        any3 = link_char(x + 1, y - 1, _NNW, "|")
        any3 |= link_char(x, y, _ESE, "_")
        if not any3:
            out.append(" ")

    def after_row(x: int, y: int) -> None:
        # AppendAfterRow (twixtboard.cc:424-448)
        any1 = link_char(x + 1, y - 1, _WNW, "\\")
        any1 |= link_char(x, y - 1, _NNW, "\\")
        if not any1:
            out.append(" ")

        any2 = link_char(x - 1, y - 1, _ENE, "_")
        any2 |= link_char(x + 1, y - 1, _WNW, "_")
        any2 |= link_char(x, y, _SSW, "|")
        if not any2:
            if not link_char(x, y, _SSE, "|"):
                out.append(" ")

        any3 = link_char(x - 1, y - 1, _ENE, "/")
        any3 |= link_char(x, y - 1, _NNE, "/")
        if not any3:
            out.append(" ")

    # head line (twixtboard.cc:281-289)
    out.append("     ")
    for y in range(size):
        colored(ANSI_RED, chr(ord("a") + y) + "  ")
    out.append("\n")

    for y in range(size - 1, -1, -1):
        out.append("    ")
        for x in range(size):
            before_row(x, y)
        out.append("\n")

        out.append("  " if size - y < 10 else " ")
        colored(ANSI_BLUE, str(size - y) + " ")
        for x in range(size):
            peg_row(x, y)
        out.append("\n")

        out.append("    ")
        for x in range(size):
            after_row(x, y)
        out.append("\n")
    out.append("\n")

    if swapped:
        out.append("[swapped]")
    if result == geo.RESULT_RED_WIN:
        out.append("[x has won]")
    elif result == geo.RESULT_BLUE_WIN:
        out.append("[o has won]")
    elif result == geo.RESULT_DRAW:
        out.append("[draw]")

    return "".join(out)
