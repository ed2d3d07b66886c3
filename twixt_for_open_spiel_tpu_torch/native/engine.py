"""ctypes wrapper for the native C host engine (native/engine.c;
``twixt_for_open_spiel_tpu/native/engine.py``, the same signatures).

The host-runtime analogue of the reference's C++ board engine
(twixtboard.cc:168-640): a fast single-state engine for host-driven play and
for deep randomized cross-checking of the torch tensor/bitboard engines
(identical trajectories through the Python oracle, this engine, and the
port's engines must land on identical states).

Returns ``None`` from :func:`load_engine` when the build failed;
:class:`NativeEngine`, :func:`random_game` and :func:`random_games` then
raise, naming the compiler's error.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from twixt_for_open_spiel_tpu_torch.native import build_errors, load_lib

MAXN = 24
RESULT_NAMES = ("open", "red win", "blue win", "draw")


def load_engine() -> Optional[ctypes.CDLL]:
    lib = load_lib("engine")
    if lib is None:
        return None
    if not getattr(lib, "_engine_sigs", False):
        c, u8p, i32p = ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(
            ctypes.c_int32
        )
        lib.twixt_engine_sizeof.restype = c
        lib.twixt_engine_reset.argtypes = [ctypes.c_void_p, c]
        lib.twixt_engine_apply.restype = c
        lib.twixt_engine_apply.argtypes = [ctypes.c_void_p, c]
        for name in (
            "current",
            "result",
            "move_counter",
            "swapped",
            "move_one",
        ):
            fn = getattr(lib, f"twixt_engine_{name}")
            fn.restype = c
            fn.argtypes = [ctypes.c_void_p]
        lib.twixt_engine_legal_mask.restype = c
        lib.twixt_engine_legal_mask.argtypes = [ctypes.c_void_p, c, u8p]
        lib.twixt_engine_snapshot.argtypes = [ctypes.c_void_p] + [u8p] * 4
        lib.twixt_engine_random_game.restype = c
        lib.twixt_engine_random_game.argtypes = [
            c,
            ctypes.c_uint64,
            i32p,
            c,
            i32p,
        ]
        lib.twixt_engine_random_games.restype = ctypes.c_long
        lib.twixt_engine_random_games.argtypes = [
            c,
            ctypes.c_uint64,
            c,
            i32p,
        ]
        lib._engine_sigs = True
    return lib


def _unavailable() -> RuntimeError:
    return RuntimeError(
        f"native engine unavailable: {build_errors.get('engine', 'not built')}")


class NativeEngine:
    """One sequential TwixT game on the C engine (oracle-compatible API)."""

    def __init__(self, size: int):
        lib = load_engine()
        if lib is None:
            raise _unavailable()
        self._lib = lib
        self.n = size
        self._buf = ctypes.create_string_buffer(lib.twixt_engine_sizeof())
        lib.twixt_engine_reset(self._buf, size)

    # --- accessors mirroring tests/oracle.py
    @property
    def current(self) -> int:
        return self._lib.twixt_engine_current(self._buf)

    @property
    def result(self) -> int:
        return self._lib.twixt_engine_result(self._buf)

    @property
    def move_counter(self) -> int:
        return self._lib.twixt_engine_move_counter(self._buf)

    @property
    def swapped(self) -> bool:
        return bool(self._lib.twixt_engine_swapped(self._buf))

    def is_terminal(self) -> bool:
        return self.result != 0

    def legal_mask(self, player: Optional[int] = None) -> np.ndarray:
        p = self.current if player is None else player
        out = np.zeros(self.n * self.n, np.uint8)
        self._lib.twixt_engine_legal_mask(
            self._buf, int(p), out.ctypes.data_as(ctypes.c_char_p)
        )
        return out.astype(bool)

    def legal_actions(self, player: Optional[int] = None) -> List[int]:
        if self.is_terminal():
            return []
        return [int(a) for a in np.nonzero(self.legal_mask(player))[0]]

    def apply(self, action: int) -> None:
        rc = self._lib.twixt_engine_apply(self._buf, int(action))
        if rc != 0:
            raise ValueError(f"Not a legal action: {action}")

    def returns(self) -> List[float]:
        r = self.result
        if r == 1:
            return [1.0, -1.0]
        if r == 2:
            return [-1.0, 1.0]
        return [0.0, 0.0]

    def snapshot(self):
        """(color i8, links u8, blocked u8, flags u8) flat [n*n] arrays."""
        n2 = self.n * self.n
        color = np.zeros(n2, np.int8)
        links = np.zeros(n2, np.uint8)
        blocked = np.zeros(n2, np.uint8)
        flags = np.zeros(n2, np.uint8)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_char_p)  # noqa: E731
        self._lib.twixt_engine_snapshot(
            self._buf, as_p(color), as_p(links), as_p(blocked), as_p(flags)
        )
        return color, links, blocked, flags


def random_game(size: int, seed: int):
    """One full uniform-random game in C; returns (actions list, result)."""
    lib = load_engine()
    if lib is None:
        raise _unavailable()
    cap = size * size + 2
    actions = np.zeros(cap, np.int32)
    result = np.zeros(1, np.int32)
    moves = lib.twixt_engine_random_game(
        size,
        ctypes.c_uint64(seed),
        actions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
        result.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return [int(a) for a in actions[:moves]], int(result[0])


def random_games(size: int, seed: int, num_games: int):
    """num_games full random games in C; returns (total moves, results[4])."""
    lib = load_engine()
    if lib is None:
        raise _unavailable()
    results = np.zeros(4, np.int32)
    total = lib.twixt_engine_random_games(
        size,
        ctypes.c_uint64(seed),
        num_games,
        results.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return int(total), [int(r) for r in results]
