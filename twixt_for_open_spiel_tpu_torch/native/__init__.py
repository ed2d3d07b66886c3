"""Native host-runtime components of the port (C, loaded via ctypes;
``twixt_for_open_spiel_tpu/native``).

  * ``render.c``  — byte-exact ASCII/ANSI renderer (reference
    twixtboard.cc:278-448)
  * ``engine.c``  — single-state host engine: reset/apply/legal/result +
    random-game drivers (reference twixtboard.cc:168-640, twixt.h:31-112),
    wrapped by :mod:`twixt_for_open_spiel_tpu_torch.native.engine`

Both sources are byte-for-byte copies of the JAX package's.  Each is built
on first use with the system compiler (``$CC``, else ``cc``) into
``_build/`` inside the package (gitignored), never beside the sources: a
process compiles to ``<so>.<pid>.tmp`` and renames it into place, so
concurrent builders (test workers, ranks) each load a whole library.
Importing this package builds nothing.

:func:`load_lib` returns None when the build fails (the compiler's output
is kept in :data:`build_errors`); ``game/render.py`` then falls back to the
byte-identical pure-Python renderer, and :class:`engine.NativeEngine`
raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

SRC = Path(__file__).resolve().parent
BUILD = SRC.parent / "_build"

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
build_errors: Dict[str, str] = {}


def _build(stem: str) -> Path:
    """Compile ``<stem>.c`` into ``BUILD`` unless its library is newer than
    the source; return the library's path.  Raises on a failed build."""
    src = SRC / f"{stem}.c"
    so = BUILD / f"_{stem}_c.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent loader sees a whole library
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load_lib(stem: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load ``<stem>.c``; None on failure (cached,
    with the reason in ``build_errors[stem]``)."""
    with _lock:
        if stem not in _libs:
            try:
                _libs[stem] = ctypes.CDLL(str(_build(stem)))
            except (OSError, subprocess.SubprocessError) as e:
                out = getattr(e, "stderr", None) or ""
                build_errors[stem] = f"{e}\n{out}".strip()
                _libs[stem] = None
        return _libs[stem]


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native renderer; None on failure."""
    lib = load_lib("render")
    if lib is not None and not hasattr(lib, "_sigs_set"):
        lib.twixt_render.restype = ctypes.c_size_t
        lib.twixt_render.argtypes = [
            ctypes.c_char_p,  # color int8[n*n]
            ctypes.c_char_p,  # links uint8[n*n]
            ctypes.c_int,     # size
            ctypes.c_bool,    # swapped
            ctypes.c_int,     # result
            ctypes.c_bool,    # ansi
            ctypes.c_char_p,  # out buffer
        ]
        lib.twixt_render_capacity.restype = ctypes.c_size_t
        lib.twixt_render_capacity.argtypes = [ctypes.c_int]
        lib._sigs_set = True
    return lib
