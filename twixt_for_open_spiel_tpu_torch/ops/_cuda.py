"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>.so``
inside the package (listed in ``.gitignore``), for ``sm_90a``, with a plain
C interface: no PyTorch headers, so a build takes seconds.  A library is
rebuilt when its source, or any ``csrc/*.cuh``, is newer than it.

There is no fallback: a missing ``nvcc`` or a failed build raises, with
nvcc's output.  nvcc's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library as ``lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is up to date; return
    the library's path."""
    src = CSRC / f"{name}.cu"
    lib = BUILD / f"lib{name}.so"
    newest = max(f.stat().st_mtime for f in [src, *CSRC.glob("*.cuh")])
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) on {src.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    (BUILD / f"lib{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)))
