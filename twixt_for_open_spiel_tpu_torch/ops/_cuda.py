"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>.so``
inside the package (listed in ``.gitignore``), for ``sm_90a``, with a plain
C interface: no PyTorch headers, so a build takes seconds.  A library is
rebuilt when its source, or any ``csrc/*.cuh``, is newer than it.
:func:`build` starts one nvcc per out-of-date source, all at once.

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


def build(*names: str) -> list:
    """Compile each ``csrc/<name>.cu`` whose library is out of date, all
    nvcc processes started together; return the libraries' paths."""
    libs, jobs = [], []
    for name in names:
        src = CSRC / f"{name}.cu"
        lib = BUILD / f"lib{name}.so"
        libs.append(lib)
        newest = max(f.stat().st_mtime for f in [src, *CSRC.glob("*.cuh")])
        if lib.exists() and lib.stat().st_mtime >= newest:
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        jobs.append((name, src, lib, tmp, proc))
    failed = []
    for name, src, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}) on {src.name}:\n{out}{err}")
            continue
        (BUILD / f"lib{name}.log").write_text(out + err)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)[0]))


def error_string(name: str, code: int) -> str:
    """CUDA's message for an error code that a launch in ``csrc/<name>.cu``
    returned (each library exports ``twixt_cuda_error_string``)."""
    fn = load(name).twixt_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()
