"""The store-stream probe in one CUDA kernel, and its plain version.

Port of ``scripts/repro_mosaic_dma_tile.py::build_skeleton`` (kept in the
JAX repo's ``scripts/``): a Pallas TPU kernel with no inputs whose ``grid``
programs each stream ``steps`` slabs of ``rows`` rows through a 2-slot VMEM
buffer into device memory with double-buffered async copies.  On the card
it is ``csrc/store_skeleton.cu``: a persistent grid of about two blocks per
SM, whatever ``grid`` is, walking the output in 16 KB chunks, each staged in
a 4-slot shared-memory ring and stored by one TMA bulk copy.  It computes

    out[k * rows + j, g * subl + s, l] = k + j

and serves as the yardstick for the obs stream of the fused bitboard
rollout (``chip_smoke.py`` times it at that stream's shape, board 24).

The output is int32 here (the JAX kernel's is uint32; every value is small
and non-negative, so the two are equal).  Entry points put their output on
the card unless ``device`` says otherwise: a CPU device runs the plain
version, a CUDA device launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from twixt_for_open_spiel_tpu_torch.ops import _cuda

_I32 = torch.int32


def _check_shape(rows: int, steps: int, subl: int, lanes: int, grid: int) -> None:
    if min(rows, subl, lanes, grid) < 1 or steps < 0:
        raise ValueError(
            f"store_skeleton: bad shape rows={rows} steps={steps} subl={subl} "
            f"lanes={lanes} grid={grid}"
        )


def store_skeleton_reference(rows: int, steps: int, subl: int, lanes: int,
                             grid: int, device="cuda") -> torch.Tensor:
    """The plain torch version: an arange broadcast, int32
    [steps*rows, grid*subl, lanes]."""
    _check_shape(rows, steps, subl, lanes, grid)
    k = torch.arange(steps, dtype=_I32, device=device).reshape(steps, 1)
    j = torch.arange(rows, dtype=_I32, device=device).reshape(1, rows)
    vals = (k + j).reshape(steps * rows, 1, 1)
    return vals.expand(steps * rows, grid * subl, lanes).contiguous()


def store_skeleton(rows: int, steps: int, subl: int, lanes: int, grid: int,
                   device="cuda") -> torch.Tensor:
    """``out[k*rows + j, g*subl + s, l] = k + j``, int32
    [steps*rows, grid*subl, lanes], on ``device``."""
    device = torch.device(device)
    if device.type == "cpu":
        return store_skeleton_reference(rows, steps, subl, lanes, grid, device)
    if device.type != "cuda":
        raise ValueError(f"store_skeleton: no kernel for device {device}")
    return _launch(rows, steps, subl, lanes, grid, device)


store_skeleton.launches = 0  # kernel launches, counted by _launch


@functools.cache
def _kernel():
    fn = _cuda.load("store_skeleton").twixt_store_skeleton
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(rows, steps, subl, lanes, grid, device) -> torch.Tensor:
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes a CUDA device, got {device}")
    _check_shape(rows, steps, subl, lanes, grid)
    if (subl * lanes) % 4:
        raise ValueError(f"subl*lanes = {subl * lanes} is no multiple of 4 (16-byte stores)")
    out = torch.empty((steps * rows, grid * subl, lanes), dtype=_I32, device=device)
    with torch.cuda.device(device):
        rc = _kernel()(
            out.data_ptr(), rows, steps, subl, lanes, grid,
            torch.cuda.current_stream(device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(
                "store_skeleton kernel launch failed: "
                + _cuda.error_string("store_skeleton", rc)
            )
        store_skeleton.launches += 1
    return out
