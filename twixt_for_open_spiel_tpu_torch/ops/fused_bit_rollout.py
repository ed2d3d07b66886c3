"""The whole lockstep rollout in one CUDA kernel, and its plain version.

Port of ``twixt_for_open_spiel_tpu/ops/fused_bit_rollout.py``: the Pallas
TPU kernel becomes the hand-written Hopper kernel
``csrc/fused_bit_rollout.cu`` (one thread per env, all ``num_steps`` in one
launch, state updated in place in device memory).  Both arms of the TPU
kernel are one kernel here: ``emit_obs=True`` adds plain stores of the
per-step packed wire into ``obs[T, 12, P, B]``.

Dispatch by the tensors' device, with no fallback:

  * CPU tensors run :func:`fused_bit_rollout_reference`, the plain torch
    version (``ops/bitboard.py``'s rollout loop);
  * CUDA tensors launch the kernel, or raise.

The TPU-only arguments of the JAX function (``tile``, ``interpret``,
``obs_dma``, ``tile_guard``) do not exist here, nor its rule that the batch
be a multiple of the tile: the kernel masks the ragged edge.  Like the JAX
function, the wrapper never mutates the caller's tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    BitState,
    bit_reset,
    bitstate_from_leaves,
    bitstate_leaves,
    rollout_loop,
)
from twixt_for_open_spiel_tpu_torch.ops.state import padded_size

_I32 = torch.int32
_NUM_PLANES = 16


def fused_bit_rollout_reference(seed: int, board_size: int, num_steps: int,
                                bs: BitState, *, emit_obs: bool = False):
    """The plain torch version of :func:`fused_bit_rollout`, on any device."""
    p, batch = bs.red.shape
    obs = None
    if emit_obs:
        obs = torch.empty(
            (num_steps, 12, p, batch), dtype=_I32, device=bs.red.device
        )
    final, episodes, results = rollout_loop(seed, board_size, num_steps, bs, obs)
    stats = {"episodes": episodes, "results": results}
    return (final, stats, obs) if emit_obs else (final, stats)


def fused_bit_rollout(seed: int, board_size: int, num_steps: int, bs: BitState,
                      *, emit_obs: bool = False):
    """``num_steps`` lockstep random-policy steps of every env.

    ``bs`` carries a 1-D trailing env batch.  Returns (final_state,
    {"episodes": int32 [], "results": int32 [4]}), and with ``emit_obs``
    also the pre-move packed wire of every step, int32 [T, 12, P, B]
    (bit-equal to the JAX kernel's u32 words).  Bit-identical to
    ``bitboard.bit_random_rollout`` for the same seed.
    """
    device = bs.red.device
    if device.type == "cpu":
        return fused_bit_rollout_reference(
            seed, board_size, num_steps, bs, emit_obs=emit_obs
        )
    if device.type != "cuda":
        raise ValueError(f"fused_bit_rollout: no kernel for device {device}")
    return _launch(seed, board_size, num_steps, bs, emit_obs)


fused_bit_rollout.launches = 0  # kernel launches, counted by _launch


def _check_state(bs: BitState, board_size: int) -> None:
    """Raise on any state the kernel does not take."""
    if not geo.MIN_BOARD_SIZE <= board_size <= geo.MAX_BOARD_SIZE:
        raise ValueError(f"board_size {board_size} outside 5..24")
    p = padded_size(board_size)
    if bs.red.ndim != 2 or bs.red.shape[0] != p or bs.red.shape[1] < 1:
        raise ValueError(f"planes must be [{p}, B], got {tuple(bs.red.shape)}")
    batch = bs.red.shape[1]
    leaves = bitstate_leaves(bs)
    for i, leaf in enumerate(leaves):
        if i < _NUM_PLANES:
            want = ((p, batch), _I32)
        elif i == _NUM_PLANES:
            want = ((board_size, board_size, batch), torch.int16)
        else:
            want = ((batch,), _I32)
        if (tuple(leaf.shape), leaf.dtype) != want:
            raise ValueError(
                f"leaf {i}: want shape {want[0]} dtype {want[1]}, got "
                f"{tuple(leaf.shape)} {leaf.dtype}"
            )
        if leaf.device != bs.red.device:
            raise ValueError(f"leaf {i} on {leaf.device}, not {bs.red.device}")


@functools.cache
def _kernel():
    fn = _cuda.load("fused_bit_rollout").twixt_fused_bit_rollout
    fn.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(seed: int, board_size: int, num_steps: int, bs: BitState,
            emit_obs: bool):
    if bs.red.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {bs.red.device}")
    _check_state(bs, board_size)
    if num_steps < 0:
        raise ValueError(f"num_steps {num_steps} < 0")
    device = bs.red.device
    p, batch = bs.red.shape
    leaves = bitstate_leaves(bs)
    # fresh, contiguous copies that the kernel updates in place
    planes = torch.stack(leaves[:_NUM_PLANES])  # [16, P, B]
    compid = leaves[_NUM_PLANES].clone(memory_format=torch.contiguous_format)
    scalars = torch.stack(leaves[_NUM_PLANES + 1 :])  # [5, B]
    # the batch-1 initial state of the auto-reset, from the plain reset
    init = bitstate_leaves(bit_reset(board_size, 1, device))
    init_planes = torch.stack(init[:_NUM_PLANES])[..., 0].contiguous()
    init_compid = init[_NUM_PLANES][..., 0].contiguous()
    init_scalars = torch.stack(init[_NUM_PLANES + 1 :])[:, 0].contiguous()
    geo_table = torch.as_tensor(
        list(geo.OFFSETS.reshape(-1)) + list(geo.CROSSERS.reshape(-1)),
        dtype=_I32,
    ).to(device)
    episodes = torch.empty(batch, dtype=_I32, device=device)
    results = torch.empty((4, batch), dtype=_I32, device=device)
    obs = None
    if emit_obs:
        obs = torch.empty((num_steps, 12, p, batch), dtype=_I32, device=device)

    with torch.cuda.device(device):
        rc = _kernel()(
            planes.data_ptr(), compid.data_ptr(), scalars.data_ptr(),
            episodes.data_ptr(), results.data_ptr(),
            obs.data_ptr() if emit_obs else None,
            init_planes.data_ptr(), init_compid.data_ptr(),
            init_scalars.data_ptr(), geo_table.data_ptr(),
            seed & 0xFFFFFFFF, board_size, num_steps, batch,
            torch.cuda.current_stream(device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(
                "fused_bit_rollout kernel launch failed: "
                + _cuda.error_string("fused_bit_rollout", rc)
            )
        fused_bit_rollout.launches += 1

    final = bitstate_from_leaves(
        [*planes.unbind(0), compid, *scalars.unbind(0)]
    )
    stats = {
        "episodes": episodes.sum(dtype=_I32),
        "results": results.sum(dim=1, dtype=_I32),
    }
    return (final, stats, obs) if emit_obs else (final, stats)
