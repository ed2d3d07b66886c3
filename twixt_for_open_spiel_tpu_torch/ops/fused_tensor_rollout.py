"""The whole lockstep rollout of the canonical engine in one CUDA kernel, and
its plain version.

Port of ``scripts/archive_fused_tensor_rollout.py`` (kept in the JAX repo's
``scripts/``, outside its package): the Pallas TPU kernel
``fused_random_rollout`` becomes the hand-written Hopper kernel
``csrc/fused_tensor_rollout.cu`` (one thread per env, all ``num_steps`` in
one launch), and its transition is ``ops/step.py``'s.  Every action is a
Gumbel-max draw keyed by a counter hash of (seed, program, step, cell, env
in tile), so ``tile`` is part of the function: it names the JAX kernel's
batch tiles, and the stream changes with it.

Dispatch by the tensors' device, with no fallback:

  * CPU tensors run :func:`fused_random_rollout_reference`, the plain torch
    version;
  * CUDA tensors launch the kernel, or raise.

The wrapper never mutates the caller's tensors: the kernel updates int32
copies in place (the JAX kernel's int32 working layout), and the wrapper
converts them back to the canonical dtypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.bitboard import _hash_u32, _M32, _mul_u32
from twixt_for_open_spiel_tpu_torch.ops.rollout import _reset_done
from twixt_for_open_spiel_tpu_torch.ops.state import State, padded_size, reset
from twixt_for_open_spiel_tpu_torch.ops.step import step

_I32 = torch.int32
_I64 = torch.int64
_BIG = 1 << 20
_CELL_DTYPES = (torch.int8, torch.uint8, torch.uint8, torch.int16, torch.uint8)


def program_seed(seed: int, env: torch.Tensor, tile: int) -> torch.Tensor:
    """The per-program seed of each env (u32 in int64): ``seed + program *
    0x01000193`` mod 2^32, ``program = env // tile``."""
    return (seed + (env // tile) * 0x01000193) & _M32


def gumbel_actions(state: State, board_size: int, noise: torch.Tensor,
                   env_in_tile: torch.Tensor) -> torch.Tensor:
    """Gumbel-max legal action per env (int32 [B]), over the whole padded
    board: ``g = -log(-log(max(u, 1e-7)))`` in float32 from the top 24 bits
    of ``hash(cell*0x9E3779B9 + e*0x85EBCA6B + noise)``; ties go to the
    smallest action id.  ``noise`` and ``env_in_tile`` are int64 [B]."""
    p = padded_size(board_size)
    dev = noise.device
    mover = state.current_player.clamp(0, 1)
    legal = torch.where(mover == 0, state.legal[0], state.legal[1])  # [P, P, B]
    xs = torch.arange(p, dtype=_I64, device=dev).reshape(p, 1, 1)
    ys = torch.arange(p, dtype=_I64, device=dev).reshape(1, p, 1)
    cell = xs * p + ys
    bits = _hash_u32(
        _mul_u32(cell, 0x9E3779B9) + _mul_u32(env_in_tile, 0x85EBCA6B) + noise
    )
    u = (bits >> 8).to(_I32).to(torch.float32) * (1.0 / 16777216.0)
    u = torch.maximum(u, torch.tensor(1e-7, dtype=torch.float32, device=dev))
    g = -torch.log(-torch.log(u))
    scores = torch.where(legal, g, -torch.inf)
    m = scores.flatten(0, 1).amax(dim=0)
    idx = (xs - geo.PAD) * board_size + (ys - geo.PAD)
    sel = legal & (scores == m)
    return torch.where(sel, idx, _BIG).flatten(0, 1).amin(dim=0).to(_I32)


def fused_random_rollout_reference(seed: int, board_size: int, num_steps: int,
                                   state: State, *, tile: int = 256):
    """The plain torch version of :func:`fused_random_rollout`, on any
    device."""
    batch = _check_batch(state, tile)
    dev = state.color.device
    env = torch.arange(batch, dtype=_I64, device=dev)
    prog_seed = program_seed(seed, env, tile)
    env_in_tile = env % tile
    init = reset(board_size, dev)
    actions = torch.empty((num_steps, batch), dtype=_I32, device=dev)
    results = torch.empty((num_steps, batch), dtype=_I32, device=dev)
    for k in range(num_steps):
        noise = _hash_u32(prog_seed + ((2654435761 * (k + 1)) & _M32))
        actions[k] = gumbel_actions(state, board_size, noise, env_in_tile)
        nxt = step(state, board_size, actions[k])
        results[k] = nxt.result
        state = _reset_done(nxt, init)
    return state, actions, results


def fused_random_rollout(seed: int, board_size: int, num_steps: int,
                         state: State, *, tile: int = 256):
    """``num_steps`` lockstep random-policy steps of every env, in one kernel
    launch on the card.

    ``state`` carries a 1-D trailing env batch B, with ``B % tile == 0``.
    Returns (final_state, actions int32 [K, B], results int32 [K, B]), where
    ``results`` holds the pre-reset result of every transition
    (RESULT_OPEN if the episode went on).  Bit-identical to the JAX
    ``fused_random_rollout`` for the same ``seed`` and ``tile``.
    """
    device = state.color.device
    if device.type == "cpu":
        return fused_random_rollout_reference(
            seed, board_size, num_steps, state, tile=tile
        )
    if device.type != "cuda":
        raise ValueError(f"fused_random_rollout: no kernel for device {device}")
    return _launch(seed, board_size, num_steps, state, tile)


fused_random_rollout.launches = 0  # kernel launches, counted by _launch


def rollout_stats(results: torch.Tensor) -> dict:
    """Episode counters from the recorded per-step results ([K, B] int32):
    {"episodes": int32 [], "results": int32 [4]}."""
    done = results != geo.RESULT_OPEN
    rs = torch.arange(4, dtype=_I32, device=results.device).reshape(4, 1, 1)
    return {
        "episodes": done.sum(dtype=_I32),
        "results": (done & (results == rs)).sum(dim=(1, 2), dtype=_I32),
    }


def _check_batch(state: State, tile: int) -> int:
    batch = state.current_player.shape[-1] if state.current_player.ndim else 0
    if state.current_player.ndim != 1 or batch < 1:
        raise ValueError("fused_random_rollout wants a 1-D trailing env batch")
    if tile < 1 or batch % tile != 0:
        raise ValueError(f"batch {batch} is not a multiple of tile {tile}")
    return batch


def _check_state(state: State, board_size: int, tile: int) -> int:
    """Raise on any state the kernel does not take; return the batch."""
    if not geo.MIN_BOARD_SIZE <= board_size <= geo.MAX_BOARD_SIZE:
        raise ValueError(f"board_size {board_size} outside 5..24")
    batch = _check_batch(state, tile)
    p = padded_size(board_size)
    want = [((p, p, batch), dt) for dt in _CELL_DTYPES]
    want += [((2, p, p, batch), torch.bool)]
    want += [((batch,), _I32)] * 3 + [((batch,), torch.bool), ((batch,), _I32)]
    for name, leaf, (shape, dtype) in zip(State._fields, state, want):
        if (tuple(leaf.shape), leaf.dtype) != (shape, dtype):
            raise ValueError(
                f"{name}: want shape {shape} dtype {dtype}, got "
                f"{tuple(leaf.shape)} {leaf.dtype}"
            )
        if leaf.device != state.color.device:
            raise ValueError(f"{name} on {leaf.device}, not {state.color.device}")
    return batch


def _cells(state: State) -> torch.Tensor:
    """The board leaves as the kernel's int32 [7, P, P, *B] working copy."""
    return torch.stack([
        state.color.to(_I32), state.links.to(_I32), state.blocked.to(_I32),
        state.compid.to(_I32), state.flags.to(_I32),
        state.legal[0].to(_I32), state.legal[1].to(_I32),
    ])


def _scalars(state: State) -> torch.Tensor:
    return torch.stack([
        state.current_player, state.move_counter, state.move_one,
        state.swapped.to(_I32), state.result,
    ]).to(_I32)


def _from_int32(cells: torch.Tensor, scalars: torch.Tensor) -> State:
    boards = [c.to(dt) for c, dt in zip(cells[:5], _CELL_DTYPES)]
    cur, mc, move_one, swapped, result = scalars.unbind(0)
    return State(
        *boards, legal=cells[5:7] != 0, current_player=cur, move_counter=mc,
        move_one=move_one, swapped=swapped != 0, result=result,
    )


@functools.cache
def _kernel():
    fn = _cuda.load("fused_tensor_rollout").twixt_fused_tensor_rollout
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(seed: int, board_size: int, num_steps: int, state: State, tile: int):
    if state.color.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {state.color.device}")
    batch = _check_state(state, board_size, tile)
    if num_steps < 0:
        raise ValueError(f"num_steps {num_steps} < 0")
    device = state.color.device
    cells = _cells(state).contiguous()
    scalars = _scalars(state).contiguous()
    init = reset(board_size, device)
    init_cells = _cells(init).contiguous()
    init_scalars = _scalars(init).contiguous()
    geo_table = torch.as_tensor(
        list(geo.OFFSETS.reshape(-1)) + list(geo.CROSSERS.reshape(-1)), dtype=_I32
    ).to(device)
    actions = torch.empty((num_steps, batch), dtype=_I32, device=device)
    results = torch.empty((num_steps, batch), dtype=_I32, device=device)

    with torch.cuda.device(device):
        rc = _kernel()(
            cells.data_ptr(), scalars.data_ptr(), actions.data_ptr(),
            results.data_ptr(), init_cells.data_ptr(), init_scalars.data_ptr(),
            geo_table.data_ptr(), seed & 0xFFFFFFFF, board_size, num_steps,
            batch, tile, torch.cuda.current_stream(device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(
                "fused_tensor_rollout kernel launch failed: "
                + _cuda.error_string("fused_tensor_rollout", rc)
            )
        fused_random_rollout.launches += 1
    return _from_int32(cells, scalars), actions, results
