"""One lockstep engine step over slot-indexed state in one CUDA kernel (S1a),
and its plain version.

The search keeps every tree node's state in stacked buffers, a slot a node
(``planes`` [S, 16, P, B], ``compid`` [S, n, n, B], ``scalars`` [S, 5, B],
env trailing).  Its expansion reads each env's parent slot, steps it, takes
the new mover's legal mask and the child's terminal flag and value, and
writes the child into one slot: in the JAX search XLA fuses that
(``twixt_for_open_spiel_tpu/models/mcts.py`` ``_gather_node_state`` and
``_set_node_state`` around ``ops/bitboard.py``'s ``step_bits`` and
``bit_legal_mask_flat``, and the terminal value of ``mcts.py:380-388``);
here :func:`bit_step` does it in one launch of ``csrc/bit_step.cu``.  With
one source slot and a fresh output buffer the same kernel is the port's
lockstep step on the card (:func:`step_state`, which
``ops/bitboard.py::step_bits`` calls for CUDA tensors).

Dispatch by the tensors' device, with no fallback:

  * CPU tensors run :func:`bit_step_reference`, the plain torch version
    (the slot gather, ``step_bits_reference``, ``bit_legal_mask_flat``, the
    slot write and the terminal value);
  * CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    BitState,
    bit_legal_mask_flat,
    bitstate_leaves,
    step_bits_reference,
)
from twixt_for_open_spiel_tpu_torch.ops.state import padded_size
from twixt_for_open_spiel_tpu_torch.utils.profiling import annotate

_I32 = torch.int32
_I64 = torch.int64
_NUM_PLANES = 16
_NUM_SCALARS = 5


# --- stacked node-state buffers <-> BitState ------------------------------
# plane order: red, blue, links[0..3], blocked[0..3], legal[0..1], flags[0..3]


def stack_planes(bs: BitState) -> torch.Tensor:
    return torch.stack((bs.red, bs.blue) + bs.links + bs.blocked + bs.legal + bs.flags)


def stack_scalars(bs: BitState) -> torch.Tensor:
    return torch.stack([bs.current_player, bs.move_counter, bs.move_one,
                        bs.swapped, bs.result])


def slot_state(planes, compid, scalars) -> BitState:
    """The BitState of one slot's buffers ([16, P, ...], [n, n, ...], [5, ...]),
    as views."""
    return BitState(
        red=planes[0],
        blue=planes[1],
        links=tuple(planes[2 + i] for i in range(4)),
        blocked=tuple(planes[6 + i] for i in range(4)),
        legal=(planes[10], planes[11]),
        flags=tuple(planes[12 + i] for i in range(4)),
        compid=compid,
        current_player=scalars[0],
        move_counter=scalars[1],
        move_one=scalars[2],
        swapped=scalars[3],
        result=scalars[4],
    )


def gather_slots(bufs: tuple, slot: torch.Tensor) -> BitState:
    """Per-env slot state: [S, ..., B] buffers x slot [B] -> [..., B], a
    per-element gather of each env's slot."""
    def leaf(buf):
        idx = slot.reshape((1,) * (buf.ndim - 1) + slot.shape)
        return buf.gather(0, idx.expand((1,) + buf.shape[1:]))[0]

    return slot_state(*(leaf(buf) for buf in bufs))


def outcome_value(result: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """+1 if ``player`` won, 0 on a draw, -1 otherwise (float32)."""
    return torch.where(
        result == geo.RESULT_RED_WIN + player, 1.0,
        torch.where(result == geo.RESULT_DRAW, 0.0, -1.0),
    )


def bit_step_reference(src: tuple, src_slot, action, dst: tuple, dst_slot: int,
                       board_size: int, *, legal: bool = True, outcome=None):
    """The plain torch version of :func:`bit_step`, on any device: gather
    each env's source slot, ``step_bits_reference``, write slot ``dst_slot``
    of ``dst`` (and of ``outcome``'s rows); the new mover's legal mask bool
    [B, n*n] (a view), or None without ``legal``."""
    if src_slot is None:
        parent = slot_state(*(buf[0] for buf in src))
    else:
        parent = gather_slots(src, src_slot)
    child = step_bits_reference(parent, board_size, action)
    planes, compid, scalars = dst
    planes[dst_slot] = stack_planes(child)
    compid[dst_slot] = child.compid
    scalars[dst_slot] = stack_scalars(child)
    if outcome is not None:
        terminal, tval = outcome
        child_terminal = child.result != geo.RESULT_OPEN
        mover = parent.current_player.clamp(0, 1)
        terminal[:, dst_slot] = child_terminal
        tval[:, dst_slot] = torch.where(child_terminal, outcome_value(child.result, mover), 0.0)
    if not legal:
        return None
    return bit_legal_mask_flat(child, child.current_player.clamp(0, 1), board_size).T


def bit_step(src: tuple, src_slot, action, dst: tuple, dst_slot: int, board_size: int, *,
             legal: bool = True, outcome=None):
    """One lockstep step of every env from its slot ``src_slot[b]`` of the
    ``src`` buffers ``(planes int32 [S_in, 16, P, B], compid int16 [S_in, n,
    n, B], scalars int32 [S_in, 5, B])`` (``src_slot`` int64 [B], or None for
    slot 0) on ``action`` [B], into slot ``dst_slot`` of the ``dst`` buffers
    (the same layout; they may be the ``src`` buffers).  With ``outcome`` =
    ``(terminal bool [B, S_out], tval float32 [B, S_out])`` (the search
    tree's rows) column ``dst_slot`` of each takes the child's terminal flag
    and its value for the parent's mover: +1 won, 0 drawn, -1 lost, 0 while
    open.  Returns the new mover's legal mask, bool [B, n*n] in ascending
    action order (``bit_legal_mask_flat(child, player, n).T``), or None
    without ``legal``."""
    device = src[0].device
    with annotate("op.bit_step"):
        if device.type == "cpu":
            return bit_step_reference(src, src_slot, action, dst, dst_slot, board_size,
                                      legal=legal, outcome=outcome)
        if device.type != "cuda":
            raise ValueError(f"bit_step: no kernel for device {device}")
        return _launch(src, src_slot, action, dst, dst_slot, board_size, legal, outcome)


bit_step.launches = 0  # kernel launches, counted by _launch


def _check_bufs(bufs: tuple, board_size: int, batch: int, device, what: str) -> None:
    """Raise on node-state buffers the kernel does not take."""
    if not geo.MIN_BOARD_SIZE <= board_size <= geo.MAX_BOARD_SIZE:
        raise ValueError(f"board_size {board_size} outside 5..24")
    p, n = padded_size(board_size), board_size
    planes = bufs[0]
    slots = planes.shape[0] if planes.ndim else 0
    want = [((slots, _NUM_PLANES, p, batch), _I32), ((slots, n, n, batch), torch.int16),
            ((slots, _NUM_SCALARS, batch), _I32)]
    for name, buf, (shape, dtype) in zip(("planes", "compid", "scalars"), bufs, want):
        if buf.shape != shape or buf.dtype != dtype or slots < 1:
            raise ValueError(f"{what} {name}: want shape {shape} dtype {dtype}, got "
                             f"{tuple(buf.shape)} {buf.dtype}")
        if buf.device != device or not buf.is_contiguous():
            raise ValueError(f"{what} {name}: want a contiguous tensor on {device}")


def _check_outcome(outcome, batch: int, slots: int, device) -> tuple:
    """Raise on ``outcome`` rows the kernel does not take; their pointers."""
    ptrs = []
    for name, buf, dtype in zip(("terminal", "tval"), outcome, (torch.bool, torch.float32)):
        if (buf.shape != (batch, slots) or buf.dtype != dtype or buf.device != device
                or not buf.is_contiguous()):
            raise ValueError(f"outcome {name}: want a contiguous {dtype} [{batch}, {slots}] "
                             f"on {device}, got {buf.dtype} {tuple(buf.shape)} on {buf.device}")
        ptrs.append(buf.data_ptr())
    return ptrs


_KERNEL = None  # the ctypes entry point, bound at the first launch
_GEOMETRY_SET = set()  # the devices whose constant geometry table is set


def _bind():
    global _KERNEL
    fn = _cuda.load("bit_step").twixt_bit_step
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _KERNEL = fn


def _set_geometry(index: int) -> None:
    """Copy K1's geometry table (``_cuda.geo_table``) into the kernel's
    constant memory on the current device, ``index``, once."""
    fn = _cuda.load("bit_step").twixt_bit_step_set_geometry
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    table = _cuda.geo_table(torch.device("cpu"))
    rc = fn(table.data_ptr(), table.numel())
    if rc != 0:
        raise RuntimeError("bit_step geometry table: " + _cuda.error_string("bit_step", rc))
    _GEOMETRY_SET.add(index)


def _launch(src, src_slot, action, dst, dst_slot, board_size, legal, outcome=None):
    device = src[0].device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {device}")
    index = device.index
    if index != torch.cuda.current_device():  # a stream takes its own device's launches
        with torch.cuda.device(index):
            return _launch(src, src_slot, action, dst, dst_slot, board_size, legal, outcome)
    batch = src[0].shape[-1] if src[0].ndim else 0
    _check_bufs(src, board_size, batch, device, "source")
    if dst is not src:  # the search steps in place: the same tensors, checked
        _check_bufs(dst, board_size, batch, device, "destination")
    slots_out = dst[0].shape[0]
    if not 0 <= dst_slot < slots_out:
        raise ValueError(f"destination slot {dst_slot} outside 0..{slots_out - 1}")
    terminal = tval = None
    if outcome is not None:
        terminal, tval = _check_outcome(outcome, batch, slots_out, device)
        terminal, tval = terminal + dst_slot, tval + 4 * dst_slot
    if batch == 0:
        return torch.empty((0, board_size * board_size), dtype=torch.bool,
                           device=device) if legal else None
    if not (isinstance(action, torch.Tensor) and action.dtype == _I64
            and action.shape == (batch,) and action.device == device
            and action.is_contiguous()):
        action = torch.as_tensor(action, device=device).to(_I64).expand(batch).contiguous()
    if src_slot is not None:
        if src_slot.shape != (batch,) or src_slot.device != device:
            raise ValueError(f"source slots: want [{batch}] on {device}")
        if src_slot.dtype != _I64 or not src_slot.is_contiguous():
            src_slot = src_slot.to(_I64).contiguous()
    mask = None
    if legal:
        mask = torch.empty((batch, board_size * board_size), dtype=torch.bool, device=device)
    planes, compid, scalars = src
    out_planes, out_compid, out_scalars = dst
    if _KERNEL is None:
        _bind()
    if index not in _GEOMETRY_SET:
        _set_geometry(index)
    rc = _KERNEL(
        planes.data_ptr(), compid.data_ptr(), scalars.data_ptr(),
        None if src_slot is None else src_slot.data_ptr(), action.data_ptr(),
        out_planes.data_ptr(), out_compid.data_ptr(), out_scalars.data_ptr(),
        dst_slot, None if mask is None else mask.data_ptr(), terminal, tval, slots_out,
        board_size, batch, planes.shape[0], torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError("bit_step kernel launch failed: " + _cuda.error_string("bit_step", rc))
    bit_step.launches += 1
    return mask


def one_slot(bs: BitState) -> tuple:
    """The env batch of ``bs`` (any trailing shape) as slot 0 of new
    node-state buffers ``(planes [1, 16, P, B], compid [1, n, n, B],
    scalars [1, 5, B])``, B the batch's size."""
    batch = bs.current_player.numel()
    n, p = bs.compid.shape[0], bs.red.shape[0]
    leaves = bitstate_leaves(bs)
    return (torch.stack(leaves[:_NUM_PLANES]).reshape(1, _NUM_PLANES, p, batch),
            leaves[_NUM_PLANES].reshape(1, n, n, batch).contiguous(),
            torch.stack(leaves[_NUM_PLANES + 1:]).reshape(1, _NUM_SCALARS, batch))


def slot_as(bufs: tuple, shape: tuple) -> BitState:
    """Slot 0 of node-state buffers as a BitState of trailing shape
    ``shape`` (views): :func:`one_slot`'s inverse."""
    planes, compid, scalars = (buf[0] for buf in bufs)
    n, p = compid.shape[0], planes.shape[1]
    return slot_state(planes.reshape((_NUM_PLANES, p) + shape),
                      compid.reshape((n, n) + shape),
                      scalars.reshape((_NUM_SCALARS,) + shape))


def step_state(bs: BitState, board_size: int, action) -> BitState:
    """``step_bits`` on the card: the env batch (any trailing shape) as one
    source slot, stepped by the kernel into a fresh one; the caller's
    tensors are not written."""
    device = bs.red.device
    if device.type != "cuda":
        raise ValueError(f"step_state: the kernel takes CUDA tensors, got {device}")
    shape = tuple(bs.current_player.shape)
    src = one_slot(bs)
    dst = tuple(torch.empty_like(buf) for buf in src)
    action = torch.as_tensor(action, device=device).expand(shape).reshape(-1)
    bit_step(src, None, action, dst, 0, board_size, legal=False)
    return slot_as(dst, shape)
