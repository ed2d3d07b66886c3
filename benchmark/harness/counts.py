"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
each measured piece of work needs, from its shapes alone.

Bytes count each input read once and each output written once, whatever a
kernel reads again; nothing here reads a count of any kernel's instructions,
so the same work reads the same whatever implements it.
"""

from __future__ import annotations

from benchmark.reference import net

# NVIDIA H100 SXM, the data sheet's dense rates at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

PAD = 3  # the engine's halo: planes hold n + 2*PAD rows
PLANES = 16  # bit planes of an engine state
SCALARS = 5  # int32 scalars of an engine state
WIRE_PLANES = 12


def padded(n: int) -> int:
    return n + 2 * PAD


def state_bytes(n: int, batch: int) -> int:
    """One engine state of ``batch`` envs: 16 int32 planes, the int16
    component ids, 5 int32 scalars."""
    return batch * (PLANES * padded(n) * 4 + n * n * 2 + SCALARS * 4)


def wire_launch_bytes(n: int, batch: int, steps: int) -> int:
    """A rollout launch emitting the learner wire: the state read and
    written, every step's wire words written (12 int32 planes of P words
    an env), the per-env episode and result counters written."""
    return 2 * state_bytes(n, batch) + steps * WIRE_PLANES * padded(n) * batch * 4 + 5 * batch * 4


def expand_bytes(n: int, batch: int) -> int:
    """The search's expansion (S1a): the parent slot's state read and the
    child's written, the slot and action read (int64), the child's legal
    mask (a byte a cell), terminal flag and value written."""
    return 2 * state_bytes(n, batch) + 16 * batch + batch * n * n + 5 * batch


def env_step_bytes(n: int, batch: int) -> int:
    """One engine step of the envs (the self-play ply's S1a launch): the
    state read and written, the action read (int64)."""
    return 2 * state_bytes(n, batch) + 8 * batch


def select_bytes(n: int, batch: int) -> int:
    """The least a selection walk from the root reads and writes (S1b): the
    root's level of every env (its visit count, its masked prior row of
    n*n float32, the chosen child's action and flag) and the leaf, action
    and child written; the deeper levels depend on the tree and are not
    counted."""
    return batch * (24 + 4 + 4 * n * n + 9)


def forward_flops(config: dict) -> int:
    """One position's forward pass of the configuration's net."""
    return net.forward_flops(config["board_size"], config["channels"], config["blocks"])


def layer_norm_calls(config: dict) -> list:
    """The net's LayerNorm calls a position: (channels, bytes an element,
    epilogue, rows a position)."""
    n, c = config["board_size"], config["channels"]
    cells = n * (n - 2)
    calls = [(c, 2, "relu", cells)]
    calls += [(c, 2, "relu", cells), (c, 2, "residual", cells)] * config["blocks"]
    calls += [(net.HEAD_CHANNELS, 2, "relu", cells)] * 2
    calls.append((net.VALUE_HIDDEN, 4, None, 1))
    return calls


def layer_norm_seconds(config: dict, positions: int, backward: bool) -> float:
    """The least time of the net's LayerNorms over ``positions``: per call
    the larger of its bytes over the HBM peak and its float operations
    (9 an element forward, 22 backward) over the float32 peak.  Forward:
    x and the residual read, the output written, the parameters read.
    Backward: the output's gradient, x and the residual read, the input's
    and the residual's gradients written, the parameters read and their
    gradients written."""
    total = 0.0
    for c, size, epilogue, rows in layer_norm_calls(config):
        rows *= positions
        e = rows * c * size
        res = e if epilogue == "residual" else 0
        if backward:
            nbytes, flops = 3 * e + 2 * res + 16 * c, 22 * rows * c
        else:
            nbytes, flops = 2 * e + res + 8 * c, 9 * rows * c
        total += max(nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS)
    return total
