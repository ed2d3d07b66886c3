"""Batch and grid sweeps of the port's kernels on one CUDA card.

    python3 -m twixt_for_open_spiel_tpu_torch.sweep

Measurements for tuning, run on demand (``chip_smoke.py`` does not run
them).  Every timed launch is held against the plain version, so no shape
here passes unchecked:

  * the bitboard rollout (``fused_bit_rollout``, K1), 1000 steps from the
    initial state, at board 8 with batch 4096, 8448 and 33792 and at board
    24 with batch 4096 and 8448, with the envs per block the kernel picks;
    and K2 (``emit_obs=True``) at the obs row's shape (board 24, batch 8192,
    16 steps); each timed launch's final state, counters (and wire) equal
    the plain version's;
  * the canonical-engine rollout (``fused_random_rollout``, tile 256), 1000
    steps from the initial state, at batch 4096 and at 8448 and 33792 (64
    and 256 envs a SM on the card's 132 SMs), with the envs per block the
    kernel picks; the timed launch's final state, actions and results equal
    the plain version's;
  * the store probe (``store_skeleton``) with the obs stream's bytes at
    board 24 (360 rows, 16 steps, 8192 words a row) over 32 to 256
    programs (a shape only: the kernel's grid does not follow it), timed
    over launches back to back; each timed output equals the plain
    version's.  Beside it, PyTorch's ``fill_`` of a buffer of the same size
    (a constant, so not K4's function): the card's store rate through a
    plain kernel.

Prints the card's name and power limit, then one line per row, times by
CUDA events.  Exits non-zero on any mismatch and without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr
from twixt_for_open_spiel_tpu_torch.ops import fused_tensor_rollout as ftr
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll
from twixt_for_open_spiel_tpu_torch.ops import store_skeleton as sk

BIT_ROWS = [(8, 4096), (8, 8448), (8, 33792), (24, 4096), (24, 8448)]  # board, batch
BIT_STEPS = 1000
OBS_ROW = (24, 8192, 16)  # board, batch, steps
TENSOR_ROWS = [(8, 4096), (8, 8448), (8, 33792), (24, 4096), (24, 8448)]  # board, batch
TENSOR_STEPS, TENSOR_TILE = 1000, 256
STORE_ROWS, STORE_STEPS = 12 * 30, 16
STORE_GRIDS = [(2, 128, 32), (1, 128, 64), (1, 64, 128), (1, 32, 256)]  # subl, lanes, grid
STORE_REPS, STORE_RUNS = 20, 5


def timed(fn):
    """(milliseconds by CUDA events, result) of one call of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def bit_rows(dev) -> None:
    for n, b, steps, emit in [(n, b, BIT_STEPS, False) for n, b in BIT_ROWS] + [(*OBS_ROW, True)]:
        s0 = tbit.bit_reset(n, b, dev)
        fbr.fused_bit_rollout(0, n, 10, s0, emit_obs=emit)  # warm-up
        ms, got = timed(lambda: fbr.fused_bit_rollout(0, n, steps, s0, emit_obs=emit))
        want = fbr.fused_bit_rollout_reference(0, n, steps, s0, emit_obs=emit)
        pairs = list(zip(tbit.bitstate_leaves(got[0]), tbit.bitstate_leaves(want[0])))
        pairs += [(got[1][k], want[1][k]) for k in ("episodes", "results")]
        pairs += [(got[2], want[2])] if emit else []
        if not all(torch.equal(a, c) for a, c in pairs):
            raise RuntimeError(f"fused_bit_rollout != plain at n={n} batch={b} emit_obs={emit}")
        envs = fbr.envs_per_block(n, b, emit, dev)
        wire = ""
        if emit:
            nbytes = got[2].numel() * got[2].element_size()
            wire = f", obs stream {nbytes / ms / 1e6} GB/s"
        print(f"[K{2 if emit else 1} sweep] n={n} batch={b} envs/block={envs} "
              f"blocks={-(-b // envs)} steps={steps}: {ms} ms -> "
              f"{b * steps / ms * 1e3} env-steps/s{wire}; equal to the plain version")


def tensor_rows(dev) -> None:
    for n, b in TENSOR_ROWS:
        s0 = troll.batch_reset(n, b, dev)
        ftr.fused_random_rollout(0, n, 10, s0, tile=TENSOR_TILE)  # warm-up
        ms, got = timed(
            lambda: ftr.fused_random_rollout(0, n, TENSOR_STEPS, s0, tile=TENSOR_TILE)
        )
        want = ftr.fused_random_rollout_reference(0, n, TENSOR_STEPS, s0, tile=TENSOR_TILE)
        pairs = list(zip(got[0], want[0])) + [(got[1], want[1]), (got[2], want[2])]
        if not all(torch.equal(a, c) for a, c in pairs):
            raise RuntimeError(f"fused_random_rollout != plain at n={n} batch={b}")
        envs = ftr.envs_per_block(n, b, dev)
        print(f"[K3 sweep] n={n} batch={b} envs/block={envs} blocks={-(-b // envs)} "
              f"steps={TENSOR_STEPS}: {ms} ms -> {b * TENSOR_STEPS / ms * 1e3} env-steps/s; "
              f"equal to the plain version")


def store_rows(dev) -> None:
    for subl, lanes, grid in STORE_GRIDS:
        shape = (STORE_ROWS, STORE_STEPS, subl, lanes, grid)
        want = sk.store_skeleton_reference(*shape, device=dev)
        sk.store_skeleton(*shape, device=dev)  # warm-up
        times = []
        for _ in range(STORE_RUNS):
            outs = []
            ms, _ = timed(lambda: [outs.append(sk.store_skeleton(*shape, device=dev))
                                   for _ in range(STORE_REPS)])
            if not all(torch.equal(got, want) for got in outs):
                raise RuntimeError(f"store_skeleton != plain at {shape}")
            times.append(ms / STORE_REPS)
        med = statistics.median(times)
        nbytes = want.numel() * want.element_size()
        print(f"[K4 sweep] subl={subl} lanes={lanes} grid={grid}: median {med} ms of "
              f"{STORE_RUNS} runs of {STORE_REPS} launches -> {nbytes / med / 1e6} GB/s; "
              f"every output equal to the plain version")
    buf = torch.empty_like(want)
    times = [timed(lambda: [buf.fill_(7) for _ in range(STORE_REPS)])[0] / STORE_REPS
             for _ in range(STORE_RUNS)]
    med = statistics.median(times)
    print(f"[K4 sweep] fill_ of the same {nbytes} bytes: median {med} ms of {STORE_RUNS} "
          f"runs of {STORE_REPS} -> {nbytes / med / 1e6} GB/s")


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    bit_rows(dev)
    tensor_rows(dev)
    store_rows(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
