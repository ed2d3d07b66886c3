"""Batch and grid sweeps of two of the port's kernels on one CUDA card.

    python3 -m twixt_for_open_spiel_tpu_torch.sweep

Measurements for tuning, run on demand (``chip_smoke.py`` does not run
them).  Every timed launch is held against the plain version, so no shape
here passes unchecked:

  * the canonical-engine rollout (``fused_random_rollout``, tile 256), 1000
    steps from the initial state, at batch 4096 and at batches that give
    each of the card's 132 SMs one (8448) or four (33792) of its 64-thread
    blocks; the timed launch's final state, actions and results equal the
    plain version's;
  * the store probe (``store_skeleton``) with the obs stream's bytes at
    board 24 (360 rows, 16 steps, 8192 words a row) over 32 to 256
    programs; each timed output equals the plain version's.

Prints the card's name and power limit, then one line per row, times by
CUDA events.  Exits non-zero on any mismatch and without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from twixt_for_open_spiel_tpu_torch.ops import fused_tensor_rollout as ftr
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll
from twixt_for_open_spiel_tpu_torch.ops import store_skeleton as sk

TENSOR_ROWS = [(8, 4096), (8, 8448), (8, 33792), (24, 4096), (24, 8448)]  # board, batch
TENSOR_STEPS, TENSOR_TILE, TENSOR_THREADS = 1000, 256, 64
STORE_ROWS, STORE_STEPS = 12 * 30, 16
STORE_GRIDS = [(2, 128, 32), (1, 128, 64), (1, 64, 128), (1, 32, 256)]  # subl, lanes, grid
STORE_REPS = 20


def timed(fn):
    """(milliseconds by CUDA events, result) of one call of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


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
        print(f"[K3 sweep] n={n} batch={b} blocks={-(-b // TENSOR_THREADS)} "
              f"steps={TENSOR_STEPS}: {ms} ms -> {b * TENSOR_STEPS / ms * 1e3} env-steps/s; "
              f"equal to the plain version")


def store_rows(dev) -> None:
    for subl, lanes, grid in STORE_GRIDS:
        shape = (STORE_ROWS, STORE_STEPS, subl, lanes, grid)
        want = sk.store_skeleton_reference(*shape, device=dev)
        sk.store_skeleton(*shape, device=dev)  # warm-up
        times = []
        for _ in range(STORE_REPS):
            ms, got = timed(lambda: sk.store_skeleton(*shape, device=dev))
            if not torch.equal(got, want):
                raise RuntimeError(f"store_skeleton != plain at {shape}")
            times.append(ms)
        med = statistics.median(times)
        nbytes = want.numel() * want.element_size()
        print(f"[K4 sweep] subl={subl} lanes={lanes} grid={grid}: median {med} ms of "
              f"{STORE_REPS} -> {nbytes / med / 1e6} GB/s; every output equal to the "
              f"plain version")


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    tensor_rows(dev)
    store_rows(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
