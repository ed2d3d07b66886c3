"""Rollout throughput of the bitboard engine against the canonical engine
on the card (``scripts/bench_bitboard.py``, ported).

    python3 -m twixt_for_open_spiel_tpu_torch.bench_bitboard           # on the card
    python3 -m twixt_for_open_spiel_tpu_torch.bench_bitboard --quick   # tiny, the CPU

The JAX script times its XLA rollouts; here each engine's rollout is its
kernel: the bitboard rows go through K1 (``fused_bit_rollout``) at the JAX
rows (board 12 at batch 4096 and 8192, board 8 at 4096, board 24 at 8192;
seed 12345), and the canonical row (board 12, batch 4096) through K3
(``fused_random_rollout``, tile 256; seed 0), the kernel of the canonical
engine.  1000 steps from the initial state a launch; one warm-up, then
three launches timed by CUDA events (median and min-max).  ``--quick``
runs 20 steps at batch 256 on the CPU through the plain versions.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from twixt_for_open_spiel_tpu_torch.bench import warm_then_time
from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset
from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import fused_bit_rollout
from twixt_for_open_spiel_tpu_torch.ops.fused_tensor_rollout import fused_random_rollout
from twixt_for_open_spiel_tpu_torch.ops.rollout import batch_reset

BIT_ROWS = [(12, 4096), (12, 8192), (8, 4096), (24, 8192)]  # board, batch
CANONICAL_ROWS = [(12, 4096)]
STEPS, REPS, BIT_SEED, CANONICAL_SEED, TILE = 1000, 3, 12345, 0, 256
QUICK_STEPS, QUICK_BATCH = 20, 256


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="20 steps at batch 256 on the CPU")
    args = ap.parse_args(argv)
    if not args.quick and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def row(what: str, n: int, batch: int, steps: int, fn, device) -> float:
    """Time ``fn`` (one launch) after a warm-up; print and return its
    median milliseconds."""
    ms, _ = warm_then_time(fn, device, REPS)
    med = statistics.median(ms)
    print(f"{what} n={n:2d} b={batch:5d}: {batch * steps / med * 1e3} env-steps/s (median "
          f"{med} ms, min-max {min(ms)}-{max(ms)} ms over {REPS})")
    return med


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device("cpu" if args.quick else "cuda")
    steps = QUICK_STEPS if args.quick else STEPS
    print(f"device={device} steps={steps}", file=sys.stderr)
    k1, k3 = fused_bit_rollout.launches, fused_random_rollout.launches
    for n, batch in BIT_ROWS:
        batch = QUICK_BATCH if args.quick else batch
        bs = bit_reset(n, batch, device)
        row("K1" if device.type == "cuda" else "bit (plain)", n, batch, steps,
            lambda: fused_bit_rollout(BIT_SEED, n, steps, bs), device)
    for n, batch in CANONICAL_ROWS:
        batch = QUICK_BATCH if args.quick else batch
        st = batch_reset(n, batch, device)
        row("K3" if device.type == "cuda" else "canonical (plain)", n, batch, steps,
            lambda: fused_random_rollout(CANONICAL_SEED, n, steps, st, tile=TILE), device)
    k1, k3 = fused_bit_rollout.launches - k1, fused_random_rollout.launches - k3
    print(f"kernel launches: K1 {k1}, K3 {k3}", file=sys.stderr)
    if device.type == "cuda" and not (k1 and k3):
        raise RuntimeError("a row on the card launched no kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
