"""Time K1 against its plain version on the card and check them bit for bit
(``scripts/bench_fused_bit.py``, ported).

    python3 -m twixt_for_open_spiel_tpu_torch.bench_fused_bit           # on the card
    python3 -m twixt_for_open_spiel_tpu_torch.bench_fused_bit --quick   # tiny, the CPU

At the JAX script's shape (board 12, batch 4096, 1000 steps, seed 7) the
plain ``bit_random_rollout`` and K1 (``fused_bit_rollout``) each run once
to warm up and three times timed (CUDA events, median and min-max); every
leaf of the final state and both counters must be equal.  Prints both
rates, both episode counts and ``state_equal``, and exits 1 unless the
states are equal.

The JAX script takes Pallas tile sizes as positional arguments.  K1 has
none: it runs one warp per env and picks the envs a block itself
(``fused_bit_rollout.envs_per_block``), so positional arguments are
refused.  The plain version alone takes about 80 s on the card, so this
program runs on demand; ``chip_smoke.py`` holds K1 to the same plain
version at its own shapes.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from twixt_for_open_spiel_tpu_torch.bench import warm_then_time
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    bit_random_rollout,
    bit_reset,
    bitstate_leaves,
)
from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import envs_per_block, fused_bit_rollout

SHAPE = {"board_size": 12, "batch": 4096, "steps": 1000}
QUICK_SHAPE = {"board_size": 12, "batch": 64, "steps": 20}
SEED, REPS = 7, 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="a tiny shape on the CPU")
    args, extra = ap.parse_known_args(argv)
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)} (K1 takes no tile: it runs one "
                 f"warp per env and picks the envs a block itself)")
    if not args.quick and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device("cpu" if args.quick else "cuda")
    n, batch, steps = (QUICK_SHAPE if args.quick else SHAPE).values()
    print(f"device={device} n={n} batch={batch} steps={steps} seed={SEED}", file=sys.stderr)
    bs0 = bit_reset(n, batch, device)

    def report(what, ms):
        med = statistics.median(ms)
        return (f"{what}: {batch * steps / med * 1e3 / 1e6} M env-steps/s (median {med} ms, "
                f"min-max {min(ms)}-{max(ms)} ms over {len(ms)})")

    ms_p, out_p = warm_then_time(lambda: bit_random_rollout(SEED, n, steps, bs0), device, REPS)
    print(report("plain", ms_p))
    before = fused_bit_rollout.launches
    ms_k, out_k = warm_then_time(lambda: fused_bit_rollout(SEED, n, steps, bs0), device, REPS)
    if device.type == "cuda" and fused_bit_rollout.launches - before != REPS + 1:
        raise RuntimeError("K1 was not launched on the card")
    equal = all(torch.equal(a, b) for a, b in
                zip(bitstate_leaves(out_p[0]), bitstate_leaves(out_k[0])))
    equal = equal and all(torch.equal(out_p[1][k], out_k[1][k]) for k in ("episodes", "results"))
    what = (f"K1 envs/block={envs_per_block(n, batch, False, device)}" if device.type == "cuda"
            else "K1's wrapper (plain on the CPU)")
    print(f"{report(what, ms_k)}  episodes plain={int(out_p[1]['episodes'])} "
          f"fused={int(out_k[1]['episodes'])}  state_equal={equal}")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
