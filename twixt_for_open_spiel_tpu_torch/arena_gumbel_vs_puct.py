"""Gumbel sequential halving against PUCT with one net
(``scripts/arena_gumbel_vs_puct.py``, ported): does Gumbel reach PUCT's
strength with fewer simulations?

    python -m twixt_for_open_spiel_tpu_torch.arena_gumbel_vs_puct \\
        --ckpt=ckpt --sims_a=16 --sims_b=64 [--batch=256]      # on the card
    python -m twixt_for_open_spiel_tpu_torch.arena_gumbel_vs_puct --quick  # tiny, CPU

``models/arena.arena_match_asym`` plays the same net searching with Gumbel
at ``--sims_a`` simulations (side A, the argmax of its improved policy)
against PUCT without Dirichlet noise at ``--sims_b`` (side B); an
``a_score`` near 0.5 at ``sims_a < sims_b`` supports the claim at that
ratio.  ``--ckpt`` is a training checkpoint of the port
(``utils/serialization.py``; ``train_arena_gate.py --checkpoint_dir``),
else the net is initialised from ``--seed``.  Prints one JSON line, the
JAX script's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.models.arena import arena_match_asym
from twixt_for_open_spiel_tpu_torch.models.network import create_net, init_params
from twixt_for_open_spiel_tpu_torch.utils import serialization


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board_size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims_a", type=int, default=16, help="Gumbel side's simulation budget")
    ap.add_argument("--sims_b", type=int, default=64, help="PUCT side's simulation budget")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--max_considered", type=int, default=16, help="Gumbel candidate count m")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="tiny budget on the CPU")
    args = ap.parse_args(argv)
    if args.quick:
        args.board_size, args.batch = 5, 16
        args.sims_a, args.sims_b = 4, 8
        args.channels, args.blocks = 16, 1
    elif not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.quick else "cuda"
    n = args.board_size
    net = init_params(create_net(n, channels=args.channels, blocks=args.blocks, device="cpu"),
                      args.seed).to(device)
    if args.ckpt:
        restored = serialization.restore_training(args.ckpt, device)
        if restored is None:
            raise SystemExit(f"no checkpoint at {args.ckpt}")
        net.load_state_dict(restored[0])
        print(f"[asym] restored {args.ckpt} @ iter {restored[2]}", file=sys.stderr)

    t0 = time.perf_counter()
    out = arena_match_asym(net, torch.Generator(device=device).manual_seed(args.seed + 1),
                           board_size=n, batch=args.batch, sims_a=args.sims_a,
                           sims_b=args.sims_b, max_considered_a=args.max_considered,
                           device=device)
    tally = {k: float(out[k]) for k in ("a_wins", "b_wins", "draws", "games", "moves", "a_score")}
    tally.update(kind="gumbel_vs_puct", board_size=n, sims_gumbel=args.sims_a,
                 max_considered=args.max_considered, sims_puct=args.sims_b,
                 secs=round(time.perf_counter() - t0, 1))
    print(json.dumps(tally))
    return 0


if __name__ == "__main__":
    sys.exit(main())
