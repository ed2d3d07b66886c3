"""Does a cheap gate agree with the full one on a trained checkpoint?
(``scripts/arena_gate_agreement.py``, ported.)

    python -m twixt_for_open_spiel_tpu_torch.arena_gate_agreement --ckpt=run --board_size=12
    python -m twixt_for_open_spiel_tpu_torch.arena_gate_agreement --quick --ckpt=run  # CPU

Replays a training run's gate matchups with each gate setting of
``--settings`` (search:simulations, by default Gumbel at 16 against PUCT at
64): the run's best checkpoint (``<ckpt>/best``, written by
``train_arena_gate.py --checkpoint_dir``) against the nets that
``train_arena_gate.py`` initialises from ``--seed`` (``vs_init``), and
against the uniform random bot (``vs_random``,
``arena_match(random_b=True)``).  One JSON line a
matchup, the JAX script's, four with the default settings; a missing
checkpoint ends the program non-zero.  ``--quick`` plays board 5, batch 8,
``gumbel:4,puct:4`` with 16x1 nets on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.arena_checkpoints import load_net
from twixt_for_open_spiel_tpu_torch.models.arena import arena_match
from twixt_for_open_spiel_tpu_torch.models.network import create_net, init_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="train_arena_gate checkpoint dir (best/ inside)")
    ap.add_argument("--board_size", type=int, default=None, help="required without --quick")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0,
                    help="the training run's seed (for the init nets)")
    ap.add_argument("--settings", default="gumbel:16,puct:64",
                    help="comma-separated search:sims gate settings")
    ap.add_argument("--quick", action="store_true", help="tiny matches on the CPU")
    args = ap.parse_args(argv)
    if args.quick:
        args.board_size, args.batch, args.settings = 5, 8, "gumbel:4,puct:4"
        args.channels, args.blocks = 16, 1
    elif args.board_size is None:
        ap.error("--board_size is required")
    elif not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.quick else "cuda"
    n = args.board_size
    best_dir = os.path.join(args.ckpt, "best")
    best, best_it = load_net(best_dir, n, args.channels, args.blocks, device)
    # train_arena_gate.py's initial nets: seeded on the CPU, then moved
    init = init_params(create_net(n, args.channels, args.blocks, device="cpu"),
                       args.seed).to(device)
    print(f"[agree] device={device} n={n} best_iteration={best_it}", file=sys.stderr)

    gen = torch.Generator(device=device).manual_seed(args.seed + 777)
    for setting in args.settings.split(","):
        search, sims = setting.split(":")
        sims = int(sims)
        for label, random_b in (("vs_init", False), ("vs_random", True)):
            t0 = time.perf_counter()
            tally = arena_match(best, best if random_b else init, gen, board_size=n,
                                batch=args.batch, num_simulations=sims, random_b=random_b,
                                search=search, device=device)
            print(json.dumps({
                "board": n, "gate": label, "search": search, "sims": sims,
                "a_score": float(tally["a_score"]), "a_wins": float(tally["a_wins"]),
                "b_wins": float(tally["b_wins"]), "draws": float(tally["draws"]),
                "games": float(tally["games"]), "secs": round(time.perf_counter() - t0, 1),
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
