"""Does tree reuse buy playing strength at equal budgets a move?
(``scripts/arena_reuse_vs_cold.py``, ported.)

    python -m twixt_for_open_spiel_tpu_torch.arena_reuse_vs_cold \\
        --checkpoint=ckpt/best --board_size=12 --batch=256 --sims=16,64  # on the card
    python -m twixt_for_open_spiel_tpu_torch.arena_reuse_vs_cold --quick   # tiny, CPU

``models/arena.arena_match(reuse_a=True)``: side A's searches inherit the
game tree's surviving subtree (re-rooted on each played move), side B
starts every move cold; both spend the same simulations a move and colours
alternate by env.  One net, a training checkpoint of the port
(``utils/serialization.py``), drives both sides; ``--quick`` initialises it
from ``--seed`` when no checkpoint is given.  Prints one JSON line a
budget, the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.models.arena import arena_match
from twixt_for_open_spiel_tpu_torch.models.network import create_net, init_params
from twixt_for_open_spiel_tpu_torch.utils import serialization


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default=None, help="required unless --quick")
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", default="16,64")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--temp_moves", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="tiny budget on the CPU")
    args = ap.parse_args(argv)
    if args.quick:
        args.board_size, args.batch, args.sims = 5, 8, "4"
        args.channels, args.blocks = 16, 1
    else:
        if args.checkpoint is None:
            ap.error("--checkpoint is required (or pass --quick)")
        if not torch.cuda.is_available():
            ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.quick else "cuda"
    n = args.board_size
    net = init_params(create_net(n, channels=args.channels, blocks=args.blocks, device="cpu"),
                      args.seed).to(device)
    it = None
    if args.checkpoint:
        restored = serialization.restore_training(args.checkpoint, device)
        if restored is None:
            raise SystemExit(f"no checkpoint at {args.checkpoint}")
        net.load_state_dict(restored[0])
        it = restored[2]
    print(f"[reuse-arena] n={n} batch={args.batch} checkpoint_iter={it}", file=sys.stderr)

    for sims in (int(s) for s in args.sims.split(",") if s):
        t0 = time.perf_counter()
        out = arena_match(net, net, torch.Generator(device=device).manual_seed(args.seed),
                          board_size=n, batch=args.batch, num_simulations=sims,
                          temp_moves=args.temp_moves, reuse_a=True, device=device)
        print(json.dumps({
            "kind": "reuse_vs_cold",
            "sims": sims,
            **{k: float(out[k]) for k in ("a_score", "a_wins", "b_wins", "draws", "games")},
            "secs": round(time.perf_counter() - t0, 1),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
