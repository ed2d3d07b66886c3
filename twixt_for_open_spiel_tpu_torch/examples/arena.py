"""Arena CLI: pit two checkpoints (or a checkpoint vs random) head to head
(``twixt_for_open_spiel_tpu/examples/arena.py``).

Evaluates bots by playing matches, as OpenSpiel's mcts_example two-bot loop
does (reference README.md:38-40): a whole batch of games runs in lockstep
on the bitboard engine, one batched search per move serving both sides
(``models/arena.py``), on the card (``--cpu``: on the CPU).  A checkpoint
is a directory that ``train_arena_gate.py --checkpoint_dir`` or
``examples/selfplay_train.py`` wrote.

Usage:
    python -m twixt_for_open_spiel_tpu_torch.examples.arena \\
        --board_size=12 --batch=128 --simulations=64 \\
        --ckpt_a=/tmp/twixt_az [--ckpt_b=/tmp/twixt_az_old | --random_b] \\
        --channels=64 --blocks=4
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.models import arena_match, create_net, init_params
from twixt_for_open_spiel_tpu_torch.utils import serialization


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--temp_moves", type=int, default=6)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--ckpt_a", default=None,
                    help="checkpoint dir for side A (fresh init if absent)")
    ap.add_argument("--ckpt_b", default=None,
                    help="checkpoint dir for side B (fresh init if absent)")
    ap.add_argument("--random_b", action="store_true",
                    help="side B plays uniform random legal moves")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="play on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --cpu to run on the CPU\n")

    device = "cpu" if args.cpu else "cuda"
    nets = {}
    for name, seed, ckpt in (("a", args.seed, args.ckpt_a), ("b", args.seed + 1, args.ckpt_b)):
        net = init_params(create_net(args.board_size, channels=args.channels,
                                     blocks=args.blocks, device="cpu"), seed).to(device)
        nets[name] = net
        if not ckpt:
            continue
        restored = serialization.restore_training(ckpt, device)
        if restored is None:
            print(f"no checkpoint in {ckpt} for side {name}", file=sys.stderr)
        else:
            params, _, it = restored
            net.load_state_dict(params)
            print(f"side {name}: restored {ckpt} @ iteration {it}", file=sys.stderr)

    t0 = time.perf_counter()
    out = arena_match(
        nets["a"],
        nets["b"],
        torch.Generator(device).manual_seed(args.seed + 2),
        board_size=args.board_size,
        batch=args.batch,
        num_simulations=args.simulations,
        temp_moves=args.temp_moves,
        random_b=args.random_b,
        device=device,
    )
    dt = time.perf_counter() - t0
    print(
        f"A {int(out['a_wins'])} - B {int(out['b_wins'])} "
        f"(draws {int(out['draws'])}) over {int(out['games'])} games, "
        f"{int(out['moves'])} plies -> A score {out['a_score']:.3f} "
        f"[{dt:.1f}s]"
    )


if __name__ == "__main__":
    main()
