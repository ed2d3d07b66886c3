"""Two saved checkpoints of one net shape head to head
(``scripts/arena_checkpoints.py``, ported).

    python -m twixt_for_open_spiel_tpu_torch.arena_checkpoints --a=runA/best --b=runB/best \\
        [--board_size=8 --batch=256 --sims=64]                   # on the card
    python -m twixt_for_open_spiel_tpu_torch.arena_checkpoints --quick --a=... --b=...  # CPU

The cross-gate of training A/Bs (a PUCT-trained run against a
Gumbel-trained one, reuse against the baseline): each side is a training
checkpoint of the port (``utils/serialization.py``; ``train_arena_gate.py
--checkpoint_dir``), read with ``restore_training`` into a net of
``--channels`` x ``--blocks``; ``models/arena.arena_match`` plays them with
the PUCT arena search at ``--sims`` simulations, colours alternating by
env and moves sampled for the first ``--temp_moves`` plies.  Prints the
JAX script's JSON line; a missing checkpoint ends the program non-zero.
``--quick`` plays board 5, batch 16, 4 simulations with 16x1 nets on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.models.arena import arena_match
from twixt_for_open_spiel_tpu_torch.models.network import create_net
from twixt_for_open_spiel_tpu_torch.utils import serialization


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--board_size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--sims", type=int, default=64)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--temp_moves", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="a tiny match on the CPU")
    args = ap.parse_args(argv)
    if args.quick:
        args.board_size, args.batch, args.sims = 5, 16, 4
        args.channels, args.blocks = 16, 1
    elif not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def load_net(path: str, board_size: int, channels: int, blocks: int, device):
    """The net of a training checkpoint at ``path`` and its iteration;
    ends the program when ``path`` holds none."""
    restored = serialization.restore_training(path, device)
    if restored is None:
        raise SystemExit(f"no checkpoint at {path}")
    net = create_net(board_size, channels, blocks, device=device)
    net.load_state_dict(restored[0])
    return net, restored[2]


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.quick else "cuda"
    n = args.board_size
    net_a, it_a = load_net(args.a, n, args.channels, args.blocks, device)
    net_b, it_b = load_net(args.b, n, args.channels, args.blocks, device)
    print(f"[xarena] n={n} A@{it_a} ({args.a}) vs B@{it_b} ({args.b}) on {device}",
          file=sys.stderr)
    t0 = time.perf_counter()
    out = arena_match(net_a, net_b, torch.Generator(device=device).manual_seed(args.seed),
                      board_size=n, batch=args.batch, num_simulations=args.sims,
                      temp_moves=args.temp_moves, device=device)
    print(json.dumps({
        "kind": "cross_arena", "a": args.a, "b": args.b, "sims": args.sims,
        "a_score": float(out["a_score"]), "a_wins": float(out["a_wins"]),
        "b_wins": float(out["b_wins"]), "draws": float(out["draws"]),
        "games": float(out["games"]), "secs": round(time.perf_counter() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
