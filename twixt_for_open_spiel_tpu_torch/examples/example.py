"""Random-game example runner (``twixt_for_open_spiel_tpu/examples/example.py``).

Mirror of OpenSpiel's ``example --game=twixt`` invocation (reference
README.md:36, 42): plays one uniformly random game, printing every action
and board state.  The game runs on the card; ``--cpu`` runs it on the CPU.

Usage:
    python -m twixt_for_open_spiel_tpu_torch.examples.example \\
        --game="twixt(board_size=12,ansi_color_output=False)" --seed=0
"""

from __future__ import annotations

import argparse
import random

import torch

from twixt_for_open_spiel_tpu_torch.game import load_game


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--game", default="twixt")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run the game on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --cpu to run on the CPU\n")

    rng = random.Random(args.seed)
    game = load_game(args.game, device="cpu" if args.cpu else "cuda")
    state = game.new_initial_state()
    print(f"Loaded game: {game}\n")
    while not state.is_terminal():
        player = state.current_player()
        action = rng.choice(state.legal_actions())
        print(
            f"Player {player} sampled action: "
            f"{state.action_to_string(player, action)}"
        )
        state.apply_action(action)
        print(state.to_string())
    returns = state.returns()
    for p in range(game.num_players()):
        print(f"Utility for player {p} is {returns[p]}")


if __name__ == "__main__":
    main()
