"""MCTS example runner (``twixt_for_open_spiel_tpu/examples/mcts_example.py``).

Mirror of OpenSpiel's ``mcts_example`` invocations (reference
README.md:38-40):

    python -m twixt_for_open_spiel_tpu_torch.examples.mcts_example \\
        --game="twixt(board_size=12)"
    python -m twixt_for_open_spiel_tpu_torch.examples.mcts_example --game=twixt \\
        --player1=mcts --player2=mcts --max_simulations=200 \\
        --rollout_count=4 --verbose=true

Players: "mcts" (the batched-tree PUCT search with the random-rollout leaf
evaluator — the vanilla-MCTS mode matching OpenSpiel's example) or
"random".  The search is ``models/mcts.py``'s, run at batch 1 on the game's
device: the card, or the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import random

import torch

from twixt_for_open_spiel_tpu_torch.game import load_game
from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.ops.state import State


def make_mcts_player(board_size, max_simulations, rollout_count, seed, device="cuda"):
    """A bot ``play(state) -> (action, root q)`` searching on ``device``
    with a generator there seeded from ``seed``."""
    evaluator = mcts.rollout_evaluator(board_size, rollout_count)
    generator = torch.Generator(device).manual_seed(seed)

    def play(state):
        states = State(*(x[..., None] for x in state.tensor_state))
        probs, root_q = mcts.batched_search(
            None,
            states,
            generator,
            evaluator=evaluator,
            board_size=board_size,
            num_simulations=max_simulations,
        )
        return int(probs[0].argmax()), float(root_q[0])

    return play


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--game", default="twixt")
    ap.add_argument("--player1", default="mcts", choices=["mcts", "random"])
    ap.add_argument("--player2", default="random", choices=["mcts", "random"])
    ap.add_argument("--max_simulations", type=int, default=100)
    ap.add_argument("--rollout_count", type=int, default=1)
    ap.add_argument("--verbose", default="false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run the game and searches on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --cpu to run on the CPU\n")
    verbose = str(args.verbose).lower() in ("1", "true", "yes")

    device = "cpu" if args.cpu else "cuda"
    game = load_game(args.game, device=device)
    n = game.board_size
    rng = random.Random(args.seed)
    bots = []
    for i, kind in enumerate((args.player1, args.player2)):
        if kind == "mcts":
            bots.append(
                make_mcts_player(
                    n, args.max_simulations, args.rollout_count,
                    args.seed + i, device,
                )
            )
        else:
            bots.append(
                lambda state: (rng.choice(state.legal_actions()), 0.0)
            )

    state = game.new_initial_state()
    while not state.is_terminal():
        p = state.current_player()
        action, q = bots[p](state)
        print(
            f"Player {p} -> {state.action_to_string(p, action)}"
            + (f"  (q={q:+.2f})" if verbose else "")
        )
        state.apply_action(action)
        if verbose:
            print(state.to_string())
    print(state.to_string())
    print(f"Returns: {state.returns()}")


if __name__ == "__main__":
    main()
