"""Batched arena: head-to-head games between two nets
(``twixt_for_open_spiel_tpu/models/arena.py``).

A whole batch of games is played in lockstep on the bitboard engine, with
one array-of-trees search per move for every board at once.  Both sides
share that search: the leaf evaluator holds both nets and picks per env by
whose turn it is at the leaf (colours alternate by env, so first-move
advantage cancels).  The first ``temp_moves`` plies are sampled from the
visit distribution, later ones are the argmax; no Dirichlet noise.

Randomness (the sampled plies, the random bot's draws, the search's
generator use) comes from one ``torch.Generator``; it agrees with JAX's
``jax.random`` draws in distribution, not bit for bit.  With
``temp_moves=0`` and ``random_b=False`` a match is deterministic and plays
JAX's games move for move.
"""

from __future__ import annotations

import torch

from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.models.network import call_net
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    bit_legal_mask_flat,
    bit_reset,
    bitstate_from_leaves,
    bitstate_leaves,
    _mul_u32,
    sample_bits,
    step_bits,
)


def _dual_net_evaluator(net_apply, board_size: int):
    """Evaluator dispatching between two nets by the leaf's mover.

    ``params`` is ``(params_a, params_b, a_is_red)`` with ``a_is_red`` a
    [B] bool.  Both nets run on every leaf batch (one call when both sides
    hold the same parameters) and side A's output is taken wherever the
    leaf's player to move is A's colour."""
    base = mcts.net_evaluator(net_apply, board_size)

    def evaluate(params, bs, generator):
        params_a, params_b, a_is_red = params
        logits_a, value_a = base(params_a, bs, generator)
        if params_b is params_a:
            return logits_a, value_a
        logits_b, value_b = base(params_b, bs, generator)
        mover = bs.current_player.clamp(0, 1)
        use_a = (mover == 0) == a_is_red                      # [B]
        logits = torch.where(use_a[:, None], logits_a, logits_b)
        value = torch.where(use_a, value_a, value_b)
        return logits, value

    return evaluate


def _categorical(generator, logits):
    """One draw per row from softmax(logits) (Gumbel-max, -inf never)."""
    e = torch.empty_like(logits).exponential_(generator=generator)
    return (logits - e.log()).argmax(-1)


def _select(mask, new, old):
    return bitstate_from_leaves(
        torch.where(mask, a, b) for a, b in zip(bitstate_leaves(new), bitstate_leaves(old))
    )


@torch.no_grad()
def arena_match(params_a, params_b, generator, *, board_size: int, batch: int,
                num_simulations: int, net_apply=call_net, temp_moves: int = 6,
                c_puct: float = 1.4, random_b: bool = False, reuse_a: bool = False,
                search: str = "puct", device="cuda"):
    """Play ``batch`` lockstep games of A vs B; returns the tally.

    Colours alternate by env (A is red in even envs).  Each move runs one
    batched PUCT search over every board with the dual-net evaluator;
    finished boards are frozen (their slot searches a reset state and the
    step is discarded).  With ``random_b`` side B plays uniform random
    legal moves instead.  ``generator`` is a ``torch.Generator`` on
    ``device``; ``net_apply(params, obs)`` runs a side's net (by default
    the params are a torch ``AZNet``).  The host reads ``any(open)`` once a
    move.

    Returns ``{"a_wins", "b_wins", "draws", "games", "moves", "a_score"}``
    as Python numbers (``a_score`` counts draws half) and ``"final_state"``,
    the boards at the end.
    """
    if search == "gumbel":
        raise NotImplementedError(
            "search='gumbel' comes with gumbel_search_batch (ROADMAP Queue 1, item 7)")
    if search != "puct":
        raise ValueError(f"search must be 'puct' or 'gumbel', not {search!r}")
    if reuse_a:
        raise NotImplementedError(
            "reuse_a comes with search_batch_reuse, tree reuse (ROADMAP Queue 1, item 7)")
    n = board_size
    a_is_red = (torch.arange(batch, device=device) % 2) == 0
    bs = bit_reset(n, batch, device)
    dummy = bit_reset(n, batch, device)
    evaluator = _dual_net_evaluator(net_apply, n)
    env = torch.arange(batch, dtype=torch.int64, device=device)
    max_moves = n * n - 3 + 1  # MaxGameLength + 1 safety bound (twixt.h:136-139)
    move = 0
    while move < max_moves:
        open_ = bs.result == geo.RESULT_OPEN
        if not bool(open_.any()):
            break
        safe = _select(open_, bs, dummy)
        player = safe.current_player.clamp(0, 1)
        probs, _ = mcts.search_batch(
            (params_a, params_b, a_is_red), safe, generator,
            evaluator=evaluator, board_size=n, num_simulations=num_simulations,
            c_puct=c_puct, dirichlet_frac=0.0,
        )
        legal = bit_legal_mask_flat(safe, player, n).T
        if move < temp_moves:
            logits = torch.where(legal, torch.log(probs.clamp_min(1e-9)), -torch.inf)
            action = _categorical(generator, logits)
        else:
            action = torch.where(legal, probs, -1.0).argmax(-1)
        if random_b:
            b_to_move = (player == 0) != a_is_red
            seed = torch.randint(0, 1 << 32, (), generator=generator,
                                 device=device, dtype=torch.int64)
            noise = (seed + _mul_u32(env, 0x9E3779B9)) & 0xFFFFFFFF
            action = torch.where(b_to_move, sample_bits(safe, n, noise), action)
        bs = _select(open_, step_bits(safe, n, action), bs)
        move += 1
    return {**_tally(bs.result, a_is_red, batch, move), "final_state": bs}


def _tally(res, a_is_red, batch: int, moves: int) -> dict:
    a_win = ((res == geo.RESULT_RED_WIN) & a_is_red) | (
        (res == geo.RESULT_BLUE_WIN) & ~a_is_red)
    b_win = ((res == geo.RESULT_BLUE_WIN) & a_is_red) | (
        (res == geo.RESULT_RED_WIN) & ~a_is_red)
    draw = (res == geo.RESULT_DRAW) | (res == geo.RESULT_OPEN)
    a_wins, b_wins, draws = (int(x.sum()) for x in (a_win, b_win, draw))
    return {
        "a_wins": a_wins,
        "b_wins": b_wins,
        "draws": draws,
        "games": batch,
        "moves": moves,
        "a_score": (a_wins + 0.5 * draws) / batch,
    }
