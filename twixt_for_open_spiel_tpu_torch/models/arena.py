"""Batched arena: head-to-head games between two nets
(``twixt_for_open_spiel_tpu/models/arena.py``).

A whole batch of games is played in lockstep on the bitboard engine, with
one array-of-trees search per move for every board at once.  Both sides
share that search: the leaf evaluator holds both nets and picks per env by
whose turn it is at the leaf (colours alternate by env, so first-move
advantage cancels).  The first ``temp_moves`` plies are sampled from the
visit distribution (or Gumbel's improved policy), later ones are the
argmax; no Dirichlet noise.  ``arena_match_asym`` pits one net's Gumbel
search against its PUCT search.

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
    """One draw per row from softmax(logits) (Gumbel-max, -inf never).

    An exponential draw of exactly 0 would make an action at -inf
    ``-inf - (-inf)``, NaN, which ``argmax`` takes; such actions stay at
    -inf instead (``jax.random.categorical`` never draws them either)."""
    e = torch.empty_like(logits).exponential_(generator=generator)
    return torch.where(logits == -torch.inf, logits, logits - e.log()).argmax(-1)


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
    batched search over every board with the dual-net evaluator; finished
    boards are frozen (their slot searches a reset state and the step is
    discarded).  ``search="puct"`` plays from the visit counts,
    ``"gumbel"`` from Gumbel's improved policy (evaluation mode: the
    Gumbels only pick the candidates inside the search).  With ``reuse_a``
    (PUCT only) the game's tree is carried from ply to ply and re-rooted on
    the move played, but only A's moves inherit it; B's start cold, so both
    sides spend the same simulations and differ only in reuse.  With
    ``random_b`` side B plays uniform random legal moves instead.
    ``generator`` is a ``torch.Generator`` on ``device``; ``net_apply(params,
    obs)`` runs a side's net (by default the params are a torch ``AZNet``).
    The host reads ``any(open)`` once a move.

    Returns ``{"a_wins", "b_wins", "draws", "games", "moves", "a_score"}``
    as Python numbers (``a_score`` counts draws half) and ``"final_state"``,
    the boards at the end.
    """
    if search not in ("puct", "gumbel"):
        raise ValueError(f"search must be 'puct' or 'gumbel', not {search!r}")
    if reuse_a and search == "gumbel":
        raise ValueError("reuse_a is PUCT-only")
    n = board_size
    a_is_red = (torch.arange(batch, device=device) % 2) == 0
    bs = bit_reset(n, batch, device)
    dummy = bit_reset(n, batch, device)
    evaluator = _dual_net_evaluator(net_apply, n)
    params = (params_a, params_b, a_is_red)
    kw = dict(evaluator=evaluator, board_size=n, num_simulations=num_simulations,
              c_puct=c_puct)
    env = torch.arange(batch, dtype=torch.int64, device=device)
    if reuse_a:
        tree = mcts.init_reuse_tree(bs, board_size=n, num_simulations=num_simulations)
        played = torch.full((batch,), -1, dtype=torch.int32, device=device)
    max_moves = n * n - 3 + 1  # MaxGameLength + 1 safety bound (twixt.h:136-139)
    move = 0
    while move < max_moves:
        open_ = bs.result == geo.RESULT_OPEN
        if not bool(open_.any()):
            break
        safe = _select(open_, bs, dummy)
        player = safe.current_player.clamp(0, 1)
        if reuse_a:
            a_to_move = (player == 0) == a_is_red
            probs, _, tree = mcts.search_batch_reuse(
                params, safe, generator, tree, played, ~(a_to_move & open_),
                dirichlet_frac=0.0, **kw)
        elif search == "gumbel":
            _, probs, _ = mcts.gumbel_search_batch(params, safe, generator, **kw)
        else:
            probs, _ = mcts.search_batch(params, safe, generator, dirichlet_frac=0.0, **kw)
        action = _play(generator, probs, bit_legal_mask_flat(safe, player, n).T,
                       move < temp_moves)
        if random_b:
            b_to_move = (player == 0) != a_is_red
            seed = torch.randint(0, 1 << 32, (), generator=generator,
                                 device=device, dtype=torch.int64)
            noise = (seed + _mul_u32(env, 0x9E3779B9)) & 0xFFFFFFFF
            action = torch.where(b_to_move, sample_bits(safe, n, noise), action)
        bs = _select(open_, step_bits(safe, n, action), bs)
        if reuse_a:
            played = action.to(torch.int32)
        move += 1
    return {**_tally(bs.result, a_is_red, batch, move), "final_state": bs}


def _play(generator, probs, legal, sample: bool):
    """A draw from ``probs`` masked to ``legal``, or its argmax (the first
    maximum), per env."""
    if sample:
        logits = torch.where(legal, torch.log(probs.clamp_min(1e-9)), -torch.inf)
        return _categorical(generator, logits)
    return torch.where(legal, probs, -1.0).argmax(-1)


@torch.no_grad()
def arena_match_asym(params, generator, *, board_size: int, batch: int, sims_a: int,
                     sims_b: int, net_apply=call_net, temp_moves: int = 6,
                     c_puct: float = 1.4, greedy_a: bool = True,
                     max_considered_a: int = 16, device="cuda"):
    """One net, two searches: side A plays Gumbel sequential halving at
    ``sims_a`` simulations, side B PUCT without Dirichlet noise at
    ``sims_b`` (JAX's ``arena_match_asym``).

    Colours alternate by env (A is red in even envs).  Both searches run on
    the whole batch every ply and each env takes the move of the side to
    move.  With ``greedy_a`` A plays the argmax of the improved policy
    (evaluation mode), else the surviving candidate; B samples its first
    ``temp_moves`` plies from the visit counts and plays the argmax after.
    Returns the tally of :func:`arena_match`, ``"final_state"`` included.
    """
    n = board_size
    a_is_red = (torch.arange(batch, device=device) % 2) == 0
    bs = bit_reset(n, batch, device)
    dummy = bit_reset(n, batch, device)
    evaluator = mcts.net_evaluator(net_apply, n)
    kw = dict(evaluator=evaluator, board_size=n, c_puct=c_puct)
    max_moves = n * n - 3 + 1  # MaxGameLength + 1 safety bound (twixt.h:136-139)
    move = 0
    while move < max_moves:
        open_ = bs.result == geo.RESULT_OPEN
        if not bool(open_.any()):
            break
        safe = _select(open_, bs, dummy)
        player = safe.current_player.clamp(0, 1)
        a_to_move = (player == 0) == a_is_red
        cand_a, improved_a, _ = mcts.gumbel_search_batch(
            params, safe, generator, num_simulations=sims_a,
            max_considered=max_considered_a, **kw)
        act_a = improved_a.argmax(-1) if greedy_a else cand_a
        probs, _ = mcts.search_batch(params, safe, generator, num_simulations=sims_b,
                                     dirichlet_frac=0.0, **kw)
        act_b = _play(generator, probs, bit_legal_mask_flat(safe, player, n).T,
                      move < temp_moves)
        action = torch.where(a_to_move, act_a, act_b)
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
