"""Batched lockstep environments on the canonical engine
(``twixt_for_open_spiel_tpu/ops/rollout.py``): batched ``step`` with
auto-reset and a uniform random policy.

The env batch is the trailing axis of every leaf (``[P, P, B]`` boards,
``[B]`` scalars), as in the JAX module.  On the card this path is plain
torch ops: JAX leaves it to XLA, and its whole-rollout kernel is
``ops/fused_tensor_rollout.py``.

Randomness: ``sample_legal_action`` draws from a ``torch.Generator`` where
the JAX function takes a ``jax.random`` key.  The two streams differ, so
the draws match JAX in legality and distribution, not bit for bit.
"""

from __future__ import annotations

import torch

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.state import (
    State,
    legal_mask_flat,
    reset,
)
from twixt_for_open_spiel_tpu_torch.ops.step import step

_I32 = torch.int32


def batch_size(state: State) -> int:
    return state.current_player.shape[-1]


def batch_reset(board_size: int, batch: int, device="cuda") -> State:
    """Batched initial state, env axis trailing on every leaf."""
    return State(*[
        x.unsqueeze(-1).expand(x.shape + (batch,)).contiguous()
        for x in reset(board_size, device)
    ])


def env_slice(state: State, e: int) -> State:
    """Env ``e`` as an unbatched State."""
    return State(*[x[..., e] for x in state])


def sample_legal_action(state: State, generator: torch.Generator,
                        board_size: int) -> torch.Tensor:
    """Uniform random legal action per env (int32 [B]): Gumbel-max over the
    legal mask of the player to move, one [A, B] uniform draw in
    [1e-7, 1) from ``generator`` (which lives on the state's device)."""
    p = state.current_player.clamp(0, 1)
    mask = legal_mask_flat(state, p, board_size)  # [A, B]
    u = torch.rand(mask.shape, generator=generator, device=mask.device)
    u = u * (1.0 - 1e-7) + 1e-7
    g = -torch.log(-torch.log(u))
    scores = torch.where(mask, g, -torch.inf)
    return scores.argmax(dim=0).to(_I32)


def _reset_done(nxt: State, init: State) -> State:
    """Finished envs (result != OPEN) take the whole initial state."""
    done = nxt.result != geo.RESULT_OPEN
    return State(*[
        torch.where(done, a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b)
        for a, b in zip(init, nxt)
    ])


def step_auto_reset(state: State, action, board_size: int):
    """step(); terminal next-states are replaced by fresh initial states.
    Returns (next_state, terminated [B], pre-reset result [B])."""
    nxt = step(state, board_size, action)
    init = reset(board_size, nxt.color.device)
    return _reset_done(nxt, init), nxt.result != geo.RESULT_OPEN, nxt.result


def random_rollout(generator: torch.Generator, board_size: int,
                   num_steps: int, state: State):
    """``num_steps`` lockstep random-policy steps over the batch.  Returns
    (final_state, {"episodes": int32 [], "results": int32 [4]})."""
    dev = state.color.device
    episodes = torch.zeros((), dtype=_I32, device=dev)
    results = torch.zeros(4, dtype=_I32, device=dev)
    rs = torch.arange(4, dtype=_I32, device=dev).unsqueeze(1)
    for _ in range(num_steps):
        actions = sample_legal_action(state, generator, board_size)
        state, done, result = step_auto_reset(state, actions, board_size)
        episodes = episodes + done.sum(dtype=_I32)
        results = results + (done & (result == rs)).sum(dim=1, dtype=_I32)
    return state, {"episodes": episodes, "results": results}
