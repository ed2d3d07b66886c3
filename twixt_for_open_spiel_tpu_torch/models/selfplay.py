"""AlphaZero self-play and the learner step
(``twixt_for_open_spiel_tpu/models/selfplay.py``).

  * ``selfplay_chunk``: T lockstep env steps over a [B] batch on the
    bitboard engine, each action from one batched search
    (``models/mcts.py``: PUCT, PUCT with tree reuse, or Gumbel); emits the
    training tuple (packed obs wire, search policy, outcome) with a
    backward pass giving each position the final result of its episode
    (auto-reset keeps envs dense);
  * ``train_step``: legal-set policy cross-entropy plus outcome-weighted
    value MSE on the chunk, global-norm clip, then AdamW, in place on the
    module and its optimizer.

The JAX chunk is one ``lax.scan``; here it is a host loop over the steps
under ``torch.no_grad``, and the backward outcome scan a reversed loop.
Randomness (the search's root noise or Gumbels, the sampled plies) comes
from one ``torch.Generator``; it agrees with JAX's draws in distribution.
With ``temp_moves=0`` and ``dirichlet_frac=0`` a PUCT chunk (with or
without reuse) is deterministic and emits JAX's chunk bit for bit, and so
does a Gumbel chunk with zero Gumbels (``tests/test_torch_selfplay.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.models.arena import _categorical
from twixt_for_open_spiel_tpu_torch.models.network import call_net
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    BitState,
    bit_legal_mask_flat,
    bit_step_auto_reset,
)
from twixt_for_open_spiel_tpu_torch.ops.observe import (
    bit_observation_packed_with_legal,
    legal_words_from_obs,
    unpack_legal_words_flat,
    unpack_observation_nchw,
)
from twixt_for_open_spiel_tpu_torch.utils.profiling import annotate


class Sample(NamedTuple):
    """One training chunk, time-major [T, B, ...].

    ``obs`` is the whole wire in one array: the 12 packed observation
    planes (column words, ``ops/observe.bit_observation_packed``) with the
    mover's packed legal plane in the words' free low bits
    (``bit_observation_packed_with_legal``).  The learner decodes the
    observation with ``unpack_observation_nchw`` and the legal mask, which
    normalises the policy loss over the legal set, with
    ``legal_words_from_obs`` and ``unpack_legal_words_flat``.  The words
    are int32 here, bit-equal to JAX's u32 words.
    """

    obs: torch.Tensor     # int32 [T, B, 12*P] obs planes + stowaway legal
    policy: torch.Tensor  # f32 [T, B, A] MCTS visit distribution
    value: torch.Tensor   # f32 [T, B] outcome from the mover's perspective
    weight: torch.Tensor  # f32 [T, B] 0 for positions of unfinished games


@torch.no_grad()
def selfplay_chunk(params, bs: BitState, generator, *, board_size: int,
                   num_steps: int, num_simulations: int, net_apply=call_net,
                   temperature: float = 1.0, temp_moves: int = 10 ** 9,
                   search: str = "puct", reuse_cap: int | None = None,
                   dirichlet_alpha: float | None = None, dirichlet_frac: float = 0.25,
                   value_bootstrap: float = 0.0, debug_trace: bool = False):
    """Run ``num_steps`` search-driven lockstep steps; returns
    (final_bitstate, Sample), with ``debug_trace`` also an aux dict.

    ``bs`` is a 1-D env batch in the engine's trailing layout; the Sample is
    time-major.  ``search`` picks the move generator:

      * ``"puct"``: ``search_batch`` with Dirichlet root noise
        (``dirichlet_alpha`` None means 0.3); the move is a draw from the
        visit counts at ``temperature``, masked to the legal set, or their
        argmax (the first maximum) once an env's move counter reaches
        ``temp_moves``; the target is the visit distribution;
      * ``"puct_reuse"``: the same with ``search_batch_reuse``, the tree
        carried from ply to ply and re-rooted on the move played (envs that
        auto-reset start cold; the carry is seeded again at each chunk, so
        a chunk's first ply is cold); ``reuse_cap`` bounds the survivor
        slots (default ``num_simulations + 1``);
      * ``"gumbel"``: ``gumbel_search_batch``; the surviving candidate is
        played (the Gumbels are the exploration; temperature and the
        Dirichlet flags play no part) and the improved policy is the target.

    ``generator`` is a ``torch.Generator`` on the states' device;
    ``net_apply(params, obs)`` runs the net (by default ``params`` is a
    torch ``AZNet``).

    Positions whose episode does not finish inside the chunk get weight 0,
    or with ``value_bootstrap`` in (0, 1] that weight and the last step's
    search root value as their target (the n-step truncation bootstrap,
    converted from the last mover's perspective to each frame's mover's).
    ``debug_trace`` returns ``{"player"}`` (each frame's mover) and, with
    the bootstrap, ``{"root_q_last"}`` (the last step's root values, the
    last mover's perspective), as JAX's does, and ``{"actions"}`` (each
    frame's action, int32 [T, B]; the port's addition, for replaying the
    chunk's states).
    """
    if search not in ("puct", "puct_reuse", "gumbel"):
        raise ValueError(f"search must be 'puct', 'puct_reuse' or 'gumbel', not {search!r}")
    if dirichlet_alpha is None:
        dirichlet_alpha = 0.3
    # bootstrap frames must never outweigh exact-outcome frames (weight 1)
    if not 0.0 <= value_bootstrap <= 1.0:
        raise ValueError(f"value_bootstrap must be in [0, 1], got {value_bootstrap}")

    n = board_size
    evaluator = mcts.net_evaluator(net_apply, n)
    kw = dict(evaluator=evaluator, board_size=n, num_simulations=num_simulations)
    noise = dict(dirichlet_alpha=dirichlet_alpha, dirichlet_frac=dirichlet_frac)
    if search == "puct_reuse":
        batch = bs.current_player.shape[-1]
        tree = mcts.init_reuse_tree(bs, board_size=n, num_simulations=num_simulations,
                                     reuse_cap=reuse_cap)
        last = torch.full((batch,), -1, dtype=torch.int32, device=bs.red.device)
        last_done = torch.ones(batch, dtype=torch.bool, device=bs.red.device)
    obs, policy, player, played, done, result = [], [], [], [], [], []
    root_q = None
    for _ in range(num_steps):
        obs.append(bit_observation_packed_with_legal(bs, n))
        mover = bs.current_player.clamp(0, 1)
        if search == "gumbel":
            actions, probs, root_q = mcts.gumbel_search_batch(params, bs, generator, **kw)
        else:
            if search == "puct_reuse":
                probs, root_q, tree = mcts.search_batch_reuse(
                    params, bs, generator, tree, last, last_done, reuse_cap=reuse_cap,
                    **kw, **noise)
            else:
                probs, root_q = mcts.search_batch(params, bs, generator, **kw, **noise)
            # temperature draw over the visit counts; illegal actions carry
            # no visits, but are masked explicitly
            legal = bit_legal_mask_flat(bs, mover, n).T             # [B, A]
            logits = torch.where(legal, torch.log(probs.clamp_min(1e-9)) / temperature,
                                 -torch.inf)
            sampled = _categorical(generator, logits)
            greedy = torch.where(legal, probs, -1.0).argmax(-1)
            actions = torch.where(bs.move_counter < temp_moves, sampled, greedy)
        actions = actions.to(torch.int32)
        bs, step_done, step_result = bit_step_auto_reset(bs, actions, n)
        if search == "puct_reuse":
            last, last_done = actions, step_done
        policy.append(probs)
        player.append(mover)
        played.append(actions)
        done.append(step_done)
        result.append(step_result)

    # backward pass: each episode's terminal outcome (red's perspective) to
    # every position of it; the unfinished trailing episode gets the
    # bootstrap seed (z0, w0)
    player_t = torch.stack(player)
    if value_bootstrap:
        # the last position's mover-perspective root value, to red's
        z_red = torch.where(player[-1] == 0, root_q, -root_q)
        w = torch.full_like(root_q, float(value_bootstrap))
    else:
        z_red = torch.zeros(bs.current_player.shape, dtype=torch.float32,
                            device=bs.red.device)
        w = torch.zeros_like(z_red)
    z_steps, w_steps = [], []
    for t in reversed(range(num_steps)):
        z_red = torch.where(done[t], mcts.outcome_value(result[t], 0), z_red)  # red's view
        w = torch.where(done[t], 1.0, w)
        z_steps.append(z_red)
        w_steps.append(w)
    z_red_t = torch.stack(z_steps[::-1])
    sample = Sample(
        obs=torch.stack(obs),
        policy=torch.stack(policy),
        value=torch.where(player_t == 0, z_red_t, -z_red_t),
        weight=torch.stack(w_steps[::-1]),
    )
    if debug_trace:
        aux = {"player": player_t, "actions": torch.stack(played)}
        if value_bootstrap:
            aux["root_q_last"] = root_q
        return bs, sample, aux
    return bs, sample


class ClippedAdamW(torch.optim.AdamW):
    """AdamW after a clip of the gradients by their global norm, as optax's
    ``chain(clip_by_global_norm(clip_norm), adamw(...))``: the clip is
    ``g if norm < clip_norm else g / norm * clip_norm`` (torch's
    ``clip_grad_norm_`` adds 1e-6 to the norm, optax does not), and the
    decay is decoupled, ``p -= lr * (update + weight_decay * p)``."""

    def __init__(self, params, lr: float, weight_decay: float, clip_norm: float):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        return super().step(closure)


def make_optimizer(params, lr: float = 2e-3, weight_decay: float = 1e-4,
                   clip_norm: float = 1.0) -> ClippedAdamW:
    """AdamW (betas 0.9/0.999, eps 1e-8) with global-norm gradient clipping
    over ``params`` (a module's ``parameters()``).

    Clipping matters for the value head: outcome targets are almost always
    +-1, and without it Adam saturates the tanh early."""
    return ClippedAdamW(params, lr, weight_decay, clip_norm)


def policy_ce(logits, target, legal):
    """Cross-entropy of the visit target against softmax(logits) over the
    legal action set ([..., A]).  Illegal logits are shifted by -1e9, not
    set to -inf, so they get a gradient of exactly 0, and a legal action
    with no visits still sits in the softmax's denominator."""
    logp = torch.log_softmax(torch.where(legal, logits, logits - 1e9), dim=-1)
    return -(target * logp).sum(-1)


def loss_fn(params, net_apply, sample: Sample, *, val_denom=None):
    """AlphaZero loss on one chunk: legal-set policy CE on every frame plus
    the weighted value MSE over ``val_denom`` (default: this sample's
    finished-frame count, at least 1).  Returns (loss, metrics); the
    metrics are detached 0-dim tensors."""
    t, b = sample.obs.shape[:2]
    n = round(sample.policy.shape[-1] ** 0.5)  # the action space is n*n
    p_words = sample.obs.shape[-1] // 12
    pk = sample.obs.reshape(t, b, 12, p_words)
    legal = unpack_legal_words_flat(legal_words_from_obs(pk), n)  # [T, B, A]
    obs = unpack_observation_nchw(pk.reshape(t * b, 12, p_words), n)
    logits, value = net_apply(params, obs)
    logits = logits.reshape(t, b, -1)
    value = value.reshape(t, b)

    pol_loss = policy_ce(logits, sample.policy, legal)
    val_loss = (value - sample.value) ** 2
    # the value target needs the episode's outcome, so it is weighted; the
    # visit target is valid on every frame, so every frame trains the policy
    w = sample.weight
    if val_denom is None:
        val_denom = w.sum().clamp_min(1.0)
    pol_mean = pol_loss.mean()
    val_mean = (val_loss * w).sum() / val_denom
    loss = pol_mean + val_mean
    # mean entropy of the visit targets: the canary of a policy collapse
    tgt_ent = -(sample.policy * torch.log(sample.policy.clamp_min(1e-12))).sum(-1).mean()
    metrics = {
        "loss": loss,
        "policy_loss": pol_mean,
        "value_loss": val_mean,
        "train_frames": w.sum(),
        "target_entropy": tgt_ent,
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def accumulate_grads(params, net_apply, sample: Sample, *, val_denom,
                     microbatch: int = 1) -> dict:
    """Gradients of ``loss_fn`` into ``params``' ``.grad`` (added to what
    is there), over ``microbatch`` equal time slices, with the value term
    over ``val_denom``; returns the metrics.

    Exact up to float re-association: with K slices the global objective
    equals the mean over slices of ``pol_mean_slice + val_sum_slice /
    (val_denom / K)``, so the slice gradients are summed and divided by K.
    Only one slice's activations exist at a time.  ``train_frames`` is
    summed over the slices, the other metrics averaged."""
    if microbatch == 1:
        return _slice_grads(params, net_apply, sample, val_denom)
    t = sample.obs.shape[0]
    if t % microbatch:
        raise ValueError(f"microbatch {microbatch} does not divide the chunk's {t} steps")
    size = t // microbatch
    per_slice = []
    for k in range(microbatch):
        part = Sample(*(x[k * size:(k + 1) * size] for x in sample))
        per_slice.append(_slice_grads(params, net_apply, part, val_denom / microbatch))
    with torch.no_grad():
        for p in params.parameters():
            if p.grad is not None:
                p.grad.div_(microbatch)
    return {
        key: torch.stack([m[key] for m in per_slice]).sum()
        if key == "train_frames" else torch.stack([m[key] for m in per_slice]).mean()
        for key in per_slice[0]
    }


def _slice_grads(params, net_apply, sample: Sample, val_denom) -> dict:
    """``loss_fn`` on ``sample`` and its gradients added into ``.grad``,
    under the spans ``train.forward`` and ``train.backward``."""
    with annotate("train.forward"):
        loss, metrics = loss_fn(params, net_apply, sample, val_denom=val_denom)
    with annotate("train.backward"):
        loss.backward()
    return metrics


def train_step(params, optimizer, sample: Sample, *, net_apply=call_net,
               microbatch: int = 1) -> dict:
    """One learner step on ``sample``, in place: gradients of ``loss_fn``
    (over ``microbatch`` time slices), the clip and AdamW update of
    ``optimizer`` (from :func:`make_optimizer` over ``params``' parameters).
    ``params`` is the module ``net_apply`` runs.  Returns the metrics
    (detached 0-dim tensors)."""
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        metrics = accumulate_grads(
            params, net_apply, sample,
            val_denom=sample.weight.sum().clamp_min(1.0), microbatch=microbatch)
    with annotate("train.optimizer"):
        optimizer.step()
    return metrics
