"""The AlphaZero stack of the port (``twixt_for_open_spiel_tpu/models``).

  network.py   ``AZNet`` (NHWC, float32 parameters, bfloat16 compute),
               ``create_net``, ``init_params``, ``masked_policy``,
               ``call_net`` (the ``net_apply`` of a torch net)
  convert.py   flax parameters <-> the port's ``state_dict``:
               ``params_from_flax``, ``params_to_flax``,
               ``load_flax_params``; optax's Adam state <-> AdamW's:
               ``opt_state_from_optax``, ``opt_state_to_optax``
  mcts.py      the batched searches on the bitboard engine: PUCT
               (``search_batch``, ``batched_search``), Gumbel sequential
               halving (``gumbel_search_batch``) and PUCT with tree reuse
               (``search_batch_reuse``, ``init_reuse_tree``,
               ``reuse_nodes``); ``net_evaluator``, ``rollout_evaluator``
               with its seed-level ``one_rollout``, ``dirichlet``
  arena.py     ``arena_match``: lockstep games between two nets, or a net
               and the random bot (PUCT, Gumbel, or A reusing its tree);
               ``arena_match_asym``: one net's Gumbel search against its
               PUCT search
  selfplay.py  ``Sample``, ``selfplay_chunk`` (PUCT, PUCT with reuse,
               Gumbel), ``policy_ce``, ``loss_fn``, ``accumulate_grads``,
               ``make_optimizer``, ``train_step``

The modules import torch and numpy only, and their entry points put
tensors on the card unless given ``device="cpu"``.
"""

from twixt_for_open_spiel_tpu_torch.models.arena import arena_match, arena_match_asym
from twixt_for_open_spiel_tpu_torch.models.convert import (
    load_flax_params,
    opt_state_from_optax,
    opt_state_to_optax,
    params_from_flax,
    params_to_flax,
)
from twixt_for_open_spiel_tpu_torch.models.mcts import (
    batched_search,
    gumbel_search_batch,
    init_reuse_tree,
    net_evaluator,
    one_rollout,
    reuse_nodes,
    rollout_evaluator,
    search_batch,
    search_batch_reuse,
)
from twixt_for_open_spiel_tpu_torch.models.network import (
    AZNet,
    call_net,
    create_net,
    init_params,
    masked_policy,
)
from twixt_for_open_spiel_tpu_torch.models.selfplay import (
    Sample,
    accumulate_grads,
    loss_fn,
    make_optimizer,
    policy_ce,
    selfplay_chunk,
    train_step,
)

__all__ = [
    "AZNet",
    "Sample",
    "accumulate_grads",
    "arena_match",
    "arena_match_asym",
    "batched_search",
    "call_net",
    "create_net",
    "gumbel_search_batch",
    "init_params",
    "init_reuse_tree",
    "load_flax_params",
    "loss_fn",
    "make_optimizer",
    "masked_policy",
    "net_evaluator",
    "one_rollout",
    "opt_state_from_optax",
    "opt_state_to_optax",
    "params_from_flax",
    "params_to_flax",
    "policy_ce",
    "reuse_nodes",
    "rollout_evaluator",
    "search_batch",
    "search_batch_reuse",
    "selfplay_chunk",
    "train_step",
]
