"""A dry run of the distributed learner over several ranks
(``__graft_entry__.dryrun_multichip``, ported to ``torch.distributed``)."""

from __future__ import annotations

import torch

from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net
from twixt_for_open_spiel_tpu_torch.models.selfplay import make_optimizer
from twixt_for_open_spiel_tpu_torch.parallel.envsharding import sharded_bit_reset
from twixt_for_open_spiel_tpu_torch.parallel.launch import initialize_distributed, spawn_ranks
from twixt_for_open_spiel_tpu_torch.parallel.learner_feed import (
    make_distributed_selfplay,
    make_distributed_train_step,
)
from twixt_for_open_spiel_tpu_torch.parallel.mesh import (
    broadcast_params,
    make_env_mesh,
    rank_generator,
)

ITERATIONS = 6


def dryrun_multichip(world_size: int, device="cuda", timeout: float = 600.0) -> list:
    """Spawn ``world_size`` ranks (one a card, over NCCL; or gloo ranks on
    the CPU with ``device="cpu"``) and run six self-play -> train
    iterations of the distributed learner at board 8, a 16x1 net, a global
    batch of 2 envs a rank, 4 plies and 4 simulations.  Returns the
    losses; raises unless the ranks agree and the mean loss of the last
    three iterations is below that of the first three.

    The loss must FALL, not merely be finite: a wrong combine of the
    gradients (or a sign flip in a collective) gives finite losses that do
    not decrease.  Halves are compared, not single iterations: a healthy
    run can wobble from one iteration to the next at this tiny batch."""
    per_rank = spawn_ranks(_dryrun_rank, world_size, (str(device),), timeout=timeout)
    losses = per_rank[0]
    if any(other != losses for other in per_rank[1:]):
        raise AssertionError(f"the ranks disagree on the losses: {per_rank}")
    if not all(loss == loss for loss in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    h = len(losses) // 2
    first, last = sum(losses[:h]) / h, sum(losses[h:]) / (len(losses) - h)
    if not last < first:
        raise AssertionError(f"distributed loss did not fall: {losses}")
    return losses


def _dryrun_rank(rank: int, world_size: int, rdzv: str, device: str) -> list:
    initialize_distributed(rdzv, world_size, rank, device=device)
    mesh = make_env_mesh(None if torch.device(device).type == "cuda" else device)
    n = 8
    net = create_net(n, channels=16, blocks=1, device=mesh.device)
    broadcast_params(net, mesh)
    opt = make_optimizer(net.parameters(), 1e-2)
    selfplay, _ = make_distributed_selfplay(call_net, n, num_steps=4, num_simulations=4,
                                            mesh=mesh)
    trainer, _ = make_distributed_train_step(call_net, opt, mesh)
    state = sharded_bit_reset(n, 2 * world_size, mesh)
    gen = rank_generator(1, mesh)
    losses = []
    for _ in range(ITERATIONS):
        state, sample = selfplay(net, state, gen)
        losses.append(float(trainer(net, sample)["loss"]))
    return losses
