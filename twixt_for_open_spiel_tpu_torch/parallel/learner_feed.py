"""Sharded self-play feeding a data-parallel learner
(``twixt_for_open_spiel_tpu/parallel/learner_feed.py``, ported to
``torch.distributed``).

Each rank plays a self-play chunk on its shard of the envs and takes the
training step on the frames it played; the gradients are averaged over the
ranks by one all-reduce, so every rank applies the same update to its copy
of the parameters.  JAX's collectives are XLA's; here they are the
library's (NCCL on the card, gloo on the CPU).  A ring all-reduce leaves
the same sum on every rank, so the ranks' parameters stay bitwise equal.
"""

from __future__ import annotations

import torch

from twixt_for_open_spiel_tpu_torch.models.selfplay import Sample, accumulate_grads, selfplay_chunk
from twixt_for_open_spiel_tpu_torch.parallel.mesh import make_env_mesh

_METRICS = ("loss", "policy_loss", "value_loss", "target_entropy")


def make_distributed_train_step(net_apply, optimizer, mesh=None, microbatch: int = 1):
    """``(params, sample) -> metrics``: one learner step, in place on the
    module ``params`` and ``optimizer`` (over its parameters), with the
    rank's shard ``sample`` (time-major, env axis 1).  Returns ``(step,
    mesh)``.

    JAX's step takes and returns ``(params, opt_state)``; a torch
    optimizer holds its parameters and state, so the step updates both in
    place.  ``microbatch`` splits the shard's chunk into K equal time
    slices with exact gradient accumulation (``accumulate_grads``).  The
    order: the global finished-frame count (one all-reduce), the shard's
    gradients, one all-reduce of all gradients in a flat float32 buffer
    divided by the ranks, one all-reduce of the metrics, then
    ``optimizer.step()``, whose clip (``ClippedAdamW``) so sees the
    global gradient, as optax's chain does on pmean'd gradients."""
    mesh = mesh or make_env_mesh()

    def step(params, sample: Sample) -> dict:
        # The global objective is
        #   mean_frames(pol_ce) + sum(val_mse * w) / max(sum(w), 1)
        # over the WHOLE batch.  The policy term is a plain mean over
        # equal-sized shards, so the mean of per-rank policy gradients is
        # exact.  The value term is normalised by the GLOBAL finished-frame
        # count (w.sum() varies by shard), so each rank minimises the
        # surrogate  val_num_r / (max(total, 1) / N);  the mean of those
        # gradients telescopes to sum_r(grad val_num_r) / max(total, 1),
        # the exact global gradient.  (A per-rank denominator + mean would
        # weight a shard with one finished episode like a full shard.)
        total = mesh.all_reduce(sample.weight.sum().reshape(1))[0]
        val_denom = total.clamp_min(1.0) / mesh.size
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            metrics = accumulate_grads(params, net_apply, sample, val_denom=val_denom,
                                       microbatch=microbatch)
        with torch.no_grad():
            live = [p for p in params.parameters() if p.requires_grad]
            for p in live:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = torch.cat([p.grad.reshape(-1).float() for p in live])
            mesh.all_reduce(flat).div_(mesh.size)
            offset = 0
            for p in live:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
                offset += p.numel()
            # with the surrogate denominator the mean of every metric IS
            # the global value: value_loss = sum_r(val_num_r) / max(total, 1)
            means = mesh.all_reduce(torch.stack([metrics[k] for k in _METRICS])).div_(mesh.size)
        metrics = dict(zip(_METRICS, means.unbind(0)))
        metrics["train_frames"] = total
        optimizer.step()
        return metrics

    return step, mesh


def make_distributed_selfplay(net_apply, board_size: int, num_steps: int, num_simulations: int,
                              mesh=None, search: str = "puct", temp_moves: int = 10 ** 9,
                              dirichlet_alpha=None, dirichlet_frac: float = 0.25,
                              value_bootstrap: float = 0.0):
    """``(params, bitstate, generator) -> (bitstate, sample)`` on the rank's
    shard: ``selfplay_chunk`` with the arguments above, drawing from
    ``generator``, which must be the rank's own stream
    (``parallel.rank_generator``; JAX folds the mesh position into its
    key).  No collective: the chunk is the rank's alone, and the sample
    stays on the rank for the train step.  Returns ``(selfplay, mesh)``."""
    mesh = mesh or make_env_mesh()

    def selfplay(params, state, generator):
        return selfplay_chunk(
            params, state, generator, net_apply=net_apply, board_size=board_size,
            num_steps=num_steps, num_simulations=num_simulations, search=search,
            temp_moves=temp_moves, dirichlet_alpha=dirichlet_alpha,
            dirichlet_frac=dirichlet_frac, value_bootstrap=value_bootstrap)

    return selfplay, mesh
