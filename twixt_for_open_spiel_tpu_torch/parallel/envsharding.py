"""Env-sharded batched environments (``twixt_for_open_spiel_tpu/parallel/
envsharding.py``, ported to ``torch.distributed``).

Each rank steps its own shard of the env batch, with no traffic between
ranks during the rollout (envs never communicate); the only collective is
one all-reduce of the episode counters at the end.  On the card the bitboard
rollout is K1, ``ops/fused_bit_rollout.py``'s hand-written kernel, on every
rank; its plain version runs only on CPU tensors, as the wrapper
dispatches.  JAX's ``fused_tile`` and ``interpret`` exist for Mosaic and
are gone: ``fused`` picks the kernel's wrapper or the plain rollout.
"""

from __future__ import annotations

import torch

from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_random_rollout, bit_reset
from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import fused_bit_rollout
from twixt_for_open_spiel_tpu_torch.ops.rollout import batch_reset, random_rollout
from twixt_for_open_spiel_tpu_torch.parallel.mesh import make_env_mesh

# JAX mixes the mesh position into the counter seed as
# seed + idx * 0x01000193 in u32 (envsharding.py:109)
RANK_SEED_STRIDE = 0x01000193


def rank_seed(seed: int, rank: int) -> int:
    """The rank's u32 counter seed of the bitboard rollout, JAX's bits."""
    return (seed + rank * RANK_SEED_STRIDE) & 0xFFFFFFFF


def _reduce_stats(stats: dict, mesh) -> dict:
    """``episodes`` and ``results`` summed over the ranks, in one
    all-reduce."""
    both = torch.cat([stats["episodes"].reshape(1), stats["results"]]).to(torch.int32)
    mesh.all_reduce(both)
    return {"episodes": both[0], "results": both[1:]}


def sharded_batch_reset(board_size: int, global_batch: int, mesh=None):
    """This rank's shard of a batched initial canonical ``State``."""
    mesh = mesh or make_env_mesh()
    mesh.columns(global_batch)  # raises unless the ranks divide the batch
    return batch_reset(board_size, global_batch // mesh.size, mesh.device)


def sharded_bit_reset(board_size: int, global_batch: int, mesh=None):
    """This rank's shard of a batched initial ``BitState``."""
    mesh = mesh or make_env_mesh()
    mesh.columns(global_batch)
    return bit_reset(board_size, global_batch // mesh.size, mesh.device)


def make_sharded_rollout(board_size: int, num_steps: int, mesh=None):
    """``(generator, state) -> (state, stats)`` on the canonical engine,
    with ``mesh``.

    Per rank: the plain ``random_rollout`` on the rank's shard, drawing
    from ``generator``, which must be the rank's own stream
    (``parallel.rank_generator``; JAX folds the mesh position into its key);
    across ranks: one all-reduce of the episode counters."""
    mesh = mesh or make_env_mesh()

    def rollout(generator, state):
        state, stats = random_rollout(generator, board_size, num_steps, state)
        return state, _reduce_stats(stats, mesh)

    return rollout, mesh


def make_sharded_bit_rollout(board_size: int, num_steps: int, mesh=None, fused: bool = True):
    """``(seed, bitstate) -> (bitstate, stats)`` on the bitboard engine,
    with ``mesh``: the throughput path.

    Per rank: ``fused_bit_rollout`` (K1 on the card) or, with
    ``fused=False``, the plain ``bit_random_rollout``, bit-identical to it,
    on the rank's shard with the u32 seed :func:`rank_seed`; across ranks:
    one all-reduce of ``episodes`` and ``results``."""
    mesh = mesh or make_env_mesh()
    roll = fused_bit_rollout if fused else bit_random_rollout

    def rollout(seed: int, bs):
        bs, stats = roll(rank_seed(seed, mesh.rank), board_size, num_steps, bs)
        return bs, _reduce_stats(stats, mesh)

    return rollout, mesh
