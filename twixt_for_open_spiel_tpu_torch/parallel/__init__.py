"""The distributed learner of the port (``twixt_for_open_spiel_tpu/parallel``,
on ``torch.distributed``): one rank a card, each holding its shard of the
env batch; collectives are NCCL's on the card and gloo's on the CPU.

  launch.py        ``initialize_distributed`` (torchrun's variables or the
                   coordinator flags), ``initialize_world``, ``spawn_ranks``
  mesh.py          ``EnvMesh``, ``make_env_mesh``, ``hosts_major_order``,
                   ``shard_env_pytree``, ``rank_generator``,
                   ``broadcast_params``, ``replicas_differ``
  envsharding.py   sharded resets and rollouts (K1 on every rank on the card)
  learner_feed.py  ``make_distributed_selfplay``, ``make_distributed_train_step``
  dryrun.py        ``dryrun_multichip``

Importing the package builds no kernel and makes no process group.
"""

from twixt_for_open_spiel_tpu_torch.parallel.mesh import (
    ENV_AXIS,
    EnvMesh,
    broadcast_params,
    hosts_major_order,
    make_env_mesh,
    param_checksums,
    rank_generator,
    replicas_differ,
    shard_env_pytree,
)
from twixt_for_open_spiel_tpu_torch.parallel.launch import (
    initialize_distributed,
    initialize_world,
    spawn_ranks,
)
from twixt_for_open_spiel_tpu_torch.parallel.envsharding import (
    make_sharded_bit_rollout,
    make_sharded_rollout,
    sharded_batch_reset,
    sharded_bit_reset,
)
from twixt_for_open_spiel_tpu_torch.parallel.learner_feed import (
    make_distributed_selfplay,
    make_distributed_train_step,
)
from twixt_for_open_spiel_tpu_torch.parallel.dryrun import dryrun_multichip

__all__ = [
    "ENV_AXIS",
    "EnvMesh",
    "broadcast_params",
    "dryrun_multichip",
    "hosts_major_order",
    "initialize_distributed",
    "initialize_world",
    "make_env_mesh",
    "param_checksums",
    "rank_generator",
    "replicas_differ",
    "shard_env_pytree",
    "spawn_ranks",
    "make_sharded_bit_rollout",
    "make_sharded_rollout",
    "sharded_batch_reset",
    "sharded_bit_reset",
    "make_distributed_selfplay",
    "make_distributed_train_step",
]
