"""twixt_for_open_spiel_tpu_torch — the TwixT engines in PyTorch, with CUDA
kernels for the card.

The PyTorch and CUDA port of ``twixt_for_open_spiel_tpu`` (the JAX package,
which stays the reference).  The layout mirrors the JAX package, so each
module's counterpart has the same name:

  ops/geometry.py             numpy tables (a pinned copy of the JAX module)
  ops/state.py                the canonical ``State``, ``reset``, codecs
  ops/step.py                 the canonical transition ``step``,
                              ``returns``, ``is_terminal``
  ops/rollout.py              batched lockstep envs: ``batch_reset``,
                              ``step_auto_reset``, ``random_rollout``
  ops/bitboard.py             ``BitState``, reset, ``step_bits``, sampling,
                              the lockstep random rollout, ``from_state`` /
                              ``to_state``, as plain torch code
  ops/observe.py              observation tensors, the packed wire and its
                              decoders
  ops/fused_bit_rollout.py    the bitboard rollout in one hand-written CUDA
                              kernel (``csrc/fused_bit_rollout.cu``)
  ops/fused_tensor_rollout.py the canonical-engine rollout in one
                              hand-written CUDA kernel
                              (``csrc/fused_tensor_rollout.cu``)
  ops/store_skeleton.py       the store-stream probe (``csrc/store_skeleton.cu``)
  ops/replay.py               ``bit_replay``: a batch of padded action
                              histories replayed in one lockstep loop
  ops/_cuda.py                builds the CUDA sources with nvcc at first use
  game/                       the OpenSpiel-shaped host side: ``load_game``,
                              ``TwixTGame``/``TwixTState`` on the canonical
                              engine, the byte-exact board string and the
                              golden playthrough (``playthrough.generate``)
  native/                     the C host engine and renderer (pinned copies
                              of the JAX package's sources), built with the
                              system compiler at first use, loaded by ctypes
  models/                     the net, the PUCT search, the arena, self-play
                              and the learner step (plain torch)
  utils/serialization.py      history replay of game states, tree
                              snapshots, training checkpoints
  utils/profiling.py          ``Throughput``, ``trace`` on ``torch.profiler``;
                              ``annotate``, the program's spans (``SPANS``),
                              off unless a profiler records; ``SpanTrace``
  parallel/                   the distributed learner on torch.distributed:
                              one rank a card, the env batch sharded over
                              the ranks, gradients all-reduced
  examples/                   ``example.py`` (a random game),
                              ``mcts_example.py`` (MCTS bots), ``arena.py``
                              (checkpoints head to head) and
                              ``selfplay_train.py``, the distributed
                              self-play training front door
  train_arena_gate.py         the training driver with its arena gates

Each kernel's module holds its plain torch version: CPU tensors run it, CUDA
tensors launch the kernel or raise.  Entry points put their tensors on the
card unless told otherwise.

The package imports torch and numpy only: never jax, never the JAX package.
Importing it loads and builds no kernel and no C library.
"""

from twixt_for_open_spiel_tpu_torch.ops import geometry
from twixt_for_open_spiel_tpu_torch.ops.observe import observation
from twixt_for_open_spiel_tpu_torch.ops.state import State, reset
from twixt_for_open_spiel_tpu_torch.ops.step import is_terminal, returns, step

__version__ = "0.2.0"

__all__ = [
    "geometry",
    "State",
    "reset",
    "step",
    "returns",
    "is_terminal",
    "observation",
]
