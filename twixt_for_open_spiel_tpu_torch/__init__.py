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
  ops/_cuda.py                builds the CUDA sources with nvcc at first use

Each kernel's module holds its plain torch version: CPU tensors run it, CUDA
tensors launch the kernel or raise.  Entry points put their tensors on the
card unless told otherwise.

The package imports torch and numpy only: never jax, never the JAX package.
Importing it loads and builds no kernel.
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
