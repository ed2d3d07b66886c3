"""twixt_for_open_spiel_tpu_torch — the TwixT bitboard engine in PyTorch.

The PyTorch and CUDA port of ``twixt_for_open_spiel_tpu`` (the JAX package,
which stays the reference).  The layout mirrors the JAX package, so each
module's counterpart has the same name:

  ops/geometry.py          numpy tables (a pinned copy of the JAX module)
  ops/state.py             board sizes and action codecs
  ops/bitboard.py          ``BitState``, reset, ``step_bits``, sampling and
                           the lockstep random rollout, as plain torch code
  ops/observe.py           the packed observation wire and its decoders
  ops/fused_bit_rollout.py the whole rollout in one hand-written CUDA kernel
                           (``csrc/fused_bit_rollout.cu``) and its plain
                           version
  ops/_cuda.py             builds the CUDA sources with nvcc at first use

The package imports torch and numpy only: never jax, never the JAX package.
Importing it loads and builds no kernel.
"""

__version__ = "0.1.0"
