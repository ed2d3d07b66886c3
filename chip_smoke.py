"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Three rollout-kernel paths, each with its kernel's launch count set to 0
just before the path and read just after (launches made to compare a kernel
with its plain version come before and do not count), then the search's
kernels (S1a ``bit_step``, S1b ``select_walk``, S1c ``backup_walk``) the
same way, then the net, the search, the arena, self-play, training, the
driver and the host side, which run torch ops, the net's LayerNorm kernels
(S2a forward, S2b backward) and the search's kernels on the card: every
launch count is set to 0 before each phase, and each names the kernels it
may launch (the search's and the net's) and those it must.  Any failure
ends the run with a non-zero exit.

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from ``twixt_for_open_spiel_tpu_torch/csrc``
     with nvcc for sm_90a, one nvcc per source, all at once, and print the
     build time and nvcc's register report; read each rollout kernel's
     SASS (``cuobjdump -sass``) and count the fewest instructions, per
     class, that a step, a cell of K3's draw and a lane's row of K2's
     staged wire issue (``ops/_sass.py``), for the bounds;

  the bitboard rollout (K1, K2: ``fused_bit_rollout``, one warp per env):
  3. the kernel is bit-equal to its plain torch version, on the card, in
     every state leaf, ``episodes``, ``results`` and the ``obs`` stream:
     both arms at full width, K2's wire by TMA (B % 4 == 0) and by plain
     stores (B % 4 != 0), a last block of envs that is ragged, a single env
     in both arms;
  4. the JAX anchor: the kernel's final-state digests equal those of the JAX
     engine in ``tests/fixtures/torch_port_rollout_digests.json``;
  5. throughput at the benchmark's rollout rows (K1) and the obs row (K2,
     the median of 5 runs of its 32 launches), by CUDA events, and of the
     plain version at both;

  the canonical-engine rollout (K3: ``fused_random_rollout``):
  6. the kernel is bit-equal to its plain version in every state leaf,
     ``actions`` and ``results``, full width (board 24, batch 4096), a
     second tile, a single env and a batch whose last block of envs is
     ragged included; a batch that is no multiple of the tile raises;
  7. the JAX anchor: digests of final state and actions, and the result
     histogram, equal ``tests/fixtures/torch_port_tensor_rollout_digests.json``;
  8. replay: the headline launch's recorded actions, replayed through the
     plain ``step_auto_reset`` on the card, give its results and final
     state (and count the legal cells its draws scanned, for the bound);
  9. throughput at the benchmark's rows, every launch from the initial
     state; the plain version at the headline; ``random_rollout`` (plain
     torch, the README's entry point) for a few steps with its invariants;

  the store-stream probe (K4: ``store_skeleton``):
  10. the kernel equals its plain version at the obs stream's shape (board
      24), and its store rate beside the card's 3.35 TB/s, the obs
      stream's rate from phase 5 and PyTorch's own broadcast copy
      (``expand().contiguous()``) of the same output: the kernel/library
      ratio and the kernel's share of its bound.  Each of the three is timed
      over runs of launches back to back (a launch takes about 0.1 ms, near
      the wrapper's host time).

  the net, the PUCT search and the arena (``models/``):
  11. the full-width net (board 12, batch 512, 128 channels, 6 blocks) on
      the card against the same net on the CPU, both loaded with one set of
      seeded flax-layout parameters through ``convert.load_flax_params``:
      float32 with TF32 off (|diff| <= 1e-4 of the output's scale) and
      bfloat16 (<= 2**-4); and the JAX anchor: a small net's float32
      outputs equal ``tests/fixtures/torch_port_net.json`` (<= 1e-5);
  12. the bf16 forward's time (median of 20, CUDA events) beside its
      bound, the convolutions' and Dense layers' FLOPs over 989 TFLOP/s;
      S2a launched (the net path's only kernel); (b) S2a and S2b against
      their plain versions at every dtype (bf16, float32), width (8-256)
      and epilogue (none, ReLU, residual add then ReLU), at a ragged row
      count and at the search's 61,440 rows (``S2_TOL``: two bf16 ulps of
      the output's scale, float32 within 1e-5, the parameters' gradients
      within 2e-5 of their absolute sums), each backward run twice and
      bit-equal; the net's convolutions hand LayerNorm contiguous rows;
  13. the search's kernels: every call of S1a, S1b and S1c in
      ``search_batch`` with the bf16 net at config-5 width (board 12, batch
      512, 64 simulations) under both backups and at board 24 (batch 256,
      200 simulations, the walk), and in ``gumbel_search_batch`` at both
      under the walk, runs the kernel and its plain version on copies of
      the same inputs (S1b from the root, the PUCT entry, and from Gumbel's
      forced root edges), bit-equal (floats by bit pattern; S1a's
      outputs include the child's terminal flag and value), and in the
      first of them every S2a call too, within ``S2_TOL``; then the main
      path, config-5 searches under both backups, with the three kernels'
      launches counted; S1b (from the root and from a forced entry) and
      S1c again on simulation 32's trees padded with unlinked slots until
      one env needs more than 48 KB of shared memory (``S1_WIDE_SLOTS``),
      and one env at the most slots that fit a block (``S1_EDGE_SLOTS``),
      bit-equal, and one slot more refused by each wrapper; S1a at its
      edges (boards 5 and 24, batch 13, in place over a fresh slot and
      over a slot that is read, and from one slot), bit-equal; each
      kernel's time (launches back to back, and the device's time behind
      a spin kernel) and its plain version's on simulation 32's inputs
      (S1b also below the root's best edge, held to plain there; S1a also
      from one slot at board 24, batch 4096, ``step_state``'s form, held to
      plain there), beside its bound (the bytes this call's walks need),
      the deepest walk of those inputs, and an empty kernel of each launch
      shape timed the same two ways (the launch floor); then ``search_batch`` with the
      table and uniform evaluators of ``tests/test_mcts_exact.py`` over its
      scenarios, both backups, every kernel call held to its plain version
      again: root visits, ``root_q`` (<= 1e-5) and the walks' iteration
      counts equal ``tests/fixtures/torch_port_search.json``;
      ``one_rollout`` equals its JAX values, each of its ``step_bits``
      (S1a through ``step_state``, to the games' ends) held to
      ``step_bits_reference``; ``argmax`` takes the first maximum on the card, an all
      -inf row included;
  14. ``search_batch`` with the bf16 net at board 12, batch 512, 64
      simulations, ``dirichlet_frac=0.25``: ms a search and a simulation,
      the net calls' share (CUDA events around each), the search kernels'
      launches a simulation, peak memory, and the invariants (visits sum
      to 64, none off the legal set, |root_q| <= 1); then one search with
      CUDA's sync debug mode at "error" inside every simulation (a host
      read there fails the run) and one under torch.profiler: host reads
      and device activities a simulation;
  15. the deterministic table-net arena (board 5) against the tally and
      final-board digest of ``tests/fixtures/torch_port_arena.json``; the
      untrained full-width net against the random bot at board 8, batch
      64, 16 simulations: tally, plies and moves a second.

  self-play, the learner step and the driver (``models/selfplay.py``,
  ``train_arena_gate.py``; torch and the search's kernels on the card):
  16. the deterministic chunk of ``tests/torch_port_cases`` (table net,
      board 5, greedy, no root noise) with and without the value
      bootstrap: the obs wire bit-equal, the policy, value and weight
      targets, the final-state digest and the debug aux equal to
      ``tests/fixtures/torch_port_selfplay.json``, every S1 call and every
      ``step_bits`` (auto-resets included) held to its plain version;
  17. ``loss_fn``, its gradients and three ``train_step``s under each clip
      in float32 with TF32 off, on seeded parameters converted from flax:
      the card against the CPU (metrics rtol 1e-5, gradients within 1e-5 of
      each leaf's largest magnitude, parameters rtol 2e-4 and atol 1e-5)
      and against the JAX record ``tests/fixtures/torch_port_train.json``
      (each leaf's norm and projection within 1e-4 of its norm); one step
      at microbatch 4 against the monolithic step;
  18. config 5 at full width (``docs/PERF.md``'s board-12 recipe: batch
      512, chunk 32, 64 simulations, 64 channels x 4 blocks, bf16,
      ``temp_moves=16``, Dirichlet 0.3 / 0.25): one chunk's seconds,
      moves/s, seconds a ply, ``search_batch``'s share (CUDA events),
      frames with weight 1 and peak memory; its invariants (policy rows
      sum to 1 with no mass off the legal set, weights in {0, 1},
      |value| <= 1, the wire's legal plane equal to the engine's mask of
      the states replayed from the chunk's actions, each replayed
      ``step_bits`` at B=512 held to ``step_bits_reference``); then
      ``train_step``
      on its 16,384 frames: the median of 5 after a warm-up beside the
      bound (3 x the forward's FLOPs over 989 TFLOP/s), the loss, peak
      memory, and that the parameters moved; then one more step with
      every S2a and S2b call held to its plain version (``S2_TOL``);
      (b) each S2 shape those paths called (the config-5 search's
      forward, self-play's 64x4 one, the train step's forward and
      backward): the kernel's ms a launch (20, cycling through 256 MiB of
      input sets, so that L2 holds none of a launch's data), the plain
      version's, the library's (``F.layer_norm`` on a float32 copy, the
      cast, ReLU and add the port called before S2, and their autograd
      backward) and the bound (bytes at 3.35 TB/s), then their sums over
      one net call or step;
  19. the driver as a program on the card (board 8, batch 64, chunk 8, 16
      simulations, 64 x 4, gates at 2 and 3, arena batch 32 with 4
      simulations), then ``--resume`` to iteration 4: the JSONL record
      kinds in order, the resume at iteration 4 with the best record
      restored, ``gate_vs_random``, and the checkpoint loaded onto the
      card.

  the Gumbel search and tree reuse with their arms (``models/mcts.py``,
  ``arena.py``, ``selfplay.py``; torch and the search's kernels on the card):
  20. every kernel call held to its plain version, as in 13:
      ``gumbel_search_batch`` on ``tests/test_gumbel_exact.py``'s cases with
      its numpy-seeded Gumbels, both backups:
      the actions equal, the improved policy within 1e-6 and ``root_q``
      within 1e-5 of ``tests/fixtures/torch_port_gumbel.json``; and
      ``search_batch_reuse`` along ``tests/test_reuse_exact.py``'s move
      sequences (the tight cap included): root visits, ``reused_envs`` and
      ``inherited_visits`` equal ``tests/fixtures/torch_port_reuse.json``
      at every move;
  21. the deterministic ``puct_reuse`` and zero-Gumbel ``gumbel`` chunks
      against ``tests/fixtures/torch_port_selfplay_arms.json`` (the Gumbel
      improved-policy targets within 1e-6, the rest equal);
  22. at config-5 width (board 12, B=512, 64 simulations, the 64x4 bf16
      net), three rounds in turns: ``search_batch``,
      ``gumbel_search_batch`` (max_considered 16) and ``search_batch_reuse``
      after a played greedy ply (129 slots: the amask backup) with ``reused_envs`` and ``inherited_visits``; the
      median ms a search and a simulation by CUDA events, peak memory;
  23. one config-5 chunk of each arm, cut from 32 to 8 plies: moves/s, s
      a ply, the search's share (CUDA events), peak memory, and the
      invariants against the states replayed from the chunk's actions;
  24. at the arena row's shape (board 8, B=64, the 128x6 net):
      ``arena_match(search="gumbel")`` against the random bot and
      ``arena_match(reuse_a=True)`` at 8 simulations, and
      ``arena_match_asym`` with Gumbel at 8 against PUCT at 16 (cut from
      16 simulations, and from the JAX script's 16 against 64); every move
      checked against its state's legal mask, the tallies;
  25. (run beside phase 19, whose host loops leave the card idle) the
      driver as two more programs at phase 19's cut (three iterations,
      gates at 2 and 3): ``--search=puct_reuse --arena_search=gumbel`` and
      ``--search=gumbel``; the record kinds in order and the checkpoints.

  the distributed learner (``parallel/``; K1 on every rank, collectives
  from the library):
  26. ranks spawned on the card, over a gloo group made here (NCCL
      refuses two ranks on one device; ``multicard_smoke.py`` runs the
      NCCL path, one card a rank, on several cards): (a)
      ``make_sharded_bit_rollout`` at the headline (n=8, global B=4096,
      1000 steps) as two ranks (2048 envs a rank), then as four (1024):
      K1 launched on each rank (its count set to 0 in the rank just
      before), each rank's shard and the reduced counters bit-equal to
      the plain version on that shard with that rank's seed and to the
      world's case of ``tests/fixtures/torch_port_sharded_rollout.json``;
      each rank's K1 ms and the global env-steps/s beside phase 5's one
      process; then two ranks again:  (b)
      ``make_distributed_train_step`` on ``tests/test_sharding.py``'s case
      (board 5, a 16x1 float32 net with TF32 off, half the envs' weights
      zeroed, SGD 0.1, microbatch 1 and 3) against the local
      ``train_step`` on the whole sample (parameters rtol 2e-5 / atol
      1e-6, metrics rtol 2e-5), the ranks' parameters bitwise equal; (c)
      the deterministic chunk split over the ranks against
      ``torch_port_selfplay.json``; (d) the learn check of
      ``test_dist_training_improves_gate`` (24 iterations at board 5 from
      JAX's initial net, ``tests/fixtures/torch_port_learn_init.npz``, then
      32 games against it, the bar 0.6, JAX's).  (a) runs in
      a spawn of its own with nothing else on the card; (b)-(d) in a
      second, beside phase 27's programs.  A learn check below the bar
      fails the run after the kernels line, so that the other phases
      report first;
  27. a world of one over NCCL in this process at config-5 width (the
      chunk cut to 16 plies, from roots part-way through random games so
      that episodes end in it): one ``make_distributed_selfplay`` chunk
      (moves/s, s a ply, peak memory, phase 18's invariants against the
      wire's legal plane), ``make_distributed_train_step`` on its 8,192
      frames in turns with the local ``train_step`` (medians of 5; the
      first steps' metrics equal within rtol 2e-5), the gradients'
      all-reduce alone by CUDA events; and, run beside phase 26 (b)-(d),
      the driver as a program with ``--mesh=1`` at phase 19's cut and its
      ``--resume``, and ``examples.selfplay_train`` for two iterations.

  the host side (``game/``, ``native/``, ``ops/replay.py``,
  ``utils/profiling.py``, ``examples/``; torch and S1a on the card, the C
  engine and renderer on the host, built beside the nvcc builds):
  28. (a) BASELINE config 1: ``load_game("twixt", device="cuda")`` and
      ``playthrough.generate`` with the actions and sampling pattern of
      ``tests/fixtures/playthrough_board8.txt``, byte-equal to it, the
      game's tensors on CUDA (its time beside the CPU's); (b) the
      reference's scenarios through the adapter on the card, each beside the
      C engine: the win line, the swap, the board-5 draw, the illegal
      corner's message; (c) full random C games at board 24 applied move by
      move through ``TwixTState.apply_action`` on the card: the final string
      equal to ``render_py``'s, the state to the C engine's snapshot (ms a
      move beside the CPU's, and the card's busy share over 32 traced
      moves); (d) ``bit_replay`` of 4096 board-24 C games
      (``tests/test_soak.py``'s seeds, widened from 256) in one call on the
      card, and of 256 at boards 24, 5 and 12: every final leaf equal to the C
      engine's snapshot (the call's time, valid env-steps/s, and the card's
      busy share over 32 traced steps at B=4096), and the C engine's
      games/s; (e) after (d), beside (f), ``examples.example``,
      ``examples.arena`` at the arena row's cut and ``examples.mcts_example``
      at board 5 with 4 simulations, as programs on the card; (f)
      ``utils.profiling.trace`` around a board-12 B=512 search (8
      simulations) with an ``annotate`` span: the trace names the span and
      holds the card's kernels.

  the benches and the checkpoint arenas (``bench.py``, ``bench_*.py``,
  ``arena_checkpoints.py``, ``arena_gate_agreement.py``):
  29. (a) ``python3 -m twixt_for_open_spiel_tpu_torch.bench`` as a program,
      alone on the card, at its full rows: exit 0, one stdout line with
      ``bench.py``'s keys and metric, K1 and K2 launched (the program's
      counters), and the headline within 0.5-2x of phase 5's K1 rate at the
      same row; then, in this process beside (d), (b) ``bench_bitboard`` in
      full (K1 and K3 launched) and (c) ``bench_selfplay``'s iterations
      (PUCT, Gumbel, reuse) and ``bench_search_scaling`` at 512:64,
      config 5's width with the chunk cut to 1 ply and 1 timed iteration;
      (d) ``arena_checkpoints`` and ``arena_gate_agreement`` (``gumbel:8``
      and ``puct:8``, one program each, side by side) as programs on two
      seeded 64x4 board-8 checkpoints written by ``save_training``, at
      batch 64 and 8 simulations, every tally adding up.  The kernels line gives K1's, K2's
      and K3's launches in (a) and (b) as ``bench_launches``.

  the training path at the board-12 recipe (``train_arena_gate
  --board_size=12 --chunk_steps=32 --simulations=64 --temp_moves=16``):
  30. (a) one chunk of the recipe (B=512, 64 simulations, the seed-0 64x4
      bf16 net, temperature for 16 plies, Dirichlet 0.3/0.25): every
      action played checked against its state's legal mask, the sampled
      ones counted apart (0 illegal required), S1a and S1b launched; (b)
      the bf16 learner step at config-5 width on the card against JAX's
      record (``tests/fixtures/torch_port_train_bf16.json``, the tolerance
      of ``tests/test_torch_train_path.py``): the loss metrics, and each
      leaf's gradient and AdamW update error to JAX's float32 step,
      estimated from the record's projections, beside JAX's own bf16
      error; the float32 step (TF32 off) within 2e-3 of JAX's.

The net, search, arena, self-play, train, driver and host lines with a
time end with the card's name and power limit (printed alone first);
``[launches]`` lines give each phase's kernel launches.
``[time]`` lines give each group of phases' wall time, and the total time
is printed before the two JSON lines.  The
second-to-last line is a JSON object describing the kernels (K1 and K2
as entries of their own, then S1a-S1c, then S2a and S2b on each path:
their sums over one net call of the search and of self-play, and over
one train step's forward and backward), each with
its time, its plain version's time and its bound (the least time the card
could take: bytes over 3.35 TB/s or the SASS-counted instructions over
the issue rates, the larger); the last is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or when a check fails, the script exits non-zero and prints no
``{"ok": true}`` line.  It imports no jax.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import ctypes
import functools
import itertools
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from twixt_for_open_spiel_tpu_torch import bench, bench_bitboard, bench_search_scaling, bench_selfplay
from twixt_for_open_spiel_tpu_torch import native, parallel
from twixt_for_open_spiel_tpu_torch.game import SpielError, load_game, playthrough
from twixt_for_open_spiel_tpu_torch.game.render import render_py
from twixt_for_open_spiel_tpu_torch.models import arena, convert, mcts, selfplay
from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net, init_params
from twixt_for_open_spiel_tpu_torch.native.engine import NativeEngine, load_engine, random_games
from twixt_for_open_spiel_tpu_torch.ops import _cuda, _sass
from twixt_for_open_spiel_tpu_torch.ops import bit_step as tstep
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr
from twixt_for_open_spiel_tpu_torch.ops import fused_tensor_rollout as ftr
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import layer_norm as tln
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll
from twixt_for_open_spiel_tpu_torch.ops import search_walk as twalk
from twixt_for_open_spiel_tpu_torch.ops import state as tstate
from twixt_for_open_spiel_tpu_torch.ops import observe as tobs
from twixt_for_open_spiel_tpu_torch.ops import store_skeleton as sk
from twixt_for_open_spiel_tpu_torch.ops.replay import bit_replay
from twixt_for_open_spiel_tpu_torch.utils import profiling, serialization
from twixt_for_open_spiel_tpu_torch.utils.timing import CLOCK_HZ, back_to_back_ms, device_ms

ROOT = pathlib.Path(__file__).resolve().parent


def _load_cases():
    """``tests/torch_port_cases.py`` as the top-level module
    ``torch_port_cases``: the card's machine may hold another package named
    ``tests``, and phase 26's spawned ranks, which start with this
    process's ``sys.path``, import the cases they run by that name."""
    sys.path.append(str(ROOT / "tests"))
    import torch_port_cases
    return torch_port_cases


cases = _load_cases()
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_rollout_digests.json"
TENSOR_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_tensor_rollout_digests.json"
KERNELS = ("fused_bit_rollout", "fused_tensor_rollout", "store_skeleton", "bit_step", "search",
           "layer_norm")
CSRC = "twixt_for_open_spiel_tpu_torch/csrc/"

# The card's published peaks (H100 SXM, NVIDIA's data sheet): 3.35 TB/s of
# HBM; 132 SMs at the 1.98 GHz boost clock.  The issue rates per SM and
# clock of each instruction class are in ops/_sass.py.
HBM_BYTES_PER_S = 3.35e12
SMS = 132

# --- the bitboard rollout (K1, K2) ------------------------------------------
# (board_size, batch, num_steps, seed, emit_obs): kernel vs plain version
EQUALITY_CASES = [
    (5, 256, 60, 3, False),
    (8, 4096, 256, 0, False),
    (12, 4096, 128, 7, False),
    (24, 4096, 64, 0, False),  # full width
    (12, 8192, 64, 1, False),  # two waves of blocks: bench_bitboard's rows
    (24, 8192, 64, 2, False),
    (8, 1000, 100, 13, False),
    (5, 1, 200, 11, False),  # a single env: one warp
    (24, 8192, 16, 5, True),  # full width, the wire by TMA
    (8, 1003, 100, 13, True),  # B % 4 != 0: the wire by plain stores, a ragged last block
    (12, 4100, 48, 21, True),  # by TMA, a last block of 4 envs
    (5, 264, 60, 6, True),  # P = 11
    (5, 1, 200, 11, True),
]
# the rollout rows of bench.py: (board_size, batch) at 1000 steps
RATE_ROWS = [(5, 256), (8, 4096), (12, 4096), (24, 4096)]
HEADLINE = (8, 4096)
RATE_STEPS = 1000
RATE_REPS = 5
OBS_ROW = (24, 8192, 16, 32)  # board, batch, steps per launch, launches

# --- the canonical-engine rollout (K3) --------------------------------------
# (board_size, batch, num_steps, seed, tile): kernel vs plain version
TENSOR_EQUALITY_CASES = [
    (5, 256, 60, 3, 256),
    (8, 4096, 128, 0, 256),
    (12, 4096, 64, 7, 256),
    (24, 4096, 32, 1, 256),  # full width
    (8, 1024, 64, 5, 128),
    (5, 1, 200, 11, 1),  # a single env: one warp
    (8, 1088, 64, 9, 64),
    (8, 1003, 64, 9, 17),  # 17 * 59 envs: no multiple of any envs per block <= 16 but 1
]
TENSOR_TILE = 256
# K3's headline bound when its kernel ran one thread per env (PERF.md), to
# show that the bound still counts the same work
THREAD_PER_ENV_K3_BOUND_MS = 0.5319
# the same for K1 at the headline and the K2 row (one thread per env, PERF.md)
THREAD_PER_ENV_K1_BOUND_MS = 0.0806
THREAD_PER_ENV_K2_BOUND_MS = 2.2884
ROLLOUT_ROW = (12, 4096, 8)  # random_rollout: board, batch, steps

# --- the store-stream probe (K4): the obs stream's shape at board 24 --------
# rows = 12 planes * P words, steps = the obs row's steps per launch, and
# grid * subl * lanes = its batch, one program per 256-env block as in K2
STORE_SHAPE = (12 * 30, 16, 2, 128, 32)  # rows, steps, subl, lanes, grid
STORE_REPS = 20

# --- the net, the search and the arena (torch and S1a-S1c on the card) ------
NET_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_net.json"
SEARCH_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_search.json"
ARENA_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_arena.json"
# board 12 (BASELINE config 5) at create_net's full width, the batch and
# simulations of scripts/train_arena_gate.py:47-49
NET_ROW = (12, 512)  # board, batch
NET_SEED, OBS_SEED = 1, 2
SEARCH_SIMS = 64
SEARCH_REPS = 3
NET_REPS = 20
ARENA_ROW = (8, 64, 16)  # board, batch, simulations: the full-width net vs the random bot
# |card - cpu| <= tol * max(1, max |cpu|): float32 with TF32 off (tight), and
# bfloat16 (its rounding at every layer; the bf16 - f32 gap is about 2**-7
# of the scale there on the CPU)
NET_TOL = {"f32": 1e-4, "bf16": 2.0**-4}
# the card's dense bfloat16 tensor-core peak (H100 SXM, NVIDIA's data sheet)
BF16_FLOPS_PER_S = 989e12

# --- the search's kernels (S1a bit_step, S1b select_walk, S1c backup_walk) --
# (board, batch, simulations, backup, search): searches with the bf16 128x6
# net in which every kernel call is held to its plain version on a copy of
# its inputs: config 5's width under both backups, and board 24 under the
# walk (201 slots); the PUCT search (S1b from the root) and the Gumbel one
# (S1b from its forced root edges)
S1_CHECK_ROWS = [(12, 512, 64, "amask", "puct"), (12, 512, 64, "walk", "puct"),
                 (24, 256, 200, "walk", "puct"), (12, 512, 64, "walk", "gumbel"),
                 (24, 256, 200, "walk", "gumbel")]
S1_TIMED_CALL = 32  # the kernels are timed on the inputs of this simulation
S1A_ONE_SLOT = (24, 4096)  # S1a from one slot: bit_replay's board and batch
S1A_EDGE_BATCH = 13  # not a multiple of S1a's envs a block
S1_REPS = 50  # launches back to back, a run
S1_PLAIN_REPS = 3
# the card's float32 peak outside the tensor cores (H100 SXM, NVIDIA's data sheet)
FP32_FLOPS_PER_S = 67e12
S1_REPLACES = {  # the JAX search's XLA-fused counterparts (no Pallas kernel)
    "bit_step": "twixt_for_open_spiel_tpu/ops/bitboard.py:276",
    "select_walk": "twixt_for_open_spiel_tpu/models/mcts.py:368",
    "backup_walk": "twixt_for_open_spiel_tpu/models/mcts.py:511",
}
S1_SOURCES = {"bit_step": "bit_step.cu", "select_walk": "search.cu", "backup_walk": "search.cu"}
# every comparison of a search kernel with its plain version in this run:
# name -> [calls, largest |kernel - plain|, every bit equal]
S1_ERRS: dict = {}
# slots at which one env's staged rows need more than 48 KB of shared
# memory (select_walk 62,512 bytes, backup_walk 56,000): the kernels opt in
# above 48 KB; the captured trees are padded with unlinked slots to these
S1_WIDE_SLOTS = {"select_walk": 2500, "backup_walk": 7000}
S1_WIDE_ENVS = 64
# the most slots at which one env's rows fit Hopper's 227 KB of shared
# memory a block (select_walk 232,440 bytes, backup_walk 232,448): the
# kernels run there, and one slot more is refused with the wrapper's error
S1_EDGE_SLOTS = {"select_walk": 9297, "backup_walk": 29_056}

# --- the net's LayerNorm (S2a forward, S2b backward: ops/layer_norm.py) -----
# kernel against plain version on the card, on the same inputs:
#   bfloat16 outputs and dx: two bf16 ulps of the output's scale (2**-6 of
#     max |plain|): y is rounded to bf16 after float32 sums taken in another
#     order, so it may land an ulp apart, and the residual epilogue rounds
#     twice; float32 outputs and dx: 1e-5 of the scale;
#   dres: equal (the masked gradient, exact in the dtype);
#   dgamma and dbeta: 2e-5 of each channel's sum of |terms|: a float32 sum
#     errs by at most about (terms a thread + the tree's depth) * 2**-24 of
#     that, here and in the plain version's sum.
S2_TOL = {"bf16": 2.0**-6, "f32": 1e-5, "param": 2e-5}
# every dtype, width and epilogue at a ragged row count (no multiple of any
# block's rows) and at the search's 61,440 rows, forward and backward
S2_EQUAL_ROWS = (1003, 12 * 10 * 512)
S2_REPS = 20  # launches back to back, a run
# a timed run cycles through this many bytes of distinct inputs and outputs,
# about five times the H100's 50 MB L2, so each launch reads from and
# writes to HBM as a net's call does
S2_ROTATE_BYTES = 256 << 20
S2_REPLACES = "twixt_for_open_spiel_tpu/models/network.py:33"  # XLA-fused, no Pallas
S2_SOURCE = CSRC + "layer_norm.cu"
# the paths whose S2 calls are recorded: label -> (net calls a unit, unit):
# the held config-5 search (65 forwards), self-play's warm-up ply (one
# search at 64x4: 65 forwards) and the held config-5 train step
S2_PATHS = {"search 128x6": (SEARCH_SIMS + 1, "a forward"),
            "self-play 64x4": (SEARCH_SIMS + 1, "a forward"),
            "train 64x4": (1, "a step")}
# label -> Counter of (kernel, dtype, channels, epilogue, rows) calls
S2_SHAPES: dict = {}
# label -> [calls, largest |kernel - plain|, every comparison within tolerance]
S2_ERRS: dict = {}

# --- self-play, the learner step and the driver ------------------------------
SELFPLAY_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_selfplay.json"
TRAIN_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_train.json"
# card vs CPU in float32 with TF32 off, and card vs the JAX record's summaries
TRAIN_TOL = {"metrics_rtol": 1e-5, "grad": 1e-5, "param_rtol": 2e-4, "param_atol": 1e-5,
             "summary": 1e-4}
# config 5 (docs/PERF.md:412-415): board, batch, chunk steps, simulations,
# channels, blocks; bf16; temp_moves 16; Dirichlet alpha 0.3, fraction 0.25
SELFPLAY_ROW = (12, 512, 32, 64, 64, 4)
SELFPLAY_TEMP_MOVES = 16
TRAIN_REPS = 5
TRAIN_LR = 1e-3  # train_arena_gate's --lr
# the driver's budget: a short run, then --resume one iteration further; its
# gates' searches cut from 8 to 4 simulations for the time limit
DRIVER = {"board_size": 8, "batch": 64, "chunk_steps": 8, "simulations": 16, "channels": 64,
          "blocks": 4, "arena_batch": 32, "arena_sims": 4, "seed": 0}

# --- the Gumbel and reuse searches and their arms ----------------------------
GUMBEL_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_gumbel.json"
REUSE_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_reuse.json"
ARMS_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_selfplay_arms.json"
GUMBEL_TOL = {"improved": 1e-6, "root_q": 1e-5}
ARMS_POLICY_TOL = 1e-6  # the Gumbel chunk's improved-policy targets
# config 5's chunk for the arms, cut from 32 to 8 plies for the time limit
ARM_CHUNK_STEPS = 8
# the arena arms at ARENA_ROW's board and batch with 8 simulations (cut from
# 16), and arena_match_asym's Gumbel side at 8 against PUCT at 16 (the JAX
# script's defaults are 16 and 64), for the time limit
ARENA_ARMS_SIMS = 8
ASYM_SIMS = (8, 16)
DRIVER_ARMS = (["--search=puct_reuse", "--arena_search=gumbel"], ["--search=gumbel"])

# --- the distributed learner (parallel/) -------------------------------------
SHARDED_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_sharded_rollout.json"
SHARED_RANKS = 2  # ranks sharing the card over gloo (phase 26)
SHARED_ROLLOUT_RANKS = (2, 4)  # phase 26 (a): the fixture's two worlds
SHARDED_REPS = 3
# tests/test_sharding.py::test_dist_train_step_matches_local's case: board,
# batch, plies, simulations, channels, blocks; SGD 0.1; microbatch 1 and 3
DIST_TRAIN = (5, 16, 6, 4, 16, 1)
DIST_TRAIN_TOL = {"rtol": 2e-5, "atol": 1e-6}
DIST_METRICS = ("loss", "policy_loss", "value_loss", "train_frames")
# phase 27: config 5 (SELFPLAY_ROW) with the chunk cut from 32 to 16 plies
DIST_CHUNK_STEPS = 16
DIST_ROOT_STEPS = 160  # random plies before the chunk, so that its episodes end
ALLREDUCE_REPS = 20

# --- the host side (phase 28: the adapter, the C engine, the replay) -------
HOST_GAMES = 2  # (c) full random C games at board 24 through the adapter on the card
# (d) board, games: the C engine's games with tests/test_soak.py's seeds
# 97 * n + b, widened from 256 to 4096 games at board 24
REPLAY_ROWS = [(24, 4096), (24, 256), (5, 256), (12, 256)]
C_GAMES_ROW = (24, 1, 4096)  # the C engine's random_games: board, seed, games
# (f) the search under torch.profiler: board, batch (config 5's), simulations
# (cut from 64 to keep the trace small)
PROFILE_ROW = (12, 512, 8)
PROFILE_SPAN = "chip_smoke/search_batch"
# (e) the example programs on the card: the arena at the arena row's cut,
# the MCTS example at board 5 with 4 simulations (cut from board 8 and 100)
EXAMPLES = {
    "example": ["--game=twixt(board_size=8)", "--seed=0"],
    "arena": ["--board_size=8", "--batch=64", "--simulations=16", "--random_b"],
    "mcts_example": ["--game=twixt(board_size=5)", "--max_simulations=4"],
}

# --- the benches and the checkpoint arenas (phase 29) -----------------------
# (a) the bench's headline against phase 5's K1 rate at the same row
BENCH_HEADLINE_RATIO = (0.5, 2.0)
# (c) config 5 at full width, its chunk cut from 16 plies to 1 and its timed
# iterations from 3 to 1 (the two warm-up iterations stay)
BENCH_CHUNK, BENCH_REPS = 1, 1
SELFPLAY_ARMS = ([], ["--gumbel"], ["--reuse"])
SCALING_CONFIGS = "512:64"
# (d) two seeded 64x4 board-8 checkpoints (seed, iteration): a run's
# directory and its best/; the arenas at the arena row's batch, 8 simulations
# (cut from the JAX scripts' 256 and 64, and 16 against 64).  The agreement
# script's two settings run as two programs side by side, each printing its
# vs_init and vs_random lines: (module, flags, lines)
CKPT_NET = (8, 64, 4)  # board, channels, blocks
CKPT_SEEDS = {"run": 1, "best": 2}
ARENA_FLAGS = ["--board_size=8", "--batch=64"]
ARENA_PROGRAMS = [
    ("arena_checkpoints", ["--sims=8"], 1),
    ("arena_gate_agreement", ["--settings=gumbel:8"], 2),
    ("arena_gate_agreement", ["--settings=puct:8"], 2),
]


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_abs_diff(pairs) -> int:
    """Largest |a - b| over tensor pairs (as int64); raises on any shape or
    dtype mismatch."""
    err = 0
    for a, b in pairs:
        require(a.shape == b.shape and a.dtype == b.dtype, "output shapes/dtypes")
        err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
    return err


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    fbr.fused_bit_rollout.launches = fbr.fused_bit_rollout.obs_launches = 0
    ftr.fused_random_rollout.launches = sk.store_skeleton.launches = 0
    tstep.bit_step.launches = twalk.select_walk.launches = twalk.backup_walk.launches = 0
    tln.layer_norm_forward.launches = tln.layer_norm_backward.launches = 0


def launch_counts() -> dict:
    """Every kernel's launches since the counts were last set to 0."""
    obs = fbr.fused_bit_rollout.obs_launches
    return {"K1": fbr.fused_bit_rollout.launches - obs, "K2": obs,
            "K3": ftr.fused_random_rollout.launches, "K4": sk.store_skeleton.launches,
            "S1a": tstep.bit_step.launches, "S1b": twalk.select_walk.launches,
            "S1c": twalk.backup_walk.launches, "S2a": tln.layer_norm_forward.launches,
            "S2b": tln.layer_norm_backward.launches}


SEARCH_KERNELS = ("S1a", "S1b", "S1c")
NET_KERNELS = ("S2a", "S2b")


def launched_only(what: str, allowed=SEARCH_KERNELS + NET_KERNELS, required=()) -> dict:
    """Require that ``what`` launched no kernel outside ``allowed`` and each
    of ``required`` at least once; print and return the counts."""
    got = launch_counts()
    others = {k: v for k, v in got.items() if v and k not in allowed}
    require(not others, f"{what} launches only {allowed}: {got}")
    require(all(got[k] > 0 for k in required), f"{what} launched {required}: {got}")
    print(f"[launches] {what}: " + ", ".join(f"{k} {got[k]}" for k in allowed))
    return got


def bit_pairs(a_out, b_out) -> list:
    pairs = list(zip(tbit.bitstate_leaves(a_out[0]), tbit.bitstate_leaves(b_out[0])))
    pairs += [(a_out[1][k], b_out[1][k]) for k in ("episodes", "results")]
    if len(a_out) == 3:
        pairs.append((a_out[2], b_out[2]))
    return pairs


def tensor_pairs(a_out, b_out) -> list:
    return list(zip(a_out[0], b_out[0])) + [(a_out[1], b_out[1]), (a_out[2], b_out[2])]


def timed_ms(fn, reps: int) -> list:
    """Milliseconds of each of ``reps`` calls of ``fn``, by CUDA events."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and the
    thread instructions ``ops`` (per class) over their issue rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = _sass.seconds(ops, SMS, CLOCK_HZ)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def combine(*terms) -> dict:
    """Sum of ``(multiplier, per-class counts)`` terms, per class."""
    return {c: sum(k * counts[c] for k, counts in terms) for c in _sass.CLASSES}


def is_hash(instr) -> bool:  # hash_u32's first multiplier
    return 0x7FEB352D in instr.immediates()


def bit_rollout_counts(cfg) -> dict:
    """K1/K2's per-class counts, from the SASS of the warp-per-env kernel,
    of the fewest instructions a lane can issue for (see ops/_sass.py):

      K1 step       one pass of the step loop through the draw: the block
                    with the noise hash and the 5 rounds of its scan
                    (SHFL.UP), every inner loop passed at most once;
      K2 step       the same pass through the staging block first;
      K2 stage row  the staging block: one lane's row of the 12 planes,
                    written to the shared tile (12 STS).

    The step loop is the smallest loop that holds the scan: the slow paths
    of the warp-synchronous ops (``BRA.DIV``), placed after the kernel's
    exit, jump back into the step and close larger loops around it."""
    def is_scan(instr) -> bool:
        return instr.opcode.startswith("SHFL.UP")

    def count(match, blocks) -> int:
        return sum(map(match, (i for b in blocks for i in cfg.instructions(b))))

    step = cfg.innermost_loop(is_scan, at_least=5)
    draws = [b for b in cfg.blocks_with(is_hash, step.body) if count(is_scan, [b]) >= 5]
    require(len(draws) >= 1, "K1's draw hashes the noise beside the 5 rounds of its scan")
    stages = [b for b in sorted(step.body) if count(lambda i: i.base == "STS", [b]) >= 12]
    require(len(stages) == 1, "K2 stages a lane's row of 12 planes in one block")
    require(count(lambda i: i.base == "UTMASTG", step.body) >= 2,
            "K2 stores a step's tile as two TMA boxes")
    return {
        "K1 step": cfg.iteration(step, via=draws[0]),
        "K2 step": cfg.iteration(step, via=(stages[0], draws[0])),
        "K2 stage row": dict(cfg.counts[stages[0]]),
    }


def sass_counts() -> dict:
    """Per-class instruction counts, from the SASS of the built rollout
    kernels, of the fewest a lane can issue for (see ops/_sass.py): K1's
    and K2's as :func:`bit_rollout_counts` finds them, and

      K3 step        one step, every inner loop passed at most once;
      K3 cell        one cell of the draw's P*P scan, not legal;
      K3 legal cell  one legal cell (the hash, the two logf, the compare).
    """
    bit = bit_rollout_counts(_sass.Cfg(_sass.parse(_sass.kernel_sass("fused_bit_rollout"))))
    ten = _sass.Cfg(_sass.parse(_sass.kernel_sass("fused_tensor_rollout")))
    draw = ten.innermost_loop(is_hash)
    hashes = ten.blocks_with(is_hash, draw.body)
    require(len(hashes) == 1 and sum(map(is_hash, ten.instructions(hashes[0]))) == 1,
            "K3's draw loop hashes one cell a pass")
    step = ten.largest_loop()
    require(draw.body < step.body, "K3's draw loop lies inside its step loop")
    butterfly = sum(i.opcode.startswith("SHFL.BFLY") for b in step.body
                    for i in ten.instructions(b))
    require(butterfly >= 10, "K3's step reduces the draw over the warp (5 rounds of 2 shuffles)")
    counts = {
        **bit,
        "K3 step": ten.iteration(step),
        "K3 cell": ten.iteration(draw),
        "K3 legal cell": ten.iteration(draw, via=hashes[0]),
    }
    for what, c in counts.items():
        print(f"[sass] {what}: {c}")
    return counts


def bit_state_bytes(n: int, batch: int) -> int:
    """Bytes of one BitState batch: 16 int32 planes, int16 compid, 5 int32
    scalars."""
    p = n + 2 * geo.PAD
    return batch * (16 * p * 4 + n * n * 2 + 5 * 4)


def bit_rollout_bound(sass: dict, n: int, batch: int, steps: int, obs: bool = False):
    """K1/K2: the state read and written once, the counters (and the obs
    stream) written once; per env-step the SASS count of one step, with obs
    plus P-1 more lanes' staging blocks (one a padded row: each lane's
    distinct work counted once)."""
    p = n + 2 * geo.PAD
    nbytes = 2 * bit_state_bytes(n, batch) + 5 * 4 * batch
    per_step = sass["K1 step"]
    if obs:
        nbytes += steps * batch * 12 * p * 4
        per_step = combine((1, sass["K2 step"]), (p - 1, sass["K2 stage row"]))
    return bound(nbytes, combine((steps * batch, per_step)))


def tensor_rollout_bound(sass: dict, n: int, batch: int, steps: int, legal_cells: int):
    """K3: the kernel's int32 state ([7,P,P,B] cells, [5,B] scalars) read
    and written once, actions and results written once.  Per env-step the
    SASS count of one step and of P*P-1 more cells of the draw's scan (the
    step's count may hold one; the warp's lanes share the cells, and each
    is counted once); per legal cell drawn (``legal_cells``,
    counted from this run's replay; one a step may be the step's) what a
    legal cell issues beyond the least cell."""
    p = n + 2 * geo.PAD
    nbytes = 2 * batch * (7 * p * p + 5) * 4 + 2 * steps * batch * 4
    least = {c: min(sass["K3 cell"][c], sass["K3 legal cell"][c]) for c in _sass.CLASSES}
    extra = {c: sass["K3 legal cell"][c] - least[c] for c in _sass.CLASSES}
    env_steps = steps * batch
    ops = combine((env_steps, sass["K3 step"]), (env_steps * (p * p - 1), least),
                  (max(legal_cells - env_steps, 0), extra))
    return bound(nbytes, ops)


def store_bytes(rows, steps, subl, lanes, grid) -> int:
    return steps * rows * grid * subl * lanes * 4


def build_all() -> None:
    """The CUDA sources (one nvcc each, all at once) and, beside them, the
    C host engine and renderer (phase 28 needs both; a failed build fails
    the run)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        c_libs = [pool.submit(native.load_lib, stem) for stem in ("render", "engine")]
        _cuda.build(*KERNELS)
        cuda_s = time.perf_counter() - t0
        for stem, lib in zip(("render", "engine"), c_libs):
            require(lib.result() is not None,
                    f"the C {stem} builds: {native.build_errors.get(stem)}")
    print(f"[build] nvcc sm_90a, {len(KERNELS)} sources in parallel: {cuda_s:.3f} s; "
          f"the C renderer and engine beside them: {time.perf_counter() - t0:.3f} s")
    for name in KERNELS:
        for line in (_cuda.BUILD / f"lib{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def bitboard_path(dev, sass: dict) -> dict:
    """Phases 3-5: K1/K2 against the plain version, the JAX anchor, rates."""
    max_err = {False: 0, True: 0}
    shapes = set()  # (emit_obs, by TMA, last block ragged, single env)
    for n, b, steps, seed, emit in EQUALITY_CASES:
        bs = tbit.bit_reset(n, b, dev)
        got = fbr.fused_bit_rollout(seed, n, steps, bs, emit_obs=emit)
        torch.cuda.synchronize()
        want = fbr.fused_bit_rollout_reference(seed, n, steps, bs, emit_obs=emit)
        err = max_abs_diff(bit_pairs(got, want))
        max_err[emit] = max(max_err[emit], err)
        episodes = int(got[1]["episodes"])
        envs = fbr.envs_per_block(n, b, emit, dev)
        tma = emit and b % 4 == 0
        shapes.add((emit, tma, b % envs != 0, b == 1))
        wire = (", wire by " + ("TMA" if tma else "plain stores")) if emit else ""
        print(f"[K1 equal] n={n} batch={b} steps={steps} seed={seed} emit_obs={emit} "
              f"envs/block={envs} (last block {b % envs or envs} envs){wire}: "
              f"max_abs_err={err} episodes={episodes}")
        require(err == 0, f"K1/K2 kernel != plain at n={n} batch={b} emit_obs={emit}")
        require(int(got[1]["results"].sum()) == episodes, "results sum to episodes")
    for what, match in [
        ("K2's wire by TMA, a ragged last block", lambda emit, tma, ragged, one: tma and ragged),
        ("K2's wire by plain stores", lambda emit, tma, ragged, one: emit and not tma),
        ("a single env without the wire", lambda emit, tma, ragged, one: one and not emit),
        ("a single env with the wire", lambda emit, tma, ragged, one: one and emit),
    ]:
        require(any(match(*s) for s in shapes), f"an equality case: {what}")

    zero_counts()  # the main path from here on: count only its launches

    for case in json.loads(FIXTURE.read_text())["cases"]:
        n, b = case["board_size"], case["batch"]
        final, stats = fbr.fused_bit_rollout(
            case["seed"], n, case["num_steps"], tbit.bit_reset(n, b, dev)
        )
        digest = tbit.state_digest(final)
        print(f"[K1 anchor] n={n} batch={b} steps={case['num_steps']} "
              f"digest={digest[:16]} episodes={int(stats['episodes'])}")
        require(digest == case["digest"], f"digest vs JAX at n={n}")
        require(int(stats["episodes"]) == case["episodes"], "episodes vs JAX")
        require(stats["results"].tolist() == case["results"], "results vs JAX")

    rates = {}
    for n, b in RATE_ROWS:
        state = [tbit.bit_reset(n, b, dev)]

        def run(n=n, state=state):
            state[0] = fbr.fused_bit_rollout(0, n, RATE_STEPS, state[0])[0]

        fbr.fused_bit_rollout(0, n, 10, state[0])  # warm-up
        ms = timed_ms(run, RATE_REPS)
        med = statistics.median(ms)
        rates[(n, b)] = med
        bound_ms, by = bit_rollout_bound(sass, n, b, RATE_STEPS)
        print(f"[K1 rate] n={n} batch={b} steps={RATE_STEPS} "
              f"envs/block={fbr.envs_per_block(n, b, False, dev)}: "
              f"median {med} ms of {ms} -> {b * RATE_STEPS / med * 1e3} env-steps/s; "
              f"bound {bound_ms} ms ({by})")
    n, b, chunk, launches = OBS_ROW
    state = [tbit.bit_reset(n, b, dev)]

    def run_obs():
        for _ in range(launches):
            state[0], _, obs = fbr.fused_bit_rollout(0, n, chunk, state[0], emit_obs=True)
            require(obs.shape == (chunk, 12, n + 6, b), "obs shape")

    fbr.fused_bit_rollout(0, n, chunk, state[0], emit_obs=True)  # warm-up
    obs_runs = timed_ms(run_obs, RATE_REPS)
    obs_ms = statistics.median(obs_runs)
    obs_bytes = launches * chunk * b * 12 * (n + 6) * 4
    one_ms, obs_by = bit_rollout_bound(sass, n, b, chunk, obs=True)
    print(f"[K2 rate] emit_obs n={n} batch={b} envs/block={fbr.envs_per_block(n, b, True, dev)} "
          f"{launches}x{chunk} steps: median {obs_ms} ms of {obs_runs} -> "
          f"{b * chunk * launches / obs_ms * 1e3} env-steps/s, obs stream "
          f"{obs_bytes / obs_ms / 1e6} GB/s; bound {one_ms * launches} ms ({obs_by}); "
          f"one thread per env: {THREAD_PER_ENV_K2_BOUND_MS} ms, ratio "
          f"{one_ms * launches / THREAD_PER_ENV_K2_BOUND_MS}")

    launches_main = fbr.fused_bit_rollout.launches
    obs_launches = fbr.fused_bit_rollout.obs_launches
    require(launches_main - obs_launches > 0 and obs_launches > 0,
            "the bitboard path launched both arms of its kernel")
    launched_only("the bitboard path", allowed=("K1", "K2"))

    n, b = HEADLINE
    bs = tbit.bit_reset(n, b, dev)
    fbr.fused_bit_rollout_reference(0, n, 10, bs)  # warm-up
    (plain_ms,) = timed_ms(lambda: fbr.fused_bit_rollout_reference(0, n, RATE_STEPS, bs), 1)
    print(f"[K1 rate] plain n={n} batch={b} steps={RATE_STEPS}: {plain_ms} ms -> "
          f"{b * RATE_STEPS / plain_ms * 1e3} env-steps/s")
    n, b, chunk, launches = OBS_ROW
    state = [tbit.bit_reset(n, b, dev)]

    def run_obs_plain():
        for _ in range(launches):
            state[0] = fbr.fused_bit_rollout_reference(0, n, chunk, state[0], emit_obs=True)[0]

    (obs_plain_ms,) = timed_ms(run_obs_plain, 1)
    print(f"[K2 rate] plain emit_obs n={n} batch={b} {launches}x{chunk} steps: "
          f"{obs_plain_ms} ms -> {b * chunk * launches / obs_plain_ms * 1e3} env-steps/s")
    require(fbr.fused_bit_rollout.launches == launches_main, "the plain runs launched nothing")
    n, b = HEADLINE
    bound_ms, by = bit_rollout_bound(sass, n, b, RATE_STEPS)
    print(f"[K1 bound] n={n} batch={b} steps={RATE_STEPS}: {bound_ms} ms ({by}); "
          f"one thread per env: {THREAD_PER_ENV_K1_BOUND_MS} ms, ratio "
          f"{bound_ms / THREAD_PER_ENV_K1_BOUND_MS}")
    entry = {"route": "cuda", "source": CSRC + "fused_bit_rollout.cu", "library_ms": None}
    return {
        "reports": [
            {"name": "fused_bit_rollout", **entry,
             "replaces": "twixt_for_open_spiel_tpu/ops/fused_bit_rollout.py:436",
             "launches": launches_main - obs_launches, "max_abs_err": max_err[False],
             "ms": rates[HEADLINE], "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": by},
            {"name": "fused_bit_rollout(emit_obs=True)", **entry,
             "replaces": "twixt_for_open_spiel_tpu/ops/fused_bit_rollout.py:436",
             "launches": obs_launches, "max_abs_err": max_err[True],
             "ms": obs_ms / launches, "plain_ms": obs_plain_ms / launches,
             "bound_ms": one_ms, "bound_by": obs_by},
        ],
        "obs_bytes_per_s": obs_bytes / obs_ms * 1e3,
        "rates": rates,
    }


def tensor_path(dev, sass: dict, k1_rates: dict) -> dict:
    """Phases 6-9: K3 against the plain version, the JAX anchor, the replay,
    rates (beside K1's, ``k1_rates``) and the plain random_rollout."""
    max_err, ragged = 0, 0
    for n, b, steps, seed, tile in TENSOR_EQUALITY_CASES:
        s0 = troll.batch_reset(n, b, dev)
        got = ftr.fused_random_rollout(seed, n, steps, s0, tile=tile)
        torch.cuda.synchronize()
        want = ftr.fused_random_rollout_reference(seed, n, steps, s0, tile=tile)
        err = max_abs_diff(tensor_pairs(got, want))
        max_err = max(max_err, err)
        episodes = int(ftr.rollout_stats(got[2])["episodes"])
        envs = ftr.envs_per_block(n, b, dev)
        ragged += b % envs != 0
        print(f"[K3 equal] n={n} batch={b} steps={steps} seed={seed} tile={tile} "
              f"envs/block={envs} (last block {b % envs or envs} envs): "
              f"max_abs_err={err} episodes={episodes}")
        require(err == 0, f"K3 kernel != plain at n={n} batch={b} tile={tile}")
    require(ragged > 0, "a case whose last block of envs is ragged")
    try:
        ftr.fused_random_rollout(0, 8, 4, troll.batch_reset(8, 4096 + 64, dev))
    except ValueError as e:
        print(f"[K3 equal] batch 4160, tile 256 raises: {e}")
    else:
        raise RuntimeError("check failed: a batch that is no multiple of the tile ran")

    zero_counts()  # the main path from here on: count only its launches

    for case in json.loads(TENSOR_FIXTURE.read_text())["cases"]:
        n, b, steps = case["board_size"], case["batch"], case["num_steps"]
        final, actions, results = ftr.fused_random_rollout(
            case["seed"], n, steps, troll.batch_reset(n, b, dev), tile=case["tile"]
        )
        stats = ftr.rollout_stats(results)
        digest = tstate.state_digest(list(final))
        print(f"[K3 anchor] n={n} batch={b} steps={steps} tile={case['tile']} "
              f"digest={digest[:16]} episodes={int(stats['episodes'])}")
        require(digest == case["digest"], f"K3 final-state digest vs JAX at n={n}")
        require(tstate.state_digest([actions]) == case["actions_digest"],
                f"K3 actions digest vs JAX at n={n}")
        require(int(stats["episodes"]) == case["episodes"], "K3 episodes vs JAX")
        require(stats["results"].tolist() == case["results"], "K3 results vs JAX")

    # replay the headline launch through the plain batched step
    n, b = HEADLINE
    s0 = troll.batch_reset(n, b, dev)
    final, actions, results = ftr.fused_random_rollout(0, n, RATE_STEPS, s0, tile=TENSOR_TILE)
    s, legal_cells = s0, 0
    for k in range(RATE_STEPS):
        legal = tstate.legal_mask_flat(s, s.current_player.clamp(0, 1), n)  # [A, B]
        legal_cells += int(legal.sum())
        require(bool(legal[actions[k].long(), torch.arange(b, device=dev)].all()),
                f"K3 action legal at step {k}")
        s, _, result = troll.step_auto_reset(s, actions[k], n)
        require(torch.equal(result, results[k]), f"K3 replay result at step {k}")
    require(all(torch.equal(a, c) for a, c in zip(final, s)), "K3 replay final state")
    stats = ftr.rollout_stats(results)
    print(f"[K3 replay] n={n} batch={b} steps={RATE_STEPS}: results and final state "
          f"equal; episodes={int(stats['episodes'])} results={stats['results'].tolist()}; "
          f"legal cells drawn over: {legal_cells}")

    rates = {}
    for n, b in RATE_ROWS:
        s0 = troll.batch_reset(n, b, dev)
        ftr.fused_random_rollout(0, n, 10, s0, tile=TENSOR_TILE)  # warm-up
        ms = timed_ms(lambda: ftr.fused_random_rollout(0, n, RATE_STEPS, s0, tile=TENSOR_TILE),
                      RATE_REPS)
        rates[(n, b)] = statistics.median(ms)
        print(f"[K3 rate] n={n} batch={b} steps={RATE_STEPS} tile={TENSOR_TILE} "
              f"envs/block={ftr.envs_per_block(n, b, dev)}: "
              f"median {rates[(n, b)]} ms of {ms} -> "
              f"{b * RATE_STEPS / rates[(n, b)] * 1e3} env-steps/s; "
              f"K3/K1 time {rates[(n, b)] / k1_rates[(n, b)]}")

    n, b, steps = ROLLOUT_ROW
    g = torch.Generator(device=dev).manual_seed(0)
    final, stats = troll.random_rollout(g, n, steps, troll.batch_reset(n, b, dev))
    torch.cuda.synchronize()
    episodes = int(stats["episodes"])
    require(int(stats["results"].sum()) == episodes, "random_rollout results sum to episodes")
    require(bool((final.result == geo.RESULT_OPEN).all()), "no env left terminal")
    require(final.color.shape == (n + 6, n + 6, b), "random_rollout state shape")
    print(f"[rollout] random_rollout n={n} batch={b} steps={steps} on the card: "
          f"episodes={episodes}, no env left terminal")

    launches_main = ftr.fused_random_rollout.launches
    require(launches_main > 0, "the canonical-engine path launched its kernel")
    launched_only("the canonical-engine path", allowed=("K3",))

    n, b = HEADLINE
    s0 = troll.batch_reset(n, b, dev)
    ftr.fused_random_rollout_reference(0, n, 10, s0, tile=TENSOR_TILE)  # warm-up
    (plain_ms,) = timed_ms(
        lambda: ftr.fused_random_rollout_reference(0, n, RATE_STEPS, s0, tile=TENSOR_TILE), 1
    )
    print(f"[K3 rate] plain n={n} batch={b} steps={RATE_STEPS}: {plain_ms} ms -> "
          f"{b * RATE_STEPS / plain_ms * 1e3} env-steps/s")
    bound_ms, by = tensor_rollout_bound(sass, n, b, RATE_STEPS, legal_cells)
    print(f"[K3 bound] n={n} batch={b} steps={RATE_STEPS}: {bound_ms} ms ({by}); "
          f"one thread per env: {THREAD_PER_ENV_K3_BOUND_MS} ms, ratio "
          f"{bound_ms / THREAD_PER_ENV_K3_BOUND_MS}")
    return {
        "name": "fused_tensor_rollout",
        "route": "cuda",
        "source": CSRC + "fused_tensor_rollout.cu",
        "replaces": "scripts/archive_fused_tensor_rollout.py:255",
        "launches": launches_main,
        "max_abs_err": max_err,
        "ms": rates[HEADLINE],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": by,
        "library_ms": None,
    }


def store_path(dev, obs_bytes_per_s: float) -> dict:
    """Phase 10: K4 against its plain version, and its store rate."""
    got = sk.store_skeleton(*STORE_SHAPE, device=dev)
    torch.cuda.synchronize()
    want = sk.store_skeleton_reference(*STORE_SHAPE, device=dev)
    max_err = max_abs_diff([(got, want)])
    print(f"[K4 equal] rows, steps, subl, lanes, grid = {STORE_SHAPE}: max_abs_err={max_err}")
    require(max_err == 0, "K4 kernel != plain")

    zero_counts()  # the main path from here on: count only its launches
    last = [sk.store_skeleton(*STORE_SHAPE, device=dev)]  # warm-up

    def run():
        last[0] = sk.store_skeleton(*STORE_SHAPE, device=dev)

    ms = statistics.median(back_to_back_ms(run, STORE_REPS))
    require(torch.equal(last[0], want), "K4's timed output equals the plain version's")
    launches_main = sk.store_skeleton.launches
    require(launches_main > 0, "the probe path launched its kernel")
    launched_only("the probe path", allowed=("K4",))

    sk.store_skeleton_reference(*STORE_SHAPE, device=dev)  # warm-up
    plain_ms = statistics.median(back_to_back_ms(
        lambda: sk.store_skeleton_reference(*STORE_SHAPE, device=dev), STORE_REPS))
    # the library call: PyTorch's broadcast copy of the k+j column
    column = want[:, :1, :1].clone()
    require(torch.equal(column.expand(want.shape).contiguous(), want), "the library copy")
    library_ms = statistics.median(back_to_back_ms(
        lambda: column.expand(want.shape).contiguous(), STORE_REPS))
    nbytes = store_bytes(*STORE_SHAPE)
    # operations: at least one 16-byte store instruction per 16 bytes
    stores = nbytes / 16
    bound_ms, by = bound(nbytes, dict.fromkeys(_sass.CLASSES, 0) | {"issue": stores,
                                                                   "mem": stores})
    print(f"[K4 rate] {nbytes} bytes: kernel {ms} ms -> {nbytes / ms / 1e6} GB/s "
          f"(card 3350 GB/s; K2's obs stream {obs_bytes_per_s / 1e9} GB/s); "
          f"plain {plain_ms} ms -> {nbytes / plain_ms / 1e6} GB/s; library "
          f"expand().contiguous() {library_ms} ms -> {nbytes / library_ms / 1e6} GB/s; "
          f"bound {bound_ms} ms ({by}); kernel/library {ms / library_ms}, "
          f"share of the bound {bound_ms / ms}")
    return {
        "name": "store_skeleton",
        "route": "cuda",
        "source": CSRC + "store_skeleton.cu",
        "replaces": "scripts/repro_mosaic_dma_tile.py:90",
        "launches": launches_main,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": by,
        "library_ms": library_ms,
    }


class no_tf32:
    """cuDNN convolutions and matmuls in true float32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|), both moved to the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    require(got.shape == want.shape and bool(torch.isfinite(got).all()), "finite outputs")
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def net_flops(net, batch: int) -> int:
    """Multiply-adds x 2 of the net's convolutions and Dense layers."""
    n = net.board_size
    cells = n * (n - 2)
    flops = 0
    for name, w in net.named_parameters():
        if name.endswith("weight") and w.ndim == 4:  # conv OIHW over every cell
            flops += 2 * batch * cells * w.numel()
        elif name.endswith("weight") and w.ndim == 2:  # Dense [out, in]
            flops += 2 * batch * w.numel()
    return flops


def net_path(dev, card: str) -> float:
    """Phases 11-12: the net on the card against the CPU and the JAX anchor;
    the bf16 forward's time at full width.  Returns that time in ms."""
    zero_counts()
    n, b = NET_ROW
    tree = convert.params_to_flax(cases.random_state_dict(n, 128, 6, NET_SEED))
    obs = torch.from_numpy(cases.random_obs(b, n, OBS_SEED))
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        on_card = convert.load_flax_params(create_net(n, dtype=dtype, device=dev), tree)
        on_cpu = convert.load_flax_params(create_net(n, dtype=dtype, device="cpu"), tree)
        with torch.no_grad(), no_tf32():
            card_out = on_card(obs.to(dev))
            torch.cuda.synchronize()
            cpu_out = on_cpu(obs)
        errs = [rel_err(c, w) for c, w in zip(card_out, cpu_out)]
        print(f"[net equal] n={n} batch={b} 128 channels 6 blocks {kind} (TF32 off): "
              f"card vs CPU max |diff| / scale logits {errs[0]} value {errs[1]} "
              f"(tolerance {NET_TOL[kind]}); value range "
              f"[{float(cpu_out[1].min())}, {float(cpu_out[1].max())}]")
        require(max(errs) <= NET_TOL[kind], f"{kind} net card vs CPU")

    rec = json.loads(NET_FIXTURE.read_text())
    rn, ch, blocks = rec["board_size"], rec["channels"], rec["blocks"]
    small = create_net(rn, ch, blocks, dtype=torch.float32, device=dev)
    small.load_state_dict(cases.random_state_dict(rn, ch, blocks, rec["param_seed"]))
    with torch.no_grad(), no_tf32():
        logits, value = small(torch.from_numpy(
            cases.random_obs(rec["batch"], rn, rec["obs_seed"])).to(dev))
    errs = [rel_err(logits, torch.tensor(rec["logits"])), rel_err(value, torch.tensor(rec["value"]))]
    print(f"[net anchor] n={rn} {ch} channels {blocks} block f32 vs JAX "
          f"(tests/fixtures/torch_port_net.json): logits {errs[0]} value {errs[1]} (tolerance 1e-05)")
    require(max(errs) <= 1e-5, "the net on the card vs the JAX anchor")

    net = create_net(n, device=dev)
    x = obs.to(dev)
    with torch.no_grad():
        net(x)  # warm-up
        ms = timed_ms(lambda: net(x), NET_REPS)
    med = statistics.median(ms)
    flops = net_flops(net, b)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    print(f"[net rate] bf16 forward n={n} batch={b} 128 channels 6 blocks: median {med} ms "
          f"of {NET_REPS} ({min(ms)}-{max(ms)}); {flops / 1e9} GFLOP -> "
          f"{flops / med / 1e9} TFLOP/s; bound {bound_ms} ms at {BF16_FLOPS_PER_S / 1e12} "
          f"TFLOP/s bf16 dense (operations), share {bound_ms / med} [{card}]")
    launched_only("the net path", allowed=("S2a",), required=("S2a",))
    return med


# --- the net's LayerNorm (S2) ------------------------------------------------
def s2_kind(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def within(got, want, tol) -> tuple:
    """(largest |got - want|, every |got - want| <= tol): ``tol`` a number or
    a tensor that broadcasts."""
    if got.numel() == 0:
        return 0.0, True
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= tol).all())


def s2_forward_diff(x, got, want) -> tuple:
    """A forward's (largest |kernel - plain|, within S2_TOL) over its
    output."""
    return within(got, want, S2_TOL[s2_kind(x.dtype)] * float(want.float().abs().max()))


def s2_backward_diff(args, out, got, want) -> tuple:
    """A backward's (largest |kernel - plain|, within S2_TOL) over dx, the
    parameters' gradients (against each channel's sum of |terms|) and dres;
    ``args`` the backward's, ``out`` the kernel forward's output, whose
    mask both versions took."""
    dout, x, weight, bias, epilogue, residual = args
    c = x.shape[-1]
    dy = (dout if epilogue is None else torch.where(out > 0, dout, 0)).float().reshape(-1, c)
    mean, rstd = tln.layer_norm_stats(x)
    xhat = (x.float() - mean[..., None]) * rstd[..., None]
    mass = [(dy * xhat.reshape(-1, c)).abs().sum(0), dy.abs().sum(0)]
    pairs = [(got[0], want[0], S2_TOL[s2_kind(x.dtype)] * float(want[0].float().abs().max())),
             (got[1], want[1], S2_TOL["param"] * mass[0]),
             (got[2], want[2], S2_TOL["param"] * mass[1])]
    if epilogue == "residual":
        pairs.append((got[3], want[3], 0.0))
    checks = [within(*pair) for pair in pairs]
    return max(e for e, _ in checks), all(ok for _, ok in checks)


def s2_kernel_out(launch, x, weight, bias, epilogue, residual):
    """S2a's output on these inputs by ``launch`` (``tln._launch_forward``),
    to give the plain backward the mask the kernel's backward computes
    again; a comparison's launch, not counted."""
    launches = tln.layer_norm_forward.launches
    out = launch(x, weight, bias, epilogue, residual)
    tln.layer_norm_forward.launches = launches
    return out


def note_s2(path: str, result: tuple) -> None:
    calls, worst, ok = S2_ERRS.get(path, (0, 0.0, True))
    S2_ERRS[path] = (calls + 1, max(worst, result[0]), ok and result[1])


@contextlib.contextmanager
def held_s2(path: str, hold: bool = True):
    """For the block, ``ops/layer_norm.py``'s two launchers (what its
    dispatchers call for a CUDA tensor) count each call's shape in
    ``S2_SHAPES[path]`` and, with ``hold``, run the plain version too on
    copies of the same inputs, go on with the kernel's outputs and add the
    comparison to ``S2_ERRS[path]``."""
    real_fwd, real_bwd = tln._launch_forward, tln._launch_backward
    shapes = S2_SHAPES.setdefault(path, collections.Counter())

    def forward(x, weight, bias, epilogue, residual):
        c = x.shape[-1]
        shapes["S2a", x.dtype, c, epilogue, x.numel() // c] += 1
        if not hold:
            return real_fwd(x, weight, bias, epilogue, residual)
        copies = [None if t is None else t.clone() for t in (x, weight, bias, residual)]
        got = real_fwd(x, weight, bias, epilogue, residual)
        want = tln.layer_norm_reference(copies[0], copies[1], copies[2], epilogue, copies[3])
        note_s2(path, s2_forward_diff(x, got, want))
        return got

    def backward(dout, x, weight, bias, epilogue, residual):
        c = x.shape[-1]
        shapes["S2b", x.dtype, c, epilogue, x.numel() // c] += 1
        if not hold:
            return real_bwd(dout, x, weight, bias, epilogue, residual)
        dout_, x_, weight_, bias_, res_ = (None if t is None else t.clone()
                                           for t in (dout, x, weight, bias, residual))
        got = real_bwd(dout, x, weight, bias, epilogue, residual)
        args = (dout_, x_, weight_, bias_, epilogue, res_)
        out = (None if epilogue is None else
               s2_kernel_out(real_fwd, x_, weight_, bias_, epilogue, res_))
        want = tln.layer_norm_backward_reference(*args, out=out)
        note_s2(path, s2_backward_diff(args, out, got, want))
        return got

    tln._launch_forward, tln._launch_backward = forward, backward
    try:
        yield
    finally:
        tln._launch_forward, tln._launch_backward = real_fwd, real_bwd


def report_s2_equal(path: str) -> None:
    calls, err, ok = S2_ERRS[path]
    print(f"[S2 equal] {path}: {calls} calls held to the plain version, max_abs_err {err}, "
          f"within tolerance {ok} (S2_TOL {S2_TOL})")
    require(ok and calls > 0, f"S2 equals its plain version ({path})")


def s2_inputs(dev, dtype, c: int, epilogue, rows: int, seed: int) -> dict:
    """Seeded activations (off zero mean, as a convolution's), parameters and
    a gradient on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return {"x": (normal(rows, c) * 1.2 + 0.3).to(dtype),
            "weight": normal(c) * 0.3 + 1.0, "bias": normal(c) * 0.3,
            "residual": normal(rows, c).to(dtype) if epilogue == "residual" else None,
            "dout": normal(rows, c).to(dtype)}


def s2_once(case: dict, epilogue) -> tuple:
    """One forward and backward by the kernels and by the plain version
    (given the kernel forward's output for its mask): ((kernel, plain)
    forward, (backward args, kernel, plain) backward)."""
    x, w, b, res, dout = (case[k] for k in ("x", "weight", "bias", "residual", "dout"))
    fwd = tln.layer_norm_forward(x, w, b, epilogue, res)
    fwd_plain = tln.layer_norm_reference(x, w, b, epilogue, res)
    args = (dout, x, w, b, epilogue, res)
    return (fwd, fwd_plain), (args, tln.layer_norm_backward(*args),
                              tln.layer_norm_backward_reference(*args, out=fwd))


def layer_norm_equal_path(dev) -> None:
    """Phase 12 (b): S2a and S2b against their plain versions at every dtype,
    width and epilogue, at a ragged row count and the search's; two runs of
    the backward bit-equal; the net's convolutions hand LayerNorm contiguous
    NHWC rows, so that its ``contiguous()`` copies nothing."""
    worst, n = 0.0, 0
    for rows in S2_EQUAL_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            for c in tln.CHANNELS:
                for epilogue in tln.EPILOGUES:
                    case = s2_inputs(dev, dtype, c, epilogue, rows, seed=rows + c)
                    (fwd, fwd_plain), (args, bwd, bwd_plain) = s2_once(case, epilogue)
                    again = tln.layer_norm_backward(*args)
                    f_err, f_ok = s2_forward_diff(case["x"], fwd, fwd_plain)
                    b_err, b_ok = s2_backward_diff(args, fwd, bwd, bwd_plain)
                    same = all(torch.equal(a, b) for a, b in zip(bwd, again) if a is not None)
                    what = f"S2 {s2_kind(dtype)} C={c} {epilogue} rows={rows}"
                    require(f_ok, f"{what}: the forward vs plain ({f_err})")
                    require(b_ok, f"{what}: the backward vs plain ({b_err})")
                    require(same, f"{what}: two backward runs bit-equal")
                    worst, n = max(worst, f_err, b_err), n + 1
    torch.cuda.synchronize()
    print(f"[S2 equal] S2a and S2b vs plain at bf16/f32 x C {tln.CHANNELS} x epilogues "
          f"{list(tln.EPILOGUES)} x rows {S2_EQUAL_ROWS}: {n} cases, max_abs_err {worst}, all "
          f"within S2_TOL; each backward run twice, bit-equal")
    n, b = NET_ROW
    net = create_net(n, device=dev)
    with torch.no_grad():
        y = net.stem(torch.from_numpy(cases.random_obs(b, n, OBS_SEED)).to(dev)
                     .permute(0, 2, 3, 1).to(net.dtype))
    require(y.is_contiguous(), "the convolutions' NHWC outputs are contiguous")


def s2_bound(kernel: str, dtype, c: int, epilogue, rows: int) -> tuple:
    """(bound_ms, bound_by) of one launch: the bytes the function needs,
    each read or written once, at 3.35 TB/s, against its float operations
    (about 9 an element forward; 22 backward, which computes the
    statistics and y again) at the float32 peak."""
    e = rows * c * (2 if dtype == torch.bfloat16 else 4)
    res = e if epilogue == "residual" else 0
    if kernel == "S2a":  # x and the residual in, out out; gamma and beta
        nbytes, flops = 2 * e + res + 8 * c, 9 * rows * c
    else:  # dout, x and the residual in, dx and dres out; the parameters in, their grads out
        nbytes, flops = 3 * e + 2 * res + 16 * c, 22 * rows * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def s2_library(x, w, b, epilogue, residual):
    """What the port computed before S2, with PyTorch's own kernels:
    ``F.layer_norm`` on a float32 copy, the cast back, the ReLU, the add."""
    y = torch.nn.functional.layer_norm(x.float(), w.shape, w, b, tln.LN_EPS).to(x.dtype)
    if epilogue == "residual":
        y = residual + y
    return torch.relu(y) if epilogue is not None else y


def rotation(fns: list):
    """A call that runs ``fns`` in turn, keeping the last ``len(fns)``
    results alive, so that no launch finds its inputs, or its output's
    memory, still in L2 from the one before (``S2_ROTATE_BYTES``)."""
    kept = collections.deque(maxlen=len(fns))
    turn = itertools.count()

    def call():
        kept.append(fns[next(turn) % len(fns)]())
    return call


def layer_norm_rate_path(dev, card: str, launches: dict) -> list:
    """Phase 18 (b): each S2 shape the recorded paths called (the config-5
    search's forward, self-play's at 64x4, the config-5 train step's
    forward and backward): the device time of a launch (``device_ms``) and
    a call's time back to back, of the kernel, the plain version and the
    library composite (``s2_library``, forward and its autograd backward),
    each cycling through ``S2_ROTATE_BYTES`` of inputs (``rotation``),
    beside the bound; then, per path, the device times' sums over one net
    call or step.  Returns the kernels line's S2 entries.

    First the same timing on PyTorch's own copy (``clone`` of 256 MiB,
    two sources in turn): the rate the card reaches on bytes read and
    written once, beside the 3.35 TB/s the bounds take."""
    copies = [torch.empty(S2_ROTATE_BYTES, dtype=torch.uint8, device=dev) for _ in range(2)]
    fns = [functools.partial(torch.clone, t) for t in copies]
    ms = device_ms(rotation(fns), S2_REPS)
    wall = statistics.median(back_to_back_ms(rotation(fns), S2_REPS))
    print(f"[S2 rate] HBM: torch.clone of {S2_ROTATE_BYTES} bytes, timed as S2 is: device ms a "
          f"call {ms} ({2 * S2_ROTATE_BYTES / ms / 1e9} TB/s read and written), back to back "
          f"{wall} ({2 * S2_ROTATE_BYTES / wall / 1e9} TB/s); the bounds take "
          f"{HBM_BYTES_PER_S / 1e12} TB/s [{card}]")
    del copies, fns
    per_key = {}
    for path, counter in S2_SHAPES.items():
        for key in counter:
            per_key.setdefault(key, []).append(path)
    timed = {}
    for key, paths in per_key.items():
        kernel, dtype, c, epilogue, rows = key
        bound_ms, by = s2_bound(*key)
        copies = max(2, math.ceil(S2_ROTATE_BYTES / (bound_ms * 1e-3 * HBM_BYTES_PER_S)))
        cases = [s2_inputs(dev, dtype, c, epilogue, rows, seed=c + i) for i in range(copies)]
        (fwd, fwd_plain), (args, bwd, bwd_plain) = s2_once(cases[0], epilogue)
        if kernel == "S2a":
            err, ok = s2_forward_diff(args[1], fwd, fwd_plain)
        else:
            err, ok = s2_backward_diff(args, fwd, bwd, bwd_plain)
        require(ok, f"S2 {key}: kernel vs plain ({err})")
        fns = {"kernel": [], "plain": [], "library": []}
        for case in cases:
            x, w, b, res, dout = (case[k] for k in ("x", "weight", "bias", "residual", "dout"))
            if kernel == "S2a":
                fns["kernel"].append(functools.partial(tln.layer_norm_forward, x, w, b, epilogue,
                                                       res))
                fns["plain"].append(functools.partial(tln.layer_norm_reference, x, w, b,
                                                      epilogue, res))
                fns["library"].append(functools.partial(s2_library, x, w, b, epilogue, res))
            else:
                bargs = (dout, x, w, b, epilogue, res)
                leaves = [t.detach().clone().requires_grad_() for t in (x, w, b, res)
                          if t is not None]
                lib_out = s2_library(leaves[0], leaves[1], leaves[2], epilogue,
                                     leaves[3] if len(leaves) == 4 else None)
                fns["kernel"].append(functools.partial(tln.layer_norm_backward, *bargs))
                fns["plain"].append(functools.partial(tln.layer_norm_backward_reference, *bargs))
                fns["library"].append(functools.partial(torch.autograd.grad, lib_out, leaves,
                                                        dout, retain_graph=True))
        ms, wall = {}, {}
        for name, group in fns.items():
            ms[name] = device_ms(rotation(group), S2_REPS)
            wall[name] = statistics.median(back_to_back_ms(rotation(group), S2_REPS))
        del cases, fns
        timed[key] = (ms, bound_ms, by, err)
        calls = ", ".join(f"{p} x{S2_SHAPES[p][key] / S2_PATHS[p][0]} {S2_PATHS[p][1]}"
                          for p in paths)
        print(f"[S2 rate] {kernel} {s2_kind(dtype)} C={c} {epilogue} rows={rows} ({calls}): "
              f"device ms a call ({S2_REPS} calls back to back behind a spin kernel, cycling "
              f"through {copies} input sets) kernel {ms['kernel']}, plain {ms['plain']}, library "
              f"{ms['library']} (F.layer_norm on a float32 copy, cast, ReLU, add"
              f"{', autograd backward' if kernel == 'S2b' else ''}); bound {bound_ms} ms ({by}), "
              f"the kernel at {bound_ms / ms['kernel']} of it; a call back to back ({S2_REPS}, "
              f"host included) kernel {wall['kernel']}, plain {wall['plain']}, library "
              f"{wall['library']} ms; max_abs_err {err} [{card}]")

    reports = []
    names = {"S2a": "layer_norm_forward", "S2b": "layer_norm_backward"}
    for path, counter in S2_SHAPES.items():
        units, unit = S2_PATHS[path]
        for kernel in ("S2a", "S2b"):
            keys = [k for k in counter if k[0] == kernel]
            if not keys:
                continue

            def total(value):  # value(key): ms a launch
                return sum(counter[k] * value(k) for k in keys) / units

            ms = {name: total(lambda k: timed[k][0][name])
                  for name in ("kernel", "plain", "library")}
            bound_ms = total(lambda k: timed[k][1])
            by = "bytes" if all(timed[k][2] == "bytes" for k in keys) else "operations"
            held = S2_ERRS.get(path, (0, 0.0, True))[1]
            print(f"[S2 rate] {path}: {kernel} {sum(counter[k] for k in keys) / units} launches "
                  f"{unit}, device ms {unit}: kernel {ms['kernel']}, bound {bound_ms} ({by}; "
                  f"the kernel at {bound_ms / ms['kernel']} of it), plain {ms['plain']}, library "
                  f"{ms['library']}; launches on the main path {launches[path][kernel]} [{card}]")
            reports.append({"name": f"{names[kernel]} ({path}, {unit})", "route": "cuda",
                            "source": S2_SOURCE, "replaces": S2_REPLACES,
                            "launches": launches[path][kernel],
                            "max_abs_err": max([held] + [timed[k][3] for k in keys]),
                            "ms": ms["kernel"], "plain_ms": ms["plain"],
                            "bound_ms": bound_ms, "bound_by": by, "library_ms": ms["library"]})
    return reports


def diff(pairs) -> tuple:
    """(largest |a - b| over tensor pairs, every bit equal): floats compared
    by value and by bit pattern (the sign of zero included)."""
    err, same = 0.0, True
    for a, b in pairs:
        require(a.shape == b.shape and a.dtype == b.dtype, "output shapes/dtypes")
        if a.dtype.is_floating_point:
            same &= torch.equal(a.view(torch.int32), b.view(torch.int32))
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        else:
            same &= torch.equal(a, b)
            err = max(err, float((a.long() - b.long()).abs().max()) if a.numel() else 0.0)
    return err, same


def note_s1(name: str, result: tuple) -> None:
    """Add a comparison (``diff``'s result) of a search kernel to ``S1_ERRS``."""
    calls, worst, same = S1_ERRS.get(name, (0, 0.0, True))
    S1_ERRS[name] = (calls + 1, max(worst, result[0]), same and result[1])


@contextlib.contextmanager
def held_to_plain(capture: dict | None = None):
    """For the block, ``models/mcts.py``'s three kernel wrappers and
    ``ops/bit_step.py::step_state`` (S1a as ``step_bits`` on the card) are
    replaced by calls that run the kernel and its plain version on copies
    of the same inputs, go on with the kernel's outputs, and add the
    comparison to ``S1_ERRS``.  With ``capture``, the inputs of each
    kernel's ``S1_TIMED_CALL``-th call in the block are kept there."""
    real = {"select_walk": mcts.select_walk, "bit_step": mcts.bit_step,
            "backup_walk": mcts.backup_walk, "step_state": tstep.step_state}
    seen = dict.fromkeys(real, 0)

    def note(name, result, inputs):
        note_s1(name, result)
        if capture is not None and name not in capture and seen[name] == S1_TIMED_CALL:
            capture[name] = inputs
        seen[name] += 1

    def clone(tree):
        return mcts.Tree(*(x.clone() for x in tree))

    def select(tree, action, kid, kid_term, c_puct, iters=None):
        # a None entry (all three) is the PUCT search's: from the root
        entry = tuple(None if x is None else x.clone() for x in (action, kid, kid_term))
        inputs = (clone(tree), *entry, c_puct)
        ref_iters = None if iters is None else iters.clone()
        want = twalk.select_walk_reference(tree, action, kid, kid_term, c_puct, ref_iters)
        got = real["select_walk"](tree, action, kid, kid_term, c_puct, iters)
        pairs = list(zip(got, want)) + ([(iters, ref_iters)] if iters is not None else [])
        note("select_walk", diff(pairs), inputs)
        return got

    def step(src, src_slot, action, dst, dst_slot, board_size, outcome=None, **kw):
        require(src is dst and outcome is not None,
                "the search expands in place, with the child's terminal flag and value")
        ref = tuple(x.clone() for x in dst)
        ref_outcome = tuple(x.clone() for x in outcome)
        inputs = (tuple(x.clone() for x in dst), src_slot.clone(), action.clone(), dst_slot,
                  board_size, tuple(x.clone() for x in outcome))
        want = tstep.bit_step_reference(ref, src_slot, action, ref, dst_slot, board_size,
                                        outcome=ref_outcome, **kw)
        got = real["bit_step"](src, src_slot, action, dst, dst_slot, board_size,
                               outcome=outcome, **kw)
        pairs = list(zip(dst, ref)) + list(zip(outcome, ref_outcome)) + [(got, want.contiguous())]
        note("bit_step", diff(pairs), inputs)
        return got

    def backup(tree, node, value, iters=None):
        inputs = (clone(tree), node.clone(), value.clone())
        ref = tree._replace(visit=tree.visit.clone(), value_sum=tree.value_sum.clone())
        ref_iters = None if iters is None else iters.clone()
        twalk.backup_walk_reference(ref, node, value, ref_iters)
        real["backup_walk"](tree, node, value, iters)
        pairs = [(tree.visit, ref.visit), (tree.value_sum, ref.value_sum)]
        pairs += [(iters, ref_iters)] if iters is not None else []
        note("backup_walk", diff(pairs), inputs)

    def step_state(bs, board_size, action):
        # step_bits' input is not written: both read the same tensors
        want = tbit.step_bits_reference(bs, board_size, action)
        got = real["step_state"](bs, board_size, action)
        pairs = zip(tbit.bitstate_leaves(got), tbit.bitstate_leaves(want))
        note("step_state", diff(pairs), (bs, board_size, action))
        return got

    mcts.select_walk, mcts.bit_step, mcts.backup_walk = select, step, backup
    tstep.step_state = step_state
    try:
        yield
    finally:
        mcts.select_walk, mcts.bit_step, mcts.backup_walk = (
            real["select_walk"], real["bit_step"], real["backup_walk"])
        tstep.step_state = real["step_state"]


def report_s1_equal(what: str) -> None:
    print(f"[S1 equal] {what}: " + "; ".join(
        f"{name} {calls} calls, max_abs_err {err}, bit-equal {same}"
        for name, (calls, err, same) in sorted(S1_ERRS.items())))
    require(all(same and err == 0 for _, err, same in S1_ERRS.values()),
            f"a search kernel equals its plain version ({what})")


def s1_roots(n: int, b: int, dev):
    """Roots part-way into random games (the plain rollout: no kernel)."""
    return tbit.bit_random_rollout(3, n, 24 if n <= 12 else 60, tbit.bit_reset(n, b, dev))[0]


def select_bound(tree, a0, k0, kt0, c_puct) -> tuple:
    """S1b's least time on one call's inputs (``s1_bounds``): (ms, by)."""
    b, nodes = tree.visit.shape
    a_dim = tree.uprior.shape[-1]
    leaf, _, _ = twalk.select_walk_reference(tree, a0, k0, kt0, c_puct)
    # the walk scores the path's nodes (amask tree), the root too when it
    # starts there (a None entry); a level reads the node's visit and prior
    # row and the chosen child's action and flag, and each child of the node
    # its visit, terminal, value and edge prior; an env that scores a level
    # reads its link row and its linked slots' parents once
    env = torch.arange(b, device=leaf.device)
    path = tree.amask[env, leaf].clone()
    if a0 is not None:
        path[:, 0] = False
    kids = torch.zeros((b, nodes + 1), dtype=torch.int64, device=leaf.device).scatter_add_(
        1, torch.where(tree.linked, tree.parent, nodes).clamp_min(0),
        torch.ones((b, nodes), dtype=torch.int64, device=leaf.device))[:, :nodes]
    env_descents = path.sum(1)
    descents = int(env_descents.sum())
    links = int(((env_descents > 0) * (nodes + 8 * tree.linked.sum(1))).sum())
    children = int((kids * path).sum())
    nbytes = ((0 if a0 is None else 17 * b) + 24 * b + descents * (4 + 4 * a_dim + 9) + links
              + 13 * children)
    flops = descents * 3 * a_dim + 8 * children
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def s1_bounds(captured: dict, card: str) -> dict:
    """The least time of each kernel on its captured inputs: the bytes the
    function moves (each input read once, each output written once, what
    this call's walks need) over 3.35 TB/s, against its float operations
    over the float32 peak.  Returns name -> (bound_ms, bound_by)."""
    out = {}
    src, slot, action, dst_slot, n, _ = captured["bit_step"]
    b = action.shape[0]
    # a source slot in, the stepped slot out, the slot, action, mask and
    # the child's terminal flag and value
    nbytes = 2 * bit_state_bytes(n, b) + 16 * b + b * n * n + 5 * b
    out["bit_step"] = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")

    out["select_walk"] = select_bound(*captured["select_walk"])

    tree, node, value = captured["backup_walk"]
    steps, live = 0, node.clone()
    while bool((live >= 0).any()):  # each env's path length, on the host
        steps += int((live >= 0).sum())
        live = torch.where(live >= 0, tree.parent.gather(1, live.clamp_min(0)[:, None])[:, 0], -1)
    # a node: visit and value read and written, its parent read; the leaf and value
    nbytes = steps * (8 + 8 + 8) + 12 * node.shape[0]
    out["backup_walk"] = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")
    return out


def padded(tree, nodes: int, envs: int):
    """The first ``envs`` trees of ``tree`` with unlinked slots appended up
    to ``nodes`` (the walks' fields only)."""
    fill = {"visit": 0, "value_sum": 0.0, "uprior": -1.0, "parent": -1, "pa": 0,
            "e_prior": 0.0, "terminal": False, "tval": 0.0, "linked": False}
    out = {}
    for name, value in fill.items():
        x = getattr(tree, name)[:envs]
        pad = torch.full((envs, nodes - x.shape[1], *x.shape[2:]), value, dtype=x.dtype,
                         device=x.device)
        out[name] = torch.cat([x, pad], 1)
    return tree._replace(**out)


def wide_tree_path(captured: dict) -> None:
    """S1b and S1c where one env's rows need more than 48 KB of shared
    memory, so that the kernels opt in above it: the captured calls' trees
    padded with unlinked slots (``S1_WIDE_SLOTS``; S1b from the root and
    from the root's best edge as a forced entry), kernel against plain
    version, bit for bit; then one env at the most slots that fit
    (``S1_EDGE_SLOTS``), and one slot more, which each wrapper refuses."""
    tree, _, _, _, c_puct = captured["select_walk"]
    btree, node, value = captured["backup_walk"]
    for envs, slots in ((S1_WIDE_ENVS, S1_WIDE_SLOTS), (1, S1_EDGE_SLOTS)):
        wide = padded(tree, slots["select_walk"], envs)
        for entry in ((None, None, None), twalk.root_entry(wide, c_puct)):
            iters, ref_iters = (torch.zeros((), dtype=torch.int32, device=tree.visit.device)
                                for _ in range(2))
            got = twalk.select_walk(wide, *entry, c_puct, iters)
            want = twalk.select_walk_reference(wide, *entry, c_puct, ref_iters)
            note_s1("select_walk", diff([*zip(got, want), (iters, ref_iters)]))
        del wide

        wide = padded(btree, slots["backup_walk"], envs)
        ref = wide._replace(visit=wide.visit.clone(), value_sum=wide.value_sum.clone())
        iters, ref_iters = (torch.zeros((), dtype=torch.int32, device=node.device)
                            for _ in range(2))
        twalk.backup_walk(wide, node[:envs], value[:envs], iters)
        twalk.backup_walk_reference(ref, node[:envs], value[:envs], ref_iters)
        note_s1("backup_walk", diff([(wide.visit, ref.visit), (wide.value_sum, ref.value_sum),
                                     (iters, ref_iters)]))
        del wide, ref
    report_s1_equal(f"one env above 48 KB of shared memory ({S1_WIDE_ENVS} envs: select_walk "
                    f"at {S1_WIDE_SLOTS['select_walk']} slots, backup_walk at "
                    f"{S1_WIDE_SLOTS['backup_walk']}) and one env at the most that fit "
                    f"(select_walk {S1_EDGE_SLOTS['select_walk']}, backup_walk "
                    f"{S1_EDGE_SLOTS['backup_walk']})")

    launches = (twalk.select_walk.launches, twalk.backup_walk.launches)
    refused = []
    for name, fn in (("select_walk", lambda t: twalk.select_walk(t, None, None, None, c_puct)),
                     ("backup_walk", lambda t: twalk.backup_walk(t, node[:1], value[:1]))):
        over = padded(tree if name == "select_walk" else btree, S1_EDGE_SLOTS[name] + 1, 1)
        try:
            fn(over)
        except ValueError as err:
            refused.append(str(err))
        del over
    torch.cuda.synchronize()
    print(f"[S1 edge] one slot past the most that fit: {refused}")
    require(len(refused) == 2 and all("shared memory" in e for e in refused)
            and launches == (twalk.select_walk.launches, twalk.backup_walk.launches),
            "each walk refuses one env past a block's shared memory, launching nothing")


def s1a_edges_path(dev) -> None:
    """S1a at the edges of its launch, kernel against plain version, bit for
    bit: boards 5 and 24 at ``S1A_EDGE_BATCH`` envs (the last block part
    filled; at board 5 the one-slot compid tensor has an odd count), from
    per-env slots in place, into a fresh slot and over slot 0, which some
    envs read, with the terminal flags and values; and from one slot
    (``src=None``) into fresh buffers, compid aligned and starting 2 bytes
    past a 4-byte boundary (its first and last halves have no word of the
    tensor around them)."""
    b = S1A_EDGE_BATCH
    env = torch.arange(b, device=dev)
    for n in (5, 24):
        # three source slots of states 2, n and 3n plies in, and an empty one
        states = [tbit.bit_random_rollout(seed, n, plies, tbit.bit_reset(n, b, dev))[0]
                  for seed, plies in ((1, 2), (2, n), (3, 3 * n))]
        bufs = tuple(torch.cat([*x, torch.zeros_like(x[0])])
                     for x in zip(*(tstep.one_slot(st) for st in states)))
        slot = torch.randint(0, 3, (b,), generator=torch.Generator(device=dev).manual_seed(n),
                             device=dev)
        action = tbit.sample_bits(tstep.gather_slots(bufs, slot), n, tbit.rollout_noise(n, 0, env))
        for dst_slot in (3, 0):
            got, ref = (tuple(x.clone() for x in bufs) for _ in range(2))
            out, ref_out = ((torch.zeros((b, 4), dtype=torch.bool, device=dev),
                             torch.full((b, 4), 7.0, device=dev)) for _ in range(2))
            legal = tstep.bit_step(got, slot, action, got, dst_slot, n, outcome=out)
            want = tstep.bit_step_reference(ref, slot, action, ref, dst_slot, n, outcome=ref_out)
            note_s1("bit_step", diff(list(zip(got, ref)) + list(zip(out, ref_out))
                                     + [(legal, want.contiguous())]))
        one = tstep.one_slot(states[1])
        # compid also as a view that starts 2 bytes past a 4-byte boundary
        compid = one[1]
        shifted = torch.empty(compid.numel() + 1, dtype=compid.dtype, device=dev)[1:]
        shifted = shifted.view(compid.shape).copy_(compid)
        action = tbit.sample_bits(states[1], n, tbit.rollout_noise(n, 1, env))
        for src in (one, (one[0], shifted, one[2])):
            fresh, ref = (tuple(torch.empty_like(x) for x in one) for _ in range(2))
            legal = tstep.bit_step(src, None, action, fresh, 0, n)
            want = tstep.bit_step_reference(src, None, action, ref, 0, n)
            note_s1("bit_step", diff(list(zip(fresh, ref)) + [(legal, want.contiguous())]))
    torch.cuda.synchronize()
    report_s1_equal(f"S1a at boards 5 and 24, batch {b}: per-env slots in place (into a fresh "
                    "slot, and over slot 0, which envs read) and one slot into fresh buffers "
                    "(compid aligned, and 2 bytes past a 4-byte boundary)")


def search_kernels_path(dev, card: str) -> list:
    """Phase 13 (first part): S1a-S1c against their plain versions on every
    call of full-width searches; the main path (config-5 searches under
    both backups) with the launch counts; each kernel's time, plain time
    and bound on one simulation's inputs.  Returns the kernels' reports."""
    captured = {}
    for row, (n, b, sims, backup, search) in enumerate(S1_CHECK_ROWS):
        net = create_net(n, device=dev)
        roots = s1_roots(n, b, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        kw = dict(evaluator=mcts.net_evaluator(call_net, n), board_size=n,
                  num_simulations=sims, backup=backup)
        t0 = time.perf_counter()
        # the first (config 5's search) holds S2's calls to their plain version too
        held = held_s2("search 128x6") if row == 0 else contextlib.nullcontext()
        with held_to_plain(captured if (n, search) == (12, "puct") else None), held:
            if search == "puct":
                probs, _, stats = mcts.search_batch(net, roots, gen, dirichlet_frac=0.25,
                                                    return_stats=True, **kw)
                require(bool(((probs * sims).round().sum(-1) == sims).all()), "root visits")
            else:
                action, improved, root_q = mcts.gumbel_search_batch(net, roots, gen, **kw)
                legal = tbit.bit_legal_mask_flat(roots, roots.current_player.clamp(0, 1), n).T
                require(bool(legal[torch.arange(b, device=dev), action].all())
                        and bool(torch.isfinite(improved).all())
                        and bool(torch.isfinite(root_q).all()), "the Gumbel search's outputs")
                stats = "forced root edges"
        report_s1_equal(f"{search} search n={n} batch={b} sims={sims} backup={backup}, walks "
                        f"{stats}, {time.perf_counter() - t0} s")
    report_s2_equal("search 128x6")

    # the main path: config-5 searches, each kernel's launches counted
    n, b, sims, *_ = S1_CHECK_ROWS[0]
    net = create_net(n, device=dev)
    roots = s1_roots(n, b, dev)
    zero_counts()
    for backup in ("amask", "walk"):
        mcts.search_batch(net, roots, torch.Generator(device=dev).manual_seed(0),
                          evaluator=mcts.net_evaluator(call_net, n), board_size=n,
                          num_simulations=sims, dirichlet_frac=0.25, backup=backup)
    torch.cuda.synchronize()
    counts = launched_only(f"the config-5 searches (n={n} batch={b} sims={sims}, amask and walk)",
                           required=SEARCH_KERNELS)
    wide_tree_path(captured)

    s1a_edges_path(dev)
    bounds = s1_bounds(captured, card)
    src, slot, action, dst_slot, bn, outcome = captured["bit_step"]
    tree, a0, k0, kt0, c_puct = captured["select_walk"]
    btree, node, value = captured["backup_walk"]
    ref_bufs = tuple(x.clone() for x in src)
    ref_outcome = tuple(x.clone() for x in outcome)
    ref_tree = mcts.Tree(*(x.clone() for x in btree))
    runs = {
        "bit_step": (lambda: tstep.bit_step(src, slot, action, src, dst_slot, bn,
                                            outcome=outcome),
                     lambda: tstep.bit_step_reference(ref_bufs, slot, action, ref_bufs, dst_slot,
                                                      bn, outcome=ref_outcome)),
        "select_walk": (lambda: twalk.select_walk(tree, a0, k0, kt0, c_puct),
                        lambda: twalk.select_walk_reference(tree, a0, k0, kt0, c_puct)),
        "backup_walk": (lambda: twalk.backup_walk(btree, node, value),
                        lambda: twalk.backup_walk_reference(ref_tree, node, value)),
    }
    letter = {"bit_step": "S1a", "select_walk": "S1b", "backup_walk": "S1c"}
    # S1b below a given root entry too (Gumbel's form): the root's best edge
    # as a forced entry, held to plain on this tree
    entry = twalk.root_entry(tree, c_puct)
    runs["select_walk below the root"] = (
        lambda: twalk.select_walk(tree, *entry, c_puct),
        lambda: twalk.select_walk_reference(tree, *entry, c_puct))
    bounds["select_walk below the root"] = select_bound(tree, *entry, c_puct)
    note_s1("select_walk", diff(list(zip(runs["select_walk below the root"][0](),
                                         runs["select_walk below the root"][1]()))))
    report_s1_equal(f"select_walk below the root's best edge on simulation {S1_TIMED_CALL}'s "
                    "tree")
    # the deepest walk of the timed calls: descents below the root entry, and
    # the longest backup path
    sel_iters = torch.zeros((), dtype=torch.int32, device=dev)
    twalk.select_walk_reference(tree, a0, k0, kt0, c_puct, sel_iters)
    bk_iters = torch.zeros((), dtype=torch.int32, device=dev)
    twalk.backup_walk_reference(mcts.Tree(*(x.clone() for x in btree)), node, value, bk_iters)
    walks = {"select_walk": f"deepest walk {int(sel_iters) - 1} descents below the root "
                            f"entry ({'from the root' if a0 is None else 'a forced entry'})",
             "select_walk below the root": f"deepest walk {int(sel_iters) - 1} descents "
                                           "below the given entry",
             "backup_walk": f"longest walk {int(bk_iters)} nodes"}
    # S1a from one slot into fresh buffers (step_state's form, bit_replay's
    # shape), held to plain once
    on, ob = S1A_ONE_SLOT
    o_src = tstep.one_slot(s1_roots(on, ob, dev))
    o_action = tbit.sample_bits(tstep.slot_as(o_src, (ob,)), on,
                                tbit.rollout_noise(on, 0, torch.arange(ob, device=dev)))
    o_dst, o_ref = (tuple(torch.empty_like(x) for x in o_src) for _ in range(2))
    runs["bit_step one slot"] = (
        lambda: tstep.bit_step(o_src, None, o_action, o_dst, 0, on, legal=False),
        lambda: tstep.bit_step_reference(o_src, None, o_action, o_ref, 0, on, legal=False))
    runs["bit_step one slot"][0]()
    runs["bit_step one slot"][1]()
    note_s1("bit_step", diff(list(zip(o_dst, o_ref))))
    report_s1_equal(f"S1a from one slot at n={on} batch={ob}")
    # one source slot in, the stepped slot out, the actions
    bounds["bit_step one slot"] = (
        (2 * bit_state_bytes(on, ob) + 8 * ob) / HBM_BYTES_PER_S * 1e3, "bytes")
    where = {"bit_step one slot": f"from one slot into fresh buffers (step_state's form) at "
                                  f"n={on} batch={ob}"}
    # the launch floor: an empty kernel of each launch shape (the walks' 4
    # envs a block at these slots; S1a's), enqueued by a bare ctypes call
    empty = _cuda.load("search").twixt_search_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    envs = _cuda.envs_per_block("bit_step", dev)
    threads = envs * 32
    stream = torch.cuda.current_stream(dev).cuda_stream
    for what, shape in (("S1b, S1c", (-(-b // 4), 128)), ("S1a", (-(-b // envs), threads)),
                        ("S1a one slot", (-(-ob // envs), threads))):
        def floor():
            return empty(*shape, stream)

        floor()
        floor_ms = statistics.median(back_to_back_ms(floor, S1_REPS))
        floor_dev = device_ms(floor, S1_REPS)
        print(f"[S1 floor] {what}: empty kernel <<<{shape[0]}, {shape[1]}>>>: {floor_ms} ms a "
              f"launch ({S1_REPS} back to back), device {floor_dev} ms a launch (behind a spin "
              f"kernel) [{card}]")
    reports = []
    for name, (kernel, plain) in runs.items():
        kernel()  # warm-up
        ms = statistics.median(back_to_back_ms(kernel, S1_REPS))
        dev_ms = device_ms(kernel, S1_REPS)
        plain()
        plain_ms = statistics.median(timed_ms(plain, S1_PLAIN_REPS))
        bound_ms, by = bounds[name]
        short = name.split()[0]
        at = where.get(name, f"on simulation {S1_TIMED_CALL}'s inputs of the config-5 search "
                             f"(n={n} batch={b})")
        print(f"[S1 rate] {letter[short]} {name} {at}: kernel {ms} ms a launch ({S1_REPS} back "
              f"to back), device {dev_ms} ms a launch (behind a spin kernel), plain {plain_ms} "
              f"ms; bound {bound_ms} ms ({by}); launches on the main path {counts[letter[short]]}"
              f"{'; ' + walks[name] if name in walks else ''} [{card}]")
        if name != short:
            continue  # a second form of one kernel: the kernels line has one entry a kernel
        calls, err, _ = S1_ERRS[name]
        reports.append({"name": name, "route": "cuda", "source": CSRC + S1_SOURCES[name],
                        "replaces": S1_REPLACES[name], "launches": counts[letter[name]],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    return reports


def simulation_reads(dev, card: str, net, roots, evaluator, n: int) -> None:
    """Phase 14's host reads: one search with CUDA's sync debug mode set to
    "error" inside every simulation (any host read there raises), and one
    under torch.profiler: host reads (``aten::_local_scalar_dense``) and
    device activities a simulation."""
    real = mcts._make_simulate

    def strict(**kw):
        simulate = real(**kw)

        def run(sim, tree):
            torch.cuda.set_sync_debug_mode("error")
            try:
                simulate(sim, tree)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    def search():
        out = mcts.search_batch(net, roots, torch.Generator(device=dev).manual_seed(1),
                                evaluator=evaluator, board_size=n,
                                num_simulations=SEARCH_SIMS, dirichlet_frac=0.25)
        torch.cuda.synchronize()
        return out

    mcts._make_simulate = strict
    try:
        search()
    finally:
        mcts._make_simulate = real
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        search()
    events = prof.events()
    reads = sum(e.name == "aten::_local_scalar_dense" for e in events)
    device = sum(e.device_type.name == "CUDA" for e in events)
    print(f"[search reads] search_batch n={n} batch={roots.red.shape[1]} sims={SEARCH_SIMS}: no "
          f"host read inside any simulation (sync debug mode 'error' around each); under the "
          f"profiler {reads} host reads in the search = {reads / SEARCH_SIMS} a simulation (the "
          f"Dirichlet draw's rounds), {device} device activities = {device / SEARCH_SIMS} a "
          f"simulation [{card}]")


def search_path(dev, card: str, net_ms: float) -> dict:
    """Phases 13-14: search_batch against the JAX fixture (both backups;
    every kernel call held to its plain version), one_rollout against
    JAX's values (its steps held too); the full-width search's time, host
    reads, launches and invariants.  Returns the full-width searches'
    launch counts."""
    row = torch.full((2, 7), -torch.inf, device=dev)
    row[1, 3:] = 2.0
    require(row.argmax(-1).tolist() == [0, 3], "argmax takes the first maximum on the card")
    rec = json.loads(SEARCH_FIXTURE.read_text())
    with held_to_plain():
        for case in rec["search"]:
            n, sims, kind = case["board_size"], case["num_simulations"], case["evaluator"]
            roots = cases.scenario_roots(case["scenarios"], n, dev)
            for backup in ("amask", "walk"):
                probs, root_q, stats = mcts.search_batch(
                    None, roots, torch.Generator(device=dev).manual_seed(0),
                    evaluator=cases.EVALUATORS[kind](n * n), board_size=n,
                    num_simulations=sims, dirichlet_frac=0.0, backup=backup,
                    return_stats=True)
                visits = (probs * sims).round().long().cpu()
                q_err = float((root_q.cpu() - torch.tensor(case["root_q"])).abs().max())
                same = torch.equal(visits, torch.tensor(case["visits"]))
                print(f"[search equal] n={n} sims={sims} {kind} {backup}: visits "
                      f"{'equal' if same else 'DIFFER'} (envs {len(case['scenarios'])}), "
                      f"|root_q - JAX| {q_err}, walks {stats}")
                require(same, f"root visits vs JAX at n={n} sims={sims} {kind} {backup}")
                require(q_err <= 1e-5, "root_q vs JAX")
                want_bk = case["backup_iters"] if backup == "walk" else 0
                require(stats == {"sel_iters": case["sel_iters"], "backup_iters": want_bk},
                        "walk iterations vs JAX")
        for case in rec["rollout"]:
            n = case["board_size"]
            got = mcts.one_rollout(cases.scenario_roots(case["scenarios"], n, dev), n,
                                   case["seed"])
            print(f"[search equal] one_rollout n={n} seed={case['seed']}: {got.tolist()}")
            require(got.cpu().tolist() == case["values"], "one_rollout vs JAX")
    report_s1_equal("the search fixture's cases, both backups; one_rollout's steps")

    n, b = NET_ROW
    net = create_net(n, device=dev)
    roots = tbit.bit_random_rollout(3, n, 24, tbit.bit_reset(n, b, dev))[0]
    net_events = []

    def timed_net(params, obs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call_net(params, obs)
        stop.record()
        net_events.append((start, stop))
        return out

    evaluator = mcts.net_evaluator(timed_net, n)
    gen = torch.Generator(device=dev).manual_seed(0)

    def search():
        return mcts.search_batch(net, roots, gen, evaluator=evaluator, board_size=n,
                                 num_simulations=SEARCH_SIMS, dirichlet_frac=0.25,
                                 return_stats=True)

    search()  # warm-up
    zero_counts()  # the main path: count only its launches
    torch.cuda.reset_peak_memory_stats()
    runs, shares = [], []
    for _ in range(SEARCH_REPS):
        net_events.clear()
        t0 = time.perf_counter()
        probs, root_q, stats = search()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        shares.append(sum(a.elapsed_time(z) for a, z in net_events) / runs[-1])
        require(len(net_events) == SEARCH_SIMS + 1, "one net call a simulation and the root")
    counts = launched_only("the search path", required=("S1a", "S1b", "S2a"))
    kernels = sum(counts[k] for k in SEARCH_KERNELS) / (SEARCH_REPS * SEARCH_SIMS)
    legal = tbit.bit_legal_mask_flat(roots, roots.current_player.clamp(0, 1), n).T
    visits = (probs * SEARCH_SIMS).round()
    require(bool((visits.sum(-1) == SEARCH_SIMS).all()), "root visits sum to the simulations")
    require(bool((probs[~legal] == 0).all()), "visit_probs zero off the legal set")
    require(bool(torch.isfinite(root_q).all()) and bool((root_q.abs() <= 1).all()), "|root_q| <= 1")
    med = statistics.median(runs)
    print(f"[search rate] search_batch n={n} batch={b} sims={SEARCH_SIMS} bf16 net, "
          f"dirichlet_frac=0.25, backup auto (amask): median {med} ms of {runs} "
          f"-> {med / SEARCH_SIMS} ms a simulation, {b * SEARCH_SIMS / med * 1e3} "
          f"simulations/s; net calls {statistics.median(shares)} of the time "
          f"(CUDA events around each call; {SEARCH_SIMS + 1} x the [net rate] median = "
          f"{(SEARCH_SIMS + 1) * net_ms / med}); walks {stats}; search kernels {kernels} a "
          f"simulation (S1a, S1b, S1c); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20} MiB; invariants hold [{card}]")
    simulation_reads(dev, card, net, roots, mcts.net_evaluator(call_net, n), n)
    return counts


def arena_path(dev, card: str) -> None:
    """Phase 15: the deterministic table-net arena against the JAX fixture,
    then the full-width net against the random bot."""
    zero_counts()
    rec = json.loads(ARENA_FIXTURE.read_text())
    n = rec["board_size"]
    got = arena.arena_match(
        cases.arena_table_params(n * n, 0, dev), cases.arena_table_params(n * n, 1, dev),
        torch.Generator(device=dev).manual_seed(0), net_apply=cases.arena_table_net,
        board_size=n, batch=rec["batch"], num_simulations=rec["num_simulations"],
        temp_moves=0, device=dev)
    tally = {k: float(got[k]) for k in rec["tally"]}
    digest = tbit.state_digest(got["final_state"])
    print(f"[arena] table nets n={n} batch={rec['batch']} sims={rec['num_simulations']} "
          f"temp_moves=0: {tally}, final digest {digest[:16]}")
    require(tally == rec["tally"], "arena tally vs JAX")
    require(digest == rec["digest"], "arena final boards vs JAX")

    n, b, sims = ARENA_ROW
    net = create_net(n, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = arena.arena_match(net, net, torch.Generator(device=dev).manual_seed(0),
                            board_size=n, batch=b, num_simulations=sims, random_b=True,
                            device=dev)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    final = got["final_state"]
    require(bool((final.result != geo.RESULT_OPEN).all()), "every arena game ended")
    require(got["a_wins"] + got["b_wins"] + got["draws"] == b, "the tally covers every game")
    env_moves = int(final.move_counter.sum())
    print(f"[arena] untrained net (128 channels, 6 blocks, bf16) vs random_b n={n} batch={b} "
          f"sims={sims}: {dict((k, got[k]) for k in ('a_wins', 'b_wins', 'draws', 'a_score'))}, "
          f"{got['moves']} lockstep plies, {env_moves} moves played in {s} s -> "
          f"{got['moves'] / s} plies/s, {env_moves / s} moves/s [{card}]")
    launched_only("the arena path", required=("S1a", "S1b"))


def selfplay_equal_path(dev) -> None:
    """Phase 16: the deterministic chunk on the card against the JAX record."""
    zero_counts()
    rec = json.loads(SELFPLAY_FIXTURE.read_text())
    for vb, want in rec["chunks"].items():
        with held_to_plain():
            final, sample, aux = cases.deterministic_chunk(dev, float(vb), debug_trace=True)
        got = cases.sample_record(final, sample, aux)
        same = {k: got[k] == want[k] for k in ("obs_sha256", "obs_shape", "policy", "value",
                                              "weight", "final_digest")}
        same["aux"] = {k: got["aux"][k] for k in want["aux"]} == want["aux"]
        print(f"[selfplay equal] n={rec['board_size']} batch={rec['batch']} "
              f"steps={rec['num_steps']} sims={rec['num_simulations']} table net, greedy, "
              f"no root noise, value_bootstrap={vb}: {same}; frames with weight 1 "
              f"{int((sample.weight == 1).sum())} of {sample.weight.numel()}")
        require(all(same.values()), f"the deterministic chunk vs JAX at value_bootstrap={vb}")
    report_s1_equal("the deterministic chunks' searches and steps")
    launched_only("the self-play chunk", required=("S1a", "S1b"))


def leaf_err(got: dict, want: dict) -> float:
    """Largest |got - want| over each leaf's largest |want|."""
    return max(float((got[k].float().cpu() - want[k].float().cpu()).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def param_close(got: dict, want: dict) -> bool:
    """Every parameter within rtol 2e-4 and atol 1e-5 (``TRAIN_TOL``)."""
    return all(torch.allclose(got[k].float().cpu(), want[k].float().cpu(),
                              rtol=TRAIN_TOL["param_rtol"], atol=TRAIN_TOL["param_atol"])
               for k in want)


def train_equal_path(dev) -> None:
    """Phase 17: the float32 loss, gradients and train steps on the card
    against the CPU and the JAX record; microbatch 4 against monolithic."""
    zero_counts()
    rec = json.loads(TRAIN_FIXTURE.read_text())
    n, ch, blocks = rec["board_size"], rec["channels"], rec["blocks"]
    tree = convert.params_to_flax(cases.random_state_dict(n, ch, blocks, rec["param_seed"]))
    card_sample = cases.deterministic_chunk(dev, rec["value_bootstrap"])[1]
    samples = {"card": card_sample,
               "cpu": selfplay.Sample(*(x.cpu() for x in card_sample))}

    def net_on(where):
        net = create_net(n, ch, blocks, dtype=torch.float32,
                         device=dev if where == "card" else "cpu")
        return convert.load_flax_params(net, tree)

    with no_tf32():
        grads, metrics = {}, {}
        for where in ("card", "cpu"):
            net = net_on(where)
            loss, metrics[where] = selfplay.loss_fn(net, call_net, samples[where])
            loss.backward()
            grads[where] = {k: p.grad for k, p in net.named_parameters()}
        m_err = max(abs(float(metrics["card"][k]) / float(metrics["cpu"][k]) - 1)
                    for k in rec["metrics"])
        m_jax = max(abs(float(metrics["card"][k]) / rec["metrics"][k] - 1) for k in rec["metrics"])
        g_err = leaf_err(grads["card"], grads["cpu"])
        g_jax = cases.summary_err(cases.summarize(grads["card"]), rec["grads"])
        print(f"[train equal] n={n} {ch} channels {blocks} block f32 (TF32 off), "
              f"value_bootstrap={rec['value_bootstrap']}: loss metrics card/CPU - 1 {m_err}, "
              f"card/JAX - 1 {m_jax} (tolerance {TRAIN_TOL['metrics_rtol']}); gradients card "
              f"vs CPU {g_err} of each leaf's max (tolerance {TRAIN_TOL['grad']}), vs the JAX "
              f"summaries {g_jax} of each leaf's norm (tolerance {TRAIN_TOL['summary']})")
        require(max(m_err, m_jax) <= TRAIN_TOL["metrics_rtol"], "the loss metrics")
        require(g_err <= TRAIN_TOL["grad"] and g_jax <= TRAIN_TOL["summary"], "the gradients")

        for clip, clip_norm in rec["clips"].items():
            nets = {w: net_on(w) for w in ("card", "cpu")}
            opts = {w: selfplay.make_optimizer(nets[w].parameters(), rec["lr"],
                                               clip_norm=clip_norm) for w in nets}
            for k, want in enumerate(rec["steps"][clip]):
                for w in nets:
                    selfplay.train_step(nets[w], opts[w], samples[w])
                card, cpu = nets["card"].state_dict(), nets["cpu"].state_dict()
                close = param_close(card, cpu)
                s_err = cases.summary_err(cases.summarize(card), want["params"])
                print(f"[train equal] clip {clip} ({clip_norm}) step {k + 1}: parameters card "
                      f"vs CPU {'within' if close else 'OUTSIDE'} rtol "
                      f"{TRAIN_TOL['param_rtol']} atol {TRAIN_TOL['param_atol']} (max |diff| "
                      f"{max(float((card[q].cpu() - cpu[q]).abs().max()) for q in cpu)}), vs "
                      f"the JAX summaries {s_err}")
                require(close and s_err <= TRAIN_TOL["summary"], f"train step {k + 1} ({clip})")

        nets = {mb: net_on("card") for mb in (1, 4)}
        for mb, net in nets.items():
            selfplay.train_step(net, selfplay.make_optimizer(net.parameters(), rec["lr"]),
                                card_sample, microbatch=mb)
        close = param_close(nets[4].state_dict(), nets[1].state_dict())
        print(f"[train equal] microbatch 4 vs monolithic on the card: parameters "
              f"{'within' if close else 'OUTSIDE'} rtol {TRAIN_TOL['param_rtol']} atol "
              f"{TRAIN_TOL['param_atol']}")
        require(close, "the microbatched step vs the monolithic step")
    launched_only("the train step's chunk", required=("S1a", "S1b", "S2a", "S2b"))


def selfplay_rate_path(dev, card: str) -> dict:
    """Phase 18: one config-5 chunk and train steps on it, at full width;
    then one more step with every S2 call held to its plain version.
    Returns the chunk's and the timed steps' launch counts."""
    zero_counts()
    n, b, steps, sims, ch, blocks = SELFPLAY_ROW
    net = create_net(n, ch, blocks, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(board_size=n, num_simulations=sims, temp_moves=SELFPLAY_TEMP_MOVES,
              dirichlet_alpha=0.3, dirichlet_frac=0.25)
    with held_s2("self-play 64x4", hold=False):  # the warm-up ply: one search's S2 shapes
        selfplay.selfplay_chunk(net, tbit.bit_reset(n, b, dev), gen, num_steps=1, **kw)

    search_events = []
    real_search = mcts.search_batch

    def timed_search(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_search(*args, **kwargs)
        stop.record()
        search_events.append((start, stop))
        return out

    roots = tbit.bit_reset(n, b, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mcts.search_batch = timed_search
    before_chunk = launch_counts()
    try:
        t0 = time.perf_counter()
        final, sample, aux = selfplay.selfplay_chunk(net, roots, gen, num_steps=steps,
                                                     debug_trace=True, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        mcts.search_batch = real_search
    chunk_counts = {k: v - before_chunk[k] for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    search_s = sum(a.elapsed_time(z) for a, z in search_events) / 1e3
    require(len(search_events) == steps, "one search a ply")

    # invariants, against the states replayed from the chunk's actions, each
    # step (S1a) held to the plain step on the same inputs
    states, bs = [], roots
    held = S1_ERRS.get("step_state", (0,))[0]
    with held_to_plain():
        for a in aux["actions"]:
            states.append(bs)
            bs = tbit.bit_step_auto_reset(bs, a, n)[0]
    require(S1_ERRS["step_state"][0] - held == steps, "every replayed step held to its plain version")
    report_s1_equal(f"the config-5 chunk's {steps} steps replayed (n={n} batch={b})")
    require(tbit.state_digest(bs) == tbit.state_digest(final), "the replay ends at the final state")
    pk = sample.obs.reshape(steps, b, 12, n + 2 * geo.PAD)
    wire_legal = tobs.unpack_legal_words_flat(tobs.legal_words_from_obs(pk), n)
    for k, s in enumerate(states):
        legal = tbit.bit_legal_mask_flat(s, s.current_player.clamp(0, 1), n).T
        require(torch.equal(wire_legal[k], legal), f"the wire's legal plane at step {k}")
        require(bool((sample.policy[k][~legal] == 0).all()), f"no policy mass off the legal set ({k})")
    row_err = float((sample.policy.sum(-1) - 1).abs().max())
    require(row_err <= 1e-5, "every policy row sums to 1")
    require(bool(((sample.weight == 0) | (sample.weight == 1)).all()), "weights in {0, 1}")
    require(bool((sample.value.abs() <= 1).all()), "|value| <= 1")
    finished = int((sample.weight == 1).sum())
    print(f"[selfplay rate] config 5: n={n} batch={b} chunk={steps} sims={sims} net {ch}x{blocks} "
          f"bf16, temp_moves={SELFPLAY_TEMP_MOVES}, Dirichlet 0.3/0.25: {secs} s -> "
          f"{b * steps / secs} moves/s, {secs / steps} s a ply; search_batch {search_s / secs} "
          f"of the time (CUDA events); frames with weight 1 {finished} of {sample.weight.numel()};"
          f" peak memory {peak} MiB; invariants hold (policy rows sum to 1 within {row_err}) "
          f"[{card}]")

    opt = selfplay.make_optimizer(net.parameters(), TRAIN_LR)
    before = [p.detach().clone() for p in net.parameters()]
    selfplay.train_step(net, opt, sample)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    before_steps = launch_counts()
    ms = timed_ms(lambda: losses.append(selfplay.train_step(net, opt, sample)["loss"]), TRAIN_REPS)
    step_counts = {k: v - before_steps[k] for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    med = statistics.median(ms)
    frames = steps * b
    flops = 3 * net_flops(net, frames)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    loss = float(losses[-1])
    moved = any(not torch.equal(a, p) for a, p in zip(before, net.parameters()))
    print(f"[train rate] train_step on the chunk's {frames} frames, net {ch}x{blocks} bf16, "
          f"AdamW lr {TRAIN_LR}: median {med} ms of {TRAIN_REPS} ({min(ms)}-{max(ms)}) after a "
          f"warm-up; bound {bound_ms} ms (3 x {flops / 3e12} TFLOP forward over "
          f"{BF16_FLOPS_PER_S / 1e12} TFLOP/s, operations), share {bound_ms / med}; loss {loss}; "
          f"peak memory {peak} MiB; parameters moved {moved} [{card}]")
    require(torch.isfinite(torch.tensor(loss)).item() and moved, "a finite loss, moved parameters")
    with held_s2("train 64x4"):
        selfplay.train_step(net, opt, sample)
    report_s2_equal("train 64x4")
    launched_only("the config-5 chunk and train step", required=("S1a", "S1b", "S2a", "S2b"))
    return {"self-play 64x4": chunk_counts, "train 64x4": step_counts}


def driver_path(dev, card: str) -> None:
    """Phase 19: the driver as a program on the card, then --resume."""
    expect_first = ["train", "gate_vs_init", "train", "gate_vs_init", "best",
                    "gate_vs_random", "done"]
    # iteration 4 trains without a record: the script logs 1-3 and every 10th
    expect_resume = ["resume", "gate_vs_init", "best", "gate_vs_random", "done"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, log = os.path.join(tmp, "ckpt"), os.path.join(tmp, "gate.jsonl")
        records = []
        for extra, expect in ((["--iterations=3", "--gates=2,3"], expect_first),
                              (["--iterations=4", "--gates=2,3,4", "--resume"], expect_resume)):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "twixt_for_open_spiel_tpu_torch.train_arena_gate",
                 *(f"--{k}={v}" for k, v in DRIVER.items()), *extra, f"--checkpoint_dir={ckpt}", f"--log={log}"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            secs = time.perf_counter() - t0
            require(proc.returncode == 0, f"the driver exits 0: {proc.stderr[-2000:]}")
            require("device=cuda" in proc.stderr, "the driver ran on the card")
            with open(log) as f:
                recs = [json.loads(line) for line in f][len(records):]
            records += recs
            kinds = [r["kind"] for i, r in enumerate(recs)
                     if i == 0 or r["kind"] != recs[i - 1]["kind"]]  # runs of train as one
            print(f"[driver] {' '.join(extra)}: {secs} s, records "
                  f"{[r['kind'] for r in recs]} [{card}]")
            for r in recs:
                print(f"[driver]   {json.dumps(r)}")
            require(kinds == expect, f"the record kinds in order: {kinds}")
        resume = next(r for r in records if r["kind"] == "resume")
        with open(os.path.join(ckpt, "best_meta.json")) as f:
            meta_after = json.load(f)
        best_first = next(r for r in records if r["kind"] == "best")
        require(resume["from_iteration"] == 3, "resume from iteration 3")
        require([r["iteration"] for r in records if r["kind"] == "gate_vs_init"] == [2, 3, 4],
                "the resumed run starts at iteration 4 (its gate)")
        require((resume["best_iteration"], resume["best_score"]) ==
                (best_first["iteration"], best_first["a_score"]), "the best record restored")
        params, opt_state, it = serialization.restore_training(ckpt, dev)
        on_card = all(t.is_cuda for t in params.values()) and all(
            t.is_cuda for s in opt_state["state"].values() for k, t in s.items()
            if k != "step")
        net = create_net(DRIVER["board_size"], DRIVER["channels"], DRIVER["blocks"], device=dev)
        net.load_state_dict(params)
        opt = selfplay.make_optimizer(net.parameters())
        opt.load_state_dict(opt_state)
        print(f"[driver] checkpoint at iteration {it} loaded onto the card: {on_card}; "
              f"best_meta.json {meta_after}")
        require(it == 4 and on_card, "the checkpoint tensors load onto the card")


def gumbel_equal_path(dev) -> None:
    """Phase 20: gumbel_search_batch and search_batch_reuse against the JAX
    fixtures, both backups, every kernel call held to its plain version."""
    zero_counts()
    with held_to_plain():
        gumbel_reuse_cases(dev)
    report_s1_equal("the Gumbel and reuse fixtures' cases, both backups")
    launched_only("the Gumbel and reuse searches", required=SEARCH_KERNELS)


def gumbel_reuse_cases(dev) -> None:
    rec = json.loads(GUMBEL_FIXTURE.read_text())
    n = rec["board_size"]
    roots = cases.scenario_roots(rec["scenarios"], n, dev)
    for case in rec["search"]:
        sims, mc = case["num_simulations"], case["max_considered"]
        noise = torch.from_numpy(cases.gumbel_case_noise(sims, mc, len(rec["scenarios"])))
        for backup in ("amask", "walk"):
            action, improved, root_q = mcts.gumbel_search_batch(
                None, roots, torch.Generator(device=dev).manual_seed(0),
                evaluator=cases.EVALUATORS["table"](n * n), board_size=n,
                num_simulations=sims, max_considered=mc, gumbel_noise=noise.to(dev),
                backup=backup)
            same = action.cpu().tolist() == case["action"]
            p_err = float((improved.cpu() - torch.tensor(case["improved"])).abs().max())
            q_err = float((root_q.cpu() - torch.tensor(case["root_q"])).abs().max())
            print(f"[gumbel equal] n={n} sims={sims} max_considered={mc} {backup}: "
                  f"actions {'equal' if same else 'DIFFER'}, |improved - JAX| {p_err} "
                  f"(tolerance {GUMBEL_TOL['improved']}), |root_q - JAX| {q_err}")
            require(same and p_err <= GUMBEL_TOL["improved"]
                    and q_err <= GUMBEL_TOL["root_q"], f"gumbel vs JAX at {sims}/{mc}")

    rec = json.loads(REUSE_FIXTURE.read_text())
    for seq in rec["sequences"]:
        sims, cap, kind = seq["num_simulations"], seq["reuse_cap"], seq["evaluator"]
        for backup in ("amask", "walk"):
            got = cases.reuse_sequence(dev, rec["scenarios"], rec["board_size"], sims, cap,
                                       kind, backup, len(seq["moves"]))
            same = all(
                v.tolist() == w["visits"] and a.tolist() == w["actions"]
                and st == {"reused_envs": w["reused_envs"],
                           "inherited_visits": w["inherited_visits"]}
                for (v, _, st, a), w in zip(got, seq["moves"]))
            q_err = max(float(abs(q - torch.tensor(w["root_q"]).numpy()).max())
                        for (_, q, _, _), w in zip(got, seq["moves"]))
            print(f"[reuse equal] n={rec['board_size']} sims={sims} cap={cap} {kind} "
                  f"{backup}, {len(got)} moves: root visits and stats "
                  f"{'equal' if same else 'DIFFER'} at every move, |root_q - JAX| {q_err}; "
                  f"reused envs {[st['reused_envs'] for _, _, st, _ in got]}")
            require(same and q_err <= 1e-5, f"the reuse sequence vs JAX ({sims}/{cap} {kind})")


def arms_equal_path(dev) -> None:
    """Phase 21: the deterministic reuse and Gumbel chunks against the JAX
    records."""
    zero_counts()
    rec = json.loads(ARMS_FIXTURE.read_text())
    for search, want in rec["chunks"].items():
        got = cases.sample_record(*cases.arm_chunk(dev, search))
        same = {k: got[k] == want[k] for k in ("obs_sha256", "obs_shape", "value", "weight",
                                               "final_digest")}
        same["aux"] = {k: got["aux"][k] for k in want["aux"]} == want["aux"]
        p_err = float((torch.tensor(got["policy"]) - torch.tensor(want["policy"])).abs().max())
        tol = ARMS_POLICY_TOL if search == "gumbel" else 0.0
        print(f"[selfplay equal] search={search} n={rec['board_size']} batch={rec['batch']} "
              f"steps={rec['num_steps']} sims={rec['num_simulations']} table net, greedy, no "
              f"root noise{', zero Gumbels' if search == 'gumbel' else ''}, value_bootstrap="
              f"{rec['value_bootstrap']}: {same}; |policy - JAX| {p_err} (tolerance {tol})")
        require(all(same.values()) and p_err <= tol, f"the {search} chunk vs JAX")
    launched_only("the arms' chunks", required=("S1a", "S1b"))


def cuda_timed(fn, *args, **kwargs):
    """(fn's output, its milliseconds by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kwargs)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def search_arms_rate_path(dev, card: str) -> None:
    """Phase 22: at config-5 width, ``search_batch``, ``gumbel_search_batch``
    and ``search_batch_reuse`` after a played ply, timed in turns."""
    zero_counts()
    n, b, _, sims, ch, blocks = SELFPLAY_ROW
    net = create_net(n, ch, blocks, device=dev)
    evaluator = mcts.net_evaluator(call_net, n)
    roots = tbit.bit_random_rollout(3, n, 24, tbit.bit_reset(n, b, dev))[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(evaluator=evaluator, board_size=n, num_simulations=sims)
    legal = tbit.bit_legal_mask_flat(roots, roots.current_player.clamp(0, 1), n).T

    # the reuse search's input: the trees of a first (cold) call and the
    # greedy ply played from them
    tree = mcts.init_reuse_tree(roots, board_size=n, num_simulations=sims)
    nodes = tree.visit.shape[1]
    done = torch.ones(b, dtype=torch.bool, device=dev)
    played = torch.full((b,), -1, dtype=torch.int32, device=dev)
    (probs, _, tree, cold), c_ms = cuda_timed(
        mcts.search_batch_reuse, net, roots, gen, tree, played, done, return_stats=True, **kw)
    played = torch.where(legal, probs, -1.0).argmax(-1).to(torch.int32)
    after, done, _ = tbit.bit_step_auto_reset(roots, played, n)
    searches = {
        "search_batch": lambda: mcts.search_batch(net, roots, gen, **kw),
        "gumbel_search_batch": lambda: mcts.gumbel_search_batch(net, roots, gen, **kw),
        "search_batch_reuse": lambda: mcts.search_batch_reuse(
            net, after, gen, tree, played, done, return_stats=True, **kw),
    }
    ms, peak, out = {k: [] for k in searches}, dict.fromkeys(searches, 0.0), {}
    for fn in searches.values():
        fn()  # warm-up
    for _ in range(SEARCH_REPS):  # in turns
        for name, fn in searches.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out[name], t = cuda_timed(fn)
            ms[name].append(t)
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated() / 2**20)
    med = {k: statistics.median(v) for k, v in ms.items()}

    action, improved, root_q = out["gumbel_search_batch"]
    require(bool(legal[torch.arange(b, device=dev), action].all()), "the Gumbel actions are legal")
    require(bool((improved[~legal] == 0).all()) and bool(torch.isfinite(root_q).all())
            and float((improved.sum(-1) - 1).abs().max()) <= 1e-5, "the improved policy")
    probs, root_q, tree_r, stats = out["search_batch_reuse"]
    legal_after = tbit.bit_legal_mask_flat(after, after.current_player.clamp(0, 1), n).T
    visits = torch.where(legal_after, mcts._root_visits(tree_r), 0)
    require(bool((probs[~legal_after] == 0).all()) and bool((root_q.abs() <= 1).all()),
            "the reuse search's invariants")
    require(bool((visits.sum(-1) >= sims).all()), "every root holds at least the budget")
    require(stats["reused_envs"] > 0 and stats["inherited_visits"] > b,
            "the played ply's subtrees were reused")
    m, schedule = mcts._halving_schedule(16, n * n, sims)
    print(f"[gumbel rate] config-5 width: n={n} batch={b} sims={sims} net {ch}x{blocks} bf16, "
          f"{SEARCH_REPS} rounds in turns with search_batch and the reuse search: "
          f"search_batch median {med['search_batch']} ms of {ms['search_batch']} -> "
          f"{med['search_batch'] / sims} ms a simulation, peak {peak['search_batch']} MiB; "
          f"gumbel_search_batch (max_considered 16: m={m}, schedule {schedule}) median "
          f"{med['gumbel_search_batch']} ms of {ms['gumbel_search_batch']} -> "
          f"{med['gumbel_search_batch'] / sims} ms a simulation (ratio "
          f"{med['gumbel_search_batch'] / med['search_batch']}), peak "
          f"{peak['gumbel_search_batch']} MiB [{card}]")
    backup = "amask" if mcts._resolve_backup("auto", nodes) else "walk"
    print(f"[reuse rate] config-5 width: n={n} batch={b} sims={sims} reuse_cap {sims + 1} "
          f"({nodes} slots, {backup} backup): the first (cold) call {c_ms} ms "
          f"(reused {cold['reused_envs']}); after a played greedy ply median "
          f"{med['search_batch_reuse']} ms of {ms['search_batch_reuse']} -> "
          f"{med['search_batch_reuse'] / sims} ms a simulation (ratio to search_batch "
          f"{med['search_batch_reuse'] / med['search_batch']}); reused_envs "
          f"{stats['reused_envs']} of {b}, inherited_visits {stats['inherited_visits']} "
          f"({stats['inherited_visits'] / b} a root); peak memory {peak['search_batch_reuse']} "
          f"MiB [{card}]")
    launched_only("the Gumbel and reuse searches at config-5 width", required=("S1a", "S1b"))


def arms_rate_path(dev, card: str) -> None:
    """Phase 23: one config-5 chunk of each arm, cut to ARM_CHUNK_STEPS plies."""
    zero_counts()
    n, b, _, sims, ch, blocks = SELFPLAY_ROW
    steps = ARM_CHUNK_STEPS
    net = create_net(n, ch, blocks, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for search, name in (("gumbel", "gumbel_search_batch"), ("puct_reuse", "search_batch_reuse")):
        kw = dict(board_size=n, num_simulations=sims, temp_moves=SELFPLAY_TEMP_MOVES,
                  search=search)
        if search == "puct_reuse":
            kw.update(dirichlet_alpha=0.3, dirichlet_frac=0.25)
        selfplay.selfplay_chunk(net, tbit.bit_reset(n, b, dev), gen, num_steps=2, **kw)  # warm-up
        events = []
        real = getattr(mcts, name)

        def timed(*args, real=real, **kwargs):
            out, ms = cuda_timed(real, *args, **kwargs)
            events.append(ms)
            return out

        roots = tbit.bit_reset(n, b, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        setattr(mcts, name, timed)
        try:
            t0 = time.perf_counter()
            final, sample, aux = selfplay.selfplay_chunk(net, roots, gen, num_steps=steps,
                                                         debug_trace=True, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            setattr(mcts, name, real)
        peak = torch.cuda.max_memory_allocated() / 2**20
        require(len(events) == steps, "one search a ply")
        states, bs = [], roots
        for a in aux["actions"]:
            states.append(bs)
            bs = tbit.bit_step_auto_reset(bs, a, n)[0]
        require(tbit.state_digest(bs) == tbit.state_digest(final), "the replay ends at the final state")
        for k, s in enumerate(states):
            legal = tbit.bit_legal_mask_flat(s, s.current_player.clamp(0, 1), n).T
            require(bool(legal[torch.arange(b, device=dev), aux["actions"][k].long()].all()),
                    f"legal moves at step {k}")
            require(bool((sample.policy[k][~legal] == 0).all()), f"no policy mass off the legal set ({k})")
        row_err = float((sample.policy.sum(-1) - 1).abs().max())
        require(row_err <= 1e-5 and bool((sample.value.abs() <= 1).all()), "the targets")
        print(f"[selfplay {search.replace('puct_', '')} rate] config 5 cut to {steps} plies: "
              f"n={n} batch={b} sims={sims} net {ch}x{blocks} bf16, search={search}"
              f"{', temp_moves=16, Dirichlet 0.3/0.25' if search == 'puct_reuse' else ''}: "
              f"{secs} s -> {b * steps / secs} moves/s, {secs / steps} s a ply; {name} "
              f"{sum(events) / 1e3 / secs} of the time (CUDA events); frames with weight 1 "
              f"{int((sample.weight == 1).sum())} of {sample.weight.numel()}; peak memory {peak} "
              f"MiB; invariants hold (policy rows sum to 1 within {row_err}) [{card}]")
    launched_only("the arms' config-5 chunks", required=("S1a", "S1b"))


def arena_arms_path(dev, card: str) -> None:
    """Phase 24: the Gumbel, reuse and asymmetric arenas at the arena row's
    board and batch, every move checked legal."""
    zero_counts()
    n, b, _ = ARENA_ROW
    sims = ARENA_ARMS_SIMS
    net = create_net(n, device=dev)
    sims_a, sims_b = ASYM_SIMS
    runs = [
        (f"arena_match(search='gumbel') vs random_b, sims={sims}",
         lambda g: arena.arena_match(net, net, g, board_size=n, batch=b, num_simulations=sims,
                                     random_b=True, search="gumbel", device=dev)),
        (f"arena_match(reuse_a=True), sims={sims}",
         lambda g: arena.arena_match(net, net, g, board_size=n, batch=b, num_simulations=sims,
                                     reuse_a=True, device=dev)),
        (f"arena_match_asym, gumbel sims_a={sims_a} vs puct sims_b={sims_b}",
         lambda g: arena.arena_match_asym(net, g, board_size=n, batch=b, sims_a=sims_a,
                                          sims_b=sims_b, device=dev)),
    ]
    for what, play in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cases.checked_moves() as counts:
            got = play(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        final = got["final_state"]
        require(counts["illegal"] == 0 and counts["moves"] == got["moves"] * b,
                f"every move legal ({what})")
        require(bool((final.result != geo.RESULT_OPEN).all()), f"every game ended ({what})")
        require(got["a_wins"] + got["b_wins"] + got["draws"] == b and
                got["a_score"] == (got["a_wins"] + 0.5 * got["draws"]) / b, f"the tally ({what})")
        env_moves = int(final.move_counter.sum())
        print(f"[arena gumbel] {what}, untrained net (128 channels, 6 blocks, bf16) n={n} "
              f"batch={b}: {dict((k, got[k]) for k in ('a_wins', 'b_wins', 'draws', 'a_score'))},"
              f" {got['moves']} lockstep plies ({s / got['moves']} s a ply), {counts['moves']} "
              f"moves checked legal, {env_moves} moves played in {s} s -> {env_moves / s} "
              f"moves/s [{card}]")
    launched_only("the arena arms", required=("S1a", "S1b"))


@contextlib.contextmanager
def driver_arms(dev, card: str):
    """Phase 25: the driver as two programs with the other searches, started
    on entry and checked on exit (their loops wait on the host, so they run
    beside phase 19's)."""
    expect = ["train", "gate_vs_init", "train", "gate_vs_init", "best", "gate_vs_random", "done"]
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        t0 = time.perf_counter()
        try:
            for i, flags in enumerate(DRIVER_ARMS):
                ckpt, log = os.path.join(tmp, f"ckpt{i}"), os.path.join(tmp, f"gate{i}.jsonl")
                cmd = [sys.executable, "-m", "twixt_for_open_spiel_tpu_torch.train_arena_gate",
                       *(f"--{k}={v}" for k, v in DRIVER.items()), "--iterations=3",
                       "--gates=2,3", *flags, f"--checkpoint_dir={ckpt}", f"--log={log}"]
                runs.append((flags, ckpt, log, subprocess.Popen(
                    cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            yield
            for flags, ckpt, log, proc in runs:
                _, err = proc.communicate(timeout=600)
                secs = time.perf_counter() - t0
                require(proc.returncode == 0, f"the driver {flags} exits 0: {err[-2000:]}")
                opts = dict(f[2:].split("=", 1) for f in flags if "=" in f)
                search, arena_search = opts["search"], opts.get("arena_search", "puct")
                require("device=cuda" in err and
                        f"search={search} arena_search={arena_search}" in err,
                        f"the driver ran {flags} on the card")
                with open(log) as f:
                    recs = [json.loads(line) for line in f]
                kinds = [r["kind"] for i, r in enumerate(recs)
                         if i == 0 or r["kind"] != recs[i - 1]["kind"]]
                print(f"[driver] {' '.join(flags)} --iterations=3 --gates=2,3, beside phase 19: "
                      f"ended {secs} s after its start; records {[r['kind'] for r in recs]} "
                      f"[{card}]")
                for r in recs:
                    print(f"[driver]   {json.dumps(r)}")
                require(kinds == expect, f"the record kinds in order: {kinds}")
                params, _, it = serialization.restore_training(ckpt, dev)
                require(it == 3 and all(t.is_cuda for t in params.values()), "the checkpoint")
        finally:
            for *_, proc in runs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def sharded_train_case(dev):
    """Phase 26 (b)'s inputs: the seeded float32 net's flax parameters and a
    chunk it played on the card, half the envs' weights zeroed."""
    n, b, t, sims, ch, blocks = DIST_TRAIN
    tree = convert.params_to_flax(cases.random_state_dict(n, ch, blocks, cases.TRAIN["param_seed"]))
    net = cases.train_net(tree, n, ch, blocks, dev)
    # roots part-way through random games, so that episodes end in the chunk
    roots = tbit.bit_random_rollout(cases.CHUNK["rollout_seed"], n, cases.CHUNK["rollout_steps"],
                                    tbit.bit_reset(n, b, dev))[0]
    _, sample = selfplay.selfplay_chunk(net, roots,
                                        torch.Generator(device=dev).manual_seed(1),
                                        board_size=n, num_steps=t, num_simulations=sims)
    w = sample.weight.clone()
    w[:, : b // 2] = 0.0
    require(float(w.sum()) > 0, "live value frames beside the zeroed half")
    return tree, selfplay.Sample(*(x.cpu() for x in sample._replace(weight=w)))


def shared_rollout_path(dev, card: str, k1_report: dict, k1_ms: float) -> None:
    """Phase 26 (a): two ranks, then four, spawned on the card over a gloo
    group (NCCL refuses two ranks on one device), run the sharded K1
    rollout with nothing else on the card."""
    t0 = time.perf_counter()
    k1_report["rank_ms"], k1_report["rank_launches"] = {}, {}
    for world in SHARED_ROLLOUT_RANKS:
        rec, (case, kw) = sharded_rollout_job(world, SHARDED_REPS)
        ranks = parallel.spawn_ranks(cases.dist_rank, world, (str(dev), [("rollout", case, kw)]),
                                     timeout=600)
        rolls = [r["rollout"] for r in ranks]
        check_sharded_rollout(rolls, rec, f"on {dev}, gloo", card)
        b, steps = HEADLINE[1], RATE_STEPS
        call_ms = max(statistics.median(g["call_ms"]) for g in rolls)
        print(f"[dist rollout] {world} ranks on one card: {b * steps / call_ms * 1e3} "
              f"env-steps/s globally (the slower rank's sharded call) beside phase 5's one "
              f"process {b * steps / k1_ms * 1e3} ({k1_ms} ms) [{card}]")
        k1_report["rank_ms"][world] = [statistics.median(g["kernel_ms"]) for g in rolls]
        k1_report["rank_launches"][world] = [g["launches"] for g in rolls]
    print(f"[dist] phase 26 (a) in {time.perf_counter() - t0} s")


def sharded_rollout_job(world: int, reps: int) -> tuple:
    """``tests/fixtures/torch_port_sharded_rollout.json``'s case of ``world``
    ranks (the headline row) and the ``case_bit_rollout`` job that runs it
    on every rank: the plain version on the same shard beside, ``reps``
    timed launches and sharded calls a rank."""
    rec = {c["world_size"]: c for c in json.loads(SHARDED_FIXTURE.read_text())["cases"]}[world]
    n, b, steps, seed = rec["board_size"], rec["batch"], rec["num_steps"], rec["seed"]
    require((n, b, steps) == (*HEADLINE, RATE_STEPS), "the fixture's case is the headline row")
    return rec, ("bit_rollout", dict(board_size=n, batch=b, num_steps=steps, seed=seed,
                                     check_plain=True, reps=reps))


def check_sharded_rollout(rolls: list, rec: dict, where: str, card: str) -> None:
    """Each rank's K1 launched, its shard bit-equal to the plain version and
    to the fixture's digest ``rec``, the reduced counters to the fixture's;
    prints each rank's line (``where``: the ranks' card and backend)."""
    world, n, b, steps, seed = (rec[k] for k in ("world_size", "board_size", "batch", "num_steps",
                                                 "seed"))
    require(len(rolls) == world, f"{world} ranks")
    for rank, got in enumerate(rolls):
        err = max_abs_diff(zip(got["leaves"], got["plain"]["leaves"]))
        digest = tbit.state_digest(tbit.bitstate_from_leaves(got["leaves"]))
        timed = ""
        if "kernel_ms" in got:
            timed = (f"; K1 median {statistics.median(got['kernel_ms'])} ms of "
                     f"{got['kernel_ms']} (CUDA events), the sharded call with its all-reduce "
                     f"median {statistics.median(got['call_ms'])} ms of {got['call_ms']}")
        print(f"[dist rollout] rank {rank} of {world} {where}: n={n} {b // world} of {b} envs, "
              f"{steps} steps, seed {parallel.envsharding.rank_seed(seed, rank)}: K1 launches "
              f"{got['launches']}, max_abs_err vs plain {err}, digest {digest[:16]}{timed} "
              f"[{card}]")
        require(got["launches"] >= 1, f"rank {rank} launched K1 on its shard")
        require(err == 0, f"rank {rank}: K1 != plain on its shard")
        require((got["episodes"], got["results"]) ==
                (got["plain"]["episodes"], got["plain"]["results"]), "reduced stats vs plain")
        require(digest == rec["digests"][rank], f"rank {rank}'s shard vs the JAX fixture")
        require((got["episodes"], got["results"]) == (rec["episodes"], rec["results"]),
                "reduced stats vs the JAX fixture")


def shared_learner_path(dev, card: str) -> dict:
    """Phase 26 (b)-(d): two ranks spawned on the card over gloo, the
    distributed train step, the deterministic chunk and the learn check.
    Returns the learn check's tally, which ``main`` holds to the bar."""
    tree, sample = sharded_train_case(dev)
    _, _, _, _, ch, blocks = DIST_TRAIN
    train = dict(flax_params=tree, sample=sample, channels=ch, blocks=blocks, optimizer="sgd",
                 lr=0.1, steps=1)
    jobs = [("train1", "train", dict(train, microbatch=1)),
            ("train3", "train", dict(train, microbatch=3)),
            ("chunk0.0", "chunk", {"value_bootstrap": 0.0}),
            ("chunk0.5", "chunk", {"value_bootstrap": 0.5}),
            ("learn", "learn", {})]
    t0 = time.perf_counter()
    ranks = parallel.spawn_ranks(cases.dist_rank, SHARED_RANKS, (str(dev), jobs), timeout=900)
    secs = time.perf_counter() - t0

    # (b) the distributed train step against the local one on the whole sample
    with no_tf32():
        n5 = DIST_TRAIN[0]
        net = cases.train_net(tree, n5, ch, blocks, dev)
        local = selfplay.train_step(net, torch.optim.SGD(net.parameters(), 0.1),
                                    selfplay.Sample(*(x.to(dev) for x in sample)))
        want = {k: v.cpu() for k, v in net.state_dict().items()}
    check_dist_train(ranks, want, {k: float(v) for k, v in local.items()}, "one card, gloo")

    # (c) the deterministic chunk, split over the ranks
    chunks = json.loads(SELFPLAY_FIXTURE.read_text())["chunks"]
    for vb in (0.0, 0.5):
        parts = [r[f"chunk{vb}"] for r in ranks]
        final = tbit.bitstate_from_leaves(cases.concat_ranks([p["final"] for p in parts]))
        sample_ = selfplay.Sample(*cases.concat_ranks([p["sample"] for p in parts], 1))
        got = cases.sample_record(final, sample_)
        want = {k: v for k, v in chunks[str(vb)].items() if k != "aux"}
        print(f"[dist chunk] value_bootstrap {vb}: {SHARED_RANKS} ranks' columns equal "
              f"torch_port_selfplay.json {got == want}")
        require(got == want, f"the distributed chunk (bootstrap {vb}) vs the JAX record")

    # (d) the learn check
    learns = [r["learn"] for r in ranks]
    tally = learns[0]["tally"]
    same = all(torch.equal(learns[0]["params"][k], learns[1]["params"][k])
               for k in learns[0]["params"])
    c = cases.LEARN
    losses = learns[0]["losses"]
    h = len(losses) // 2
    first, last = sum(losses[:h]) / h, sum(losses[h:]) / (len(losses) - h)
    verdict = "held" if tally["a_score"] >= c["bar"] else "FAILS"
    print(f"[dist learn] board {c['board_size']}, batch {c['batch']}, chunk {c['chunk_steps']}, "
          f"{c['simulations']} simulations, {c['channels']}x{c['blocks']} bf16, "
          f"{c['iterations']} iterations on {SHARED_RANKS} ranks: {learns[0]['train_s']} s, "
          f"loss {losses[0]} -> {losses[-1]} (halves {first} -> {last}); the trained net vs JAX's "
          f"init over {c['games']} games {tally} ({learns[0]['arena_s']} s): bar {c['bar']} "
          f"{verdict}; ranks bitwise equal {same} [{card}]")
    require(same, "the learn check's ranks end equal")
    print(f"[dist] phase 26 (b)-(d) in {secs} s")
    return tally


def check_dist_train(ranks: list, want: dict, local: dict, where: str) -> None:
    """Phase 26 (b)'s bars on the ranks' ``train1`` and ``train3`` results
    (``case_train``, microbatch 1 and 3): the parameters against the local
    step's ``want`` (rtol 2e-5 / atol 1e-6), the metrics against its
    ``local`` (rtol 2e-5), and every rank's parameters and metrics bitwise
    rank 0's."""
    for k in (1, 3):
        got = [r[f"train{k}"] for r in ranks]
        a = got[0]
        err = max(float(((a["params"][name] - w).abs() / (DIST_TRAIN_TOL["atol"] + DIST_TRAIN_TOL[
            "rtol"] * w.abs())).max()) for name, w in want.items())
        m_err = max(abs(a["metrics"][0][key] / local[key] - 1) for key in DIST_METRICS)
        same = all(torch.equal(a["params"][name], g["params"][name]) and
                   a["metrics"] == g["metrics"] for g in got[1:] for name in want)
        print(f"[dist train] {len(ranks)} ranks ({where}), microbatch {k}, float32 (TF32 off), "
              f"SGD 0.1, half the envs' weights zeroed: parameters vs the local step at {err} of "
              f"rtol 2e-5 + atol 1e-6, metrics rtol {m_err}; the ranks bitwise equal {same}")
        require(err <= 1 and m_err <= 2e-5, f"the distributed step vs local (microbatch {k})")
        require(same, "the ranks' parameters and metrics bitwise equal")


@contextlib.contextmanager
def dist_programs(dev, card: str):
    """Phase 27's programs, started on entry and checked on exit (their
    loops wait on the host, so they run beside phase 26 (b)-(d), and their
    times are taken under that load): the driver with ``--mesh=1`` (a
    world of one over NCCL) at phase 19's cut, then its ``--resume``; the
    example front door for two iterations."""
    procs, stop = [], threading.Event()

    def run(cmd):
        if stop.is_set():
            raise RuntimeError("stopped")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        procs.append(proc)
        out, err = proc.communicate(timeout=600)
        return proc.returncode, out, err, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(2) as pool:
        ckpt, log = os.path.join(tmp, "ckpt"), os.path.join(tmp, "gate.jsonl")
        driver = [sys.executable, "-m", "twixt_for_open_spiel_tpu_torch.train_arena_gate",
                  *(f"--{k}={v}" for k, v in DRIVER.items()), "--mesh=1",
                  f"--checkpoint_dir={ckpt}", f"--log={log}"]
        flags = (["--iterations=3", "--gates=2,3"], ["--iterations=4", "--gates=2,3,4", "--resume"])
        example = [sys.executable, "-m", "twixt_for_open_spiel_tpu_torch.examples.selfplay_train",
                   *(f"--{k}={DRIVER[k]}" for k in ("board_size", "batch", "chunk_steps",
                                                     "simulations", "channels", "blocks", "seed")),
                   "--iterations=2", f"--checkpoint_dir={os.path.join(tmp, 'example')}"]
        try:
            runs = pool.submit(lambda: [run(driver + f) for f in flags])
            ex = pool.submit(run, example)
            yield
            expect = (["train", "gate_vs_init", "train", "gate_vs_init", "best", "gate_vs_random",
                       "done"], ["resume", "gate_vs_init", "best", "gate_vs_random", "done"])
            results = runs.result(timeout=1200)
            with open(log) as f:
                recs = [json.loads(line) for line in f]
            first = next(i for i, r in enumerate(recs) if r["kind"] == "done") + 1
            for extra, (rc, _, err, secs), kinds_want, part in zip(
                    flags, results, expect, (recs[:first], recs[first:])):
                require(rc == 0, f"the driver --mesh=1 exits 0: {err[-2000:]}")
                require("device=cuda" in err and "mesh=1" in err,
                        "the driver ran --mesh=1 on the card")
                kinds = [r["kind"] for i, r in enumerate(part)
                         if i == 0 or r["kind"] != part[i - 1]["kind"]]
                print(f"[dist driver] --mesh=1 {' '.join(extra)}: {secs} s, records "
                      f"{[r['kind'] for r in part]} [{card}]")
                for r in part:
                    print(f"[dist driver]   {json.dumps(r)}")
                require(kinds == kinds_want, f"the record kinds in order: {kinds}")
            resume = next(r for r in recs if r["kind"] == "resume")
            require(resume["from_iteration"] == 3, "resume from iteration 3")
            params, _, it = serialization.restore_training(ckpt, dev)
            require(it == 4 and all(t.is_cuda for t in params.values()), "the checkpoint")
            rc, out, err, secs = ex.result(timeout=1200)
            lines = out.splitlines()
            print(f"[dist example] examples.selfplay_train, 2 iterations: {secs} s, {lines} "
                  f"[{card}]")
            require(rc == 0, f"the example exits 0: {err[-2000:]}")
            require("on cuda (nccl)" in lines[0] and [x.split(":")[0] for x in lines[1:]] ==
                    ["iter 0", "iter 1"], "the example's two iterations on the card")
            require(serialization.restore_training(os.path.join(tmp, "example"), dev)[2] == 2,
                    "the example's checkpoint")
        finally:
            stop.set()
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def nccl_world_of_one_path(dev, card: str) -> None:
    """Phase 27: a world of one over NCCL in this process at config-5
    width: one distributed chunk, the distributed train step beside the
    local one, and the all-reduce alone."""
    zero_counts()
    parallel.initialize_world(device="cuda")
    try:
        mesh = parallel.make_env_mesh()
        require(dist.get_backend() == "nccl" and mesh.size == 1, "a world of one over NCCL")
        n, b, _, sims, ch, blocks = SELFPLAY_ROW
        steps = DIST_CHUNK_STEPS
        net = create_net(n, ch, blocks, device=mesh.device)
        parallel.broadcast_params(net, mesh)
        play, _ = parallel.make_distributed_selfplay(
            call_net, n, steps, sims, mesh, temp_moves=SELFPLAY_TEMP_MOVES,
            dirichlet_alpha=0.3, dirichlet_frac=0.25)
        gen = parallel.rank_generator(0, mesh)
        # roots part-way through random games, so that episodes end in the
        # chunk and the train step has finished frames to weigh
        state = tbit.bit_random_rollout(0, n, DIST_ROOT_STEPS,
                                        parallel.sharded_bit_reset(n, b, mesh))[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, sample = play(net, state, gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        pk = sample.obs.reshape(steps, b, 12, n + 2 * geo.PAD)
        legal = tobs.unpack_legal_words_flat(tobs.legal_words_from_obs(pk), n)
        row_err = float((sample.policy.sum(-1) - 1).abs().max())
        require(bool((sample.policy[~legal] == 0).all()), "no policy mass off the wire's legal set")
        require(row_err <= 1e-5, "every policy row sums to 1")
        require(bool(((sample.weight == 0) | (sample.weight == 1)).all()), "weights in {0, 1}")
        require(bool((sample.value.abs() <= 1).all()), "|value| <= 1")
        require(state.red.shape == (n + 6, b), "the shard's final state")
        require(float(sample.weight.sum()) > 0, "episodes end in the chunk")
        print(f"[nccl selfplay] world of one, config 5 cut to {steps} plies from roots "
              f"{DIST_ROOT_STEPS} random plies in: n={n} batch={b} "
              f"sims={sims} net {ch}x{blocks} bf16, temp_moves={SELFPLAY_TEMP_MOVES}, Dirichlet "
              f"0.3/0.25: {secs} s -> {b * steps / secs} moves/s, {secs / steps} s a ply; frames "
              f"with weight 1 {int((sample.weight == 1).sum())} of {sample.weight.numel()}; peak "
              f"memory {peak} MiB; invariants hold (policy rows sum to 1 within {row_err}) "
              f"[{card}]")

        local_net = copy.deepcopy(net)
        opt = selfplay.make_optimizer(net.parameters(), TRAIN_LR)
        local_opt = selfplay.make_optimizer(local_net.parameters(), TRAIN_LR)
        step, _ = parallel.make_distributed_train_step(call_net, opt, mesh)
        last = {}
        runs = {"local": lambda: selfplay.train_step(local_net, local_opt, sample),
                "distributed": lambda: last.update(step(net, sample))}
        # the first steps, from equal parameters: the same metrics
        first = {"local": runs["local"](), "distributed": step(net, sample)}
        m_err = max(abs(float(first["distributed"][k]) / float(first["local"][k]) - 1)
                    for k in DIST_METRICS)
        ms = {k: [] for k in runs}
        for _ in range(TRAIN_REPS):  # in turns
            for k, run in runs.items():
                ms[k] += timed_ms(run, 1)
        med = {k: statistics.median(v) for k, v in ms.items()}
        # the same steps, but cuDNN's backward may sum in another order
        drift = max(float((a - p).abs().max()) for a, p in zip(local_net.state_dict().values(),
                                                                net.state_dict().values()))

        grads = [p for p in net.parameters()]
        numel = sum(p.numel() for p in grads)
        flat = torch.zeros(numel, dtype=torch.float32, device=mesh.device)
        mesh.all_reduce(flat)
        ar_ms = timed_ms(lambda: mesh.all_reduce(flat), ALLREDUCE_REPS)
        print(f"[nccl train] on the chunk's {steps * b} frames "
              f"({int(first['local']['train_frames'])} finished), net {ch}x{blocks} bf16, AdamW "
              f"lr {TRAIN_LR}: the first steps' metrics {first['distributed']} against the local "
              f"step's at rtol {m_err}; in turns, the distributed step median {med['distributed']} ms of "
              f"{ms['distributed']}, the local train_step {med['local']} ms of {ms['local']}; "
              f"largest parameter difference after {TRAIN_REPS + 1} steps each {drift}; the "
              f"gradients' "
              f"all-reduce alone ({numel} float32 in {len(grads)} tensors, {numel * 4} bytes, one "
              f"collective) median {statistics.median(ar_ms)} ms of {ALLREDUCE_REPS} (CUDA "
              f"events) [{card}]")
        require(math.isfinite(float(last["loss"])) and
                float(last["train_frames"]) == float(sample.weight.sum()),
                "a finite loss over the chunk's finished frames")
        require(m_err <= DIST_TRAIN_TOL["rtol"], "the distributed step's metrics vs the local")
        launched_only("the NCCL world of one", required=("S1a", "S1b"))
    finally:
        dist.destroy_process_group()

def golden_path(dev, card: str) -> None:
    """Phase 28 (a)-(b): BASELINE config 1 (the golden playthrough, byte
    for byte) and the reference's scenarios through the adapter on the
    card, beside the C engine."""
    text = cases.PLAYTHROUGH_FIXTURE.read_text()
    actions, dumped = cases.playthrough_structure(text)
    out = {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        game = load_game("twixt", device=where)
        t0 = time.perf_counter()
        got = playthrough.generate(game, actions, full_dump_states=dumped)
        out[key] = (got, time.perf_counter() - t0)
    state = load_game("twixt", device=dev).new_initial_state()
    require(state.tensor_state.color.device.type == "cuda", "the game's tensors on the card")
    got, secs = out["card"]
    print(f"[host config 1] twixt() golden playthrough, {len(actions)} actions, "
          f"{len(dumped)} states dumped in full: {len(got)} characters, byte-equal to "
          f"tests/fixtures/playthrough_board8.txt: {got == text}; {secs} s on the card "
          f"(the CPU {out['cpu'][1]} s) [{card}]")
    require(got == text, "BASELINE config 1: the golden playthrough byte for byte on the card")

    def play(name, moves):
        s = load_game(name, device=dev).new_initial_state()
        for a in moves:
            s.apply_action(a)
        require(all(t.is_cuda for t in s.tensor_state), "the adapter's state stays on the card")
        return s

    def engine(n, moves):
        eng = NativeEngine(n)
        for a in moves:
            eng.apply(a)
        return eng

    win, c_win = play("twixt", cases.WIN_LINE), engine(8, cases.WIN_LINE)
    require(win.is_terminal() and win.returns() == c_win.returns() == [1.0, -1.0],
            "the win line ends with returns [1, -1]")
    swap, c_swap = play("twixt", [19, 19]), engine(8, [19, 19])
    la = swap.legal_actions()
    require(bool(swap.tensor_state.swapped) and c_swap.swapped, "19 then 19 swaps")
    require(19 in la and 29 not in la and la == c_swap.legal_actions(),
            "after the swap c5 is legal again, the rotated d3 is not")
    draw, c_draw, i = play("twixt(board_size=5)", []), NativeEngine(5), 0
    while not draw.is_terminal():  # the reference's .at(0) / .at(1) pattern
        la = draw.legal_actions()
        require(la == c_draw.legal_actions(), "the draw's legal sets, adapter and C")
        a = la[min(i % 2, len(la) - 1)]
        draw.apply_action(a)
        c_draw.apply(a)
        i += 1
    require(draw.returns() == c_draw.returns() == [0.0, 0.0] and c_draw.result == geo.RESULT_DRAW,
            "the board-5 draw")
    msgs = []
    for apply, kind in ((play("twixt", []).apply_action, SpielError), (NativeEngine(8).apply,
                                                                      ValueError)):
        try:
            apply(0)
        except kind as e:
            msgs.append(str(e))
    require(msgs == ["Not a legal action: 0"] * 2, f"the illegal corner refused: {msgs}")
    print(f"[host scenarios] on the card, each beside the C engine: the win line "
          f"{win.history} returns {win.returns()}; 19, 19 swapped; the board-5 draw in {i} "
          f"moves; {msgs}")


BUSY_STEPS = 32  # (c), (d): moves or lockstep steps traced for the card's busy share
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def device_busy(fn) -> tuple:
    """``fn`` under ``utils.profiling.trace``: its device activities, and
    their summed time over the span from the first one's start to the last
    one's end (the card's busy share; the rest is waiting on the host)."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            fn()
            torch.cuda.synchronize()
        (path,) = pathlib.Path(tmp).glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
    acts = [e for e in events if e.get("cat") in DEVICE_CATS]
    require(bool(acts), "the trace holds the card's activities")
    span = max(e["ts"] + e["dur"] for e in acts) - min(e["ts"] for e in acts)
    return len(acts), sum(e["dur"] for e in acts) / span


def adapter_games_path(dev, card: str) -> None:
    """Phase 28 (c): full random C games at board 24 applied move by move
    through the adapter on the card; the final board string and the state
    against the Python renderer and the C engine's snapshot."""
    n = 24
    padded, facts = cases.c_games(n, [97 * n + b for b in range(HOST_GAMES)])
    game = load_game(f"twixt(board_size={n})", device=dev)
    ms, moves, strings = [], 0, []
    for b in range(HOST_GAMES):
        history = [int(a) for a in padded[:, b] if a >= 0]
        s = game.new_initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in history:
            s.apply_action(a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / len(history))
        moves += len(history)
        t = s.tensor_state
        strings.append(s.to_string())
        require(t.color.is_cuda and s.is_terminal(), "a finished game on the card")
        require(strings[-1] == render_py(t.color, t.links, n, bool(t.swapped), int(t.result)),
                "the C renderer's string equals the Python renderer's at board 24")
        one = tstate.State(*(x[..., None] for x in t))
        bad = cases.state_mismatches(one, n, {k: v[b : b + 1] for k, v in facts.items()})
        require(bad == [], f"game {b}: the adapter's final state vs the C engine's: {bad}")
    cpu = load_game(f"twixt(board_size={n})", device="cpu").new_initial_state()
    history = [int(a) for a in padded[:, 0] if a >= 0]
    t0 = time.perf_counter()
    for a in history:
        cpu.apply_action(a)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / len(history)
    require(cpu.to_string() == strings[0], "the game on the CPU ends on the card's board")
    traced = game.new_initial_state()
    acts, busy = device_busy(lambda: [traced.apply_action(a) for a in history[:BUSY_STEPS]])
    print(f"[host adapter] n={n}: {HOST_GAMES} full C games ({moves} moves, results "
          f"{facts['result'].tolist()}) through TwixTState.apply_action on the card: {ms} ms a "
          f"move; the first on the CPU {cpu_ms} ms a move; final strings equal render_py and "
          f"the states the C engine's snapshots; under the profiler, {BUSY_STEPS} moves: "
          f"{acts / BUSY_STEPS} device activities a move, the card busy {busy} of their span "
          f"[{card}]")


def replay_path(dev, card: str) -> None:
    """Phase 28 (d): bit_replay of the C engine's games on the card, every
    final leaf against the C engine's snapshot; the C engine's own rate."""
    for n, games in REPLAY_ROWS:
        t0 = time.perf_counter()
        padded, facts = cases.c_games(n, [97 * n + b for b in range(games)])
        prep = time.perf_counter() - t0
        actions = torch.from_numpy(padded).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = bit_replay(n, actions)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require(final.red.is_cuda, "the replay ran on the card")
        bad = cases.replay_mismatches(final, n, facts)
        valid = int((padded >= 0).sum())
        t_max = padded.shape[0]
        print(f"[host replay] n={n} {games} C games (seeds 97*n+b), T_max={t_max}: one "
              f"bit_replay call on the card {secs} s, {secs / t_max * 1e3} ms a lockstep step, "
              f"{valid} valid env-steps -> {valid / secs} valid env-steps/s; every final "
              f"leaf equal to the C engine's snapshot: {not bad} {bad}; the C games and "
              f"snapshots {prep} s on the host [{card}]")
        require(bad == [], f"bit_replay at n={n} vs the C engine: {bad}")
        if games == REPLAY_ROWS[0][1]:
            acts, busy = device_busy(lambda: bit_replay(n, actions[:BUSY_STEPS]))
            print(f"[host replay] n={n} B={games} under the profiler, {BUSY_STEPS} lockstep "
                  f"steps: {acts / BUSY_STEPS} device activities a step, the card busy {busy} "
                  f"of their span [{card}]")
    n, seed, games = C_GAMES_ROW
    t0 = time.perf_counter()
    total, results = random_games(n, seed, games)
    secs = time.perf_counter() - t0
    require(sum(results) == games and results[geo.RESULT_OPEN] == 0, "the C games all end")
    print(f"[host C engine] random_games n={n} x {games}: {secs} s -> {games / secs} games/s, "
          f"{total / secs} moves/s on one host core; results {results}")


def profile_path(dev, card: str) -> None:
    """Phase 28 (f): utils.profiling.trace around a full-width search with
    an annotate span; the trace file names the span and holds the card's
    kernels."""
    n, b, sims = PROFILE_ROW
    net = create_net(n, device=dev)
    evaluator = mcts.net_evaluator(call_net, n)
    roots = tbit.bit_reset(n, b, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            with profiling.annotate(PROFILE_SPAN):
                probs, _ = mcts.search_batch(net, roots, gen, evaluator=evaluator,
                                             board_size=n, num_simulations=sims)
                torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        files = list(pathlib.Path(tmp).glob("*.pt.trace.json"))
        require(len(files) == 1, f"one trace file written: {files}")
        size = files[0].stat().st_size
        events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == PROFILE_SPAN]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"[host profile] trace of search_batch n={n} batch={b} sims={sims} (128x6 bf16 net): "
          f"{secs} s with the trace written (beside (e)'s programs), {size} bytes, {len(events)} events, {kernels} "
          f"device kernels, span {PROFILE_SPAN!r} found {len(spans)} times [{card}]")
    require(spans and kernels > 0, "the trace names the span and holds the card's kernels")
    require(bool((probs.sum(-1) - 1).abs().max() < 1e-5), "the traced search's visits")


@contextlib.contextmanager
def example_programs(card: str):
    """Phase 28 (e): the three examples as programs on the card, started on
    entry and checked on exit (they run beside (f) only, so that (a)-(d)
    are timed alone on the card and the host)."""
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, args in EXAMPLES.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"twixt_for_open_spiel_tpu_torch.examples.{name}", *args],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        yield
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            secs = time.perf_counter() - t0
            lines = out.splitlines()
            print(f"[host example] examples.{name} {' '.join(EXAMPLES[name])}: rc "
                  f"{proc.returncode}, ended {secs} s after its start; last line {lines[-1:]} "
                  f"[{card}]")
            require(proc.returncode == 0, f"examples.{name} exits 0: {err[-2000:]}")
            require(lines and {"example": "Utility for player 1 is",
                               "arena": "A score", "mcts_example": "Returns: ["}[name]
                    in lines[-1], f"examples.{name} ends with its result")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def host_path(dev, card: str) -> None:
    """Phase 28: the host side on the card; no kernel of the port runs."""
    zero_counts()
    require(native.load() is not None and load_engine() is not None, "the C libraries")
    golden_path(dev, card)
    adapter_games_path(dev, card)
    replay_path(dev, card)
    with example_programs(card):
        profile_path(dev, card)
    launched_only("the host side", required=("S1a", "S1b"))


def bench_program(card: str, k1_ms: float) -> dict:
    """Phase 29 (a): ``python3 -m twixt_for_open_spiel_tpu_torch.bench`` as a
    program, alone on the card, at its full rows.  Returns its K1 and K2
    launches."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "twixt_for_open_spiel_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("[bench]"):
            print(line)
    require(proc.returncode == 0, f"the bench exits 0: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    require(len(lines) == 1, "the bench prints one line on stdout")
    rec = json.loads(lines[0])
    require(set(rec) == {"metric", "value", "unit", "vs_baseline"} and
            rec["metric"] == bench.METRIC and rec["unit"] == "env-steps/s",
            f"the bench's line has bench.py's keys and metric: {rec}")
    k1, k2 = map(int, re.search(r"kernel launches: K1 (\d+), K2 (\d+)", proc.stderr).groups())
    n, b = HEADLINE
    phase5 = b * RATE_STEPS / k1_ms * 1e3
    ratio = rec["value"] / phase5
    print(f"[bench program] rc 0 in {secs} s: {lines[0]}; K1 launches {k1}, K2 launches {k2}; "
          f"the headline {ratio} x phase 5's K1 rate at n={n} batch={b} ({phase5} env-steps/s) "
          f"[{card}]")
    require(k1 > 0 and k2 > 0, "the bench launched K1 and K2")
    lo, hi = BENCH_HEADLINE_RATIO
    require(lo <= ratio <= hi, f"the bench's headline within {lo}-{hi}x phase 5's K1 rate")
    return {"K1": k1, "K2": k2}


@contextlib.contextmanager
def arena_programs(card: str, ckpt: str):
    """Phase 29 (d): ``arena_checkpoints`` on a run's directory and its
    ``best/``, and ``arena_gate_agreement`` on the run, once a setting, as
    programs on the card, started on entry and checked on exit: the JAX
    scripts' lines, every tally adding up."""
    args = {"arena_checkpoints": [f"--a={ckpt}", f"--b={ckpt}/best"],
            "arena_gate_agreement": [f"--ckpt={ckpt}", "--seed=0"]}
    procs = []
    t0 = time.perf_counter()
    try:
        for name, flags, lines in ARENA_PROGRAMS:
            procs.append((f"{name} {' '.join([*ARENA_FLAGS, *flags])}", lines, subprocess.Popen(
                [sys.executable, "-m", f"twixt_for_open_spiel_tpu_torch.{name}", *ARENA_FLAGS,
                 *flags, *args[name]], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        yield
        for what, lines, proc in procs:
            out, err = proc.communicate(timeout=600)
            secs = time.perf_counter() - t0
            require(proc.returncode == 0, f"{what} exits 0: {err[-2000:]}")
            recs = [json.loads(line) for line in out.splitlines()]
            for rec in recs:
                print(f"[arena program] {what}: {json.dumps(rec)} [{card}]")
                require(rec["a_wins"] + rec["b_wins"] + rec["draws"] == rec["games"] == 64,
                        f"{what}'s tally adds up")
            require(len(recs) == lines, f"{what}'s lines")
            print(f"[arena program] {what} ended {secs} s after its start")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def benches_path(dev, card: str, k1_ms: float) -> dict:
    """Phase 29: the benches and the checkpoint arenas.  Returns the
    kernels' launches, counted in the bench program and in (b)."""
    zero_counts()
    counts = bench_program(card, k1_ms)

    # (d) beside (b) and (c), which run in this process
    with tempfile.TemporaryDirectory(prefix="twixt_ckpt_") as ckpt:
        n, ch, blocks = CKPT_NET
        for sub, seed in CKPT_SEEDS.items():
            net = init_params(create_net(n, ch, blocks, device="cpu"), seed)
            serialization.save_training(ckpt if sub == "run" else f"{ckpt}/{sub}", net,
                                        selfplay.make_optimizer(net.parameters()), seed)
        with arena_programs(card, ckpt), contextlib.redirect_stderr(sys.stdout):
            t0 = time.perf_counter()
            # (b) bench_bitboard in full
            zero_counts()
            require(bench_bitboard.main([]) == 0, "bench_bitboard")
            k1, k3 = fbr.fused_bit_rollout.launches, ftr.fused_random_rollout.launches
            print(f"[bench_bitboard] K1 launches {k1}, K3 launches {k3} [{card}]")
            require(k1 > 0 and k3 > 0, "bench_bitboard launched K1 and K3")
            counts = {"K1": counts["K1"] + k1, "K2": counts["K2"], "K3": k3}
            # (c) the self-play benches at config 5's width, their depth cut
            zero_counts()
            parallel.initialize_world(device="cuda")  # bench_selfplay's world of one
            try:
                for flags in SELFPLAY_ARMS:
                    cfg = {**bench_selfplay.config(bench_selfplay.parse_args(flags), 1),
                           "chunk": BENCH_CHUNK}
                    bench_selfplay.report(cfg, bench_selfplay.iterations(cfg, dev, BENCH_REPS),
                                          1, dev)
            finally:
                dist.destroy_process_group()
            require(bench_search_scaling.main([f"--configs={SCALING_CONFIGS}",
                                               f"--chunk={BENCH_CHUNK}",
                                               f"--reps={BENCH_REPS}"]) == 0,
                    "bench_search_scaling")
            launched_only("the self-play benches", required=("S1a", "S1b"))
            print(f"[time] phase 29 (b) and (c) in this process: {time.perf_counter() - t0} s")
    return counts


BF16_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_train_bf16.json"


def recipe_path(dev, card: str) -> None:
    """Phase 30: a chunk of the board-12 recipe with its sampled plies
    checked for legality, and the bf16 step against JAX's record."""
    n, b, steps, sims, ch, blocks = SELFPLAY_ROW
    net = create_net(n, ch, blocks, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("moves", "sampled", "illegal", "illegal_sampled")}
    real_step = selfplay.bit_step_auto_reset

    def checked_step(bs, actions, size):
        legal = tbit.bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), size).T
        bad = ~legal.gather(1, actions.long()[:, None])[:, 0]
        sampled = bs.move_counter < SELFPLAY_TEMP_MOVES
        counts["moves"] += actions.numel()
        counts["sampled"] += sampled.sum()
        counts["illegal"] += bad.sum()
        counts["illegal_sampled"] += (bad & sampled).sum()
        return real_step(bs, actions, size)

    zero_counts()
    selfplay.bit_step_auto_reset = checked_step
    try:
        t0 = time.perf_counter()
        _, sample = selfplay.selfplay_chunk(
            net, tbit.bit_reset(n, b, dev), gen, board_size=n, num_steps=steps,
            num_simulations=sims, temp_moves=SELFPLAY_TEMP_MOVES, dirichlet_alpha=0.3,
            dirichlet_frac=0.25)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        selfplay.bit_step_auto_reset = real_step
    launched_only("the recipe's chunk", required=("S1a", "S1b"))
    got = {k: int(v) for k, v in counts.items()}
    print(f"[recipe chunk] n={n} batch={b} chunk={steps} sims={sims} net {ch}x{blocks} bf16, "
          f"temp_moves={SELFPLAY_TEMP_MOVES}, Dirichlet 0.3/0.25: {got['moves']} moves, "
          f"{got['sampled']} sampled; illegal: {got['illegal_sampled']} sampled, "
          f"{got['illegal']} in all (0 required); finished frames "
          f"{int(sample.weight.sum())}; {secs} s [{card}]")
    require(got["sampled"] > 0 and got["moves"] == b * steps, "the chunk sampled its first plies")
    require(got["illegal"] == 0, f"no illegal action in the recipe's chunk: {got}")
    require(bool(torch.isfinite(sample.policy).all()), "finite policy targets")

    rec = json.loads(BF16_FIXTURE.read_text())
    t0 = time.perf_counter()
    step = cases.bf16_port_step(dev, torch.bfloat16)
    with no_tf32():
        f32 = cases.bf16_port_step(dev, torch.float32)
    failures = {f"metrics {dtype}": cases.metric_failures(s["metrics"], rec[dtype]["metrics"])
                for dtype, s in (("bf16", step), ("f32", f32))}
    for part in ("grads", "update"):
        errs = cases.bf16_errors(step, rec, part)
        # the leaves the tolerance reads one by one (an update's large ones)
        held = [k for k in errs if k != "all" and (
            part == "grads" or step[part][k].numel() >= cases.BIG_LEAF)]
        worst = max(held, key=lambda k: errs[k][0] / max(errs[k][1], 1e-12))
        print(f"[recipe bf16] {part}: the card's bf16 error to JAX's float32 step over all "
              f"leaves {errs['all'][0]} (JAX's bf16: {errs['all'][1]}; bound 1.25x); the leaf "
              f"furthest from JAX's ratio, {worst}: {errs[worst][0]} against {errs[worst][1]}")
        failures[part] = cases.bf16_failures(step, rec, part)
    f32_err = cases.rel_errors(f32["grads"], rec["f32"]["grads"])
    failures["f32 grads"] = [(k, e) for k, e in f32_err.items() if e > 2e-3]
    print(f"[recipe bf16] config-5 step on {rec['steps'] * rec['batch']} frames: bf16 loss "
          f"{step['metrics']['loss']} (JAX's bf16 {rec['bf16']['metrics']['loss']}), "
          f"value_loss {step['metrics']['value_loss']} ({rec['bf16']['metrics']['value_loss']}); "
          f"the float32 step's gradients within {max(f32_err.values())} of JAX's (bound 2e-3); "
          f"outside the tolerance: {failures}; {time.perf_counter() - t0} s [{card}]")
    require(not any(failures.values()), f"the bf16 step within JAX's bf16 error: {failures}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    t_mark = [t_start]

    def mark(phases: str) -> None:  # wall time of each group of phases
        now = time.perf_counter()
        print(f"[time] phases {phases}: {now - t_mark[0]} s")
        t_mark[0] = now

    build_all()
    sass = sass_counts()
    mark("1-2")
    bit = bitboard_path(dev, sass)
    tensor = tensor_path(dev, sass, bit["rates"])
    store = store_path(dev, bit["obs_bytes_per_s"])
    mark("3-10")
    net_ms = net_path(dev, card)
    layer_norm_equal_path(dev)
    s1 = search_kernels_path(dev, card)
    s2_launches = {"search 128x6": search_path(dev, card, net_ms)}
    arena_path(dev, card)
    mark("11-15")
    selfplay_equal_path(dev)
    train_equal_path(dev)
    s2_launches.update(selfplay_rate_path(dev, card))
    s2 = layer_norm_rate_path(dev, card, s2_launches)
    mark("16-18")
    with driver_arms(dev, card):
        driver_path(dev, card)
    mark("19 and 25")
    gumbel_equal_path(dev)
    arms_equal_path(dev)
    search_arms_rate_path(dev, card)
    arms_rate_path(dev, card)
    arena_arms_path(dev, card)
    mark("20-24")
    shared_rollout_path(dev, card, bit["reports"][0], bit["rates"][HEADLINE])
    mark("26 (a)")
    with dist_programs(dev, card):
        learned = shared_learner_path(dev, card)
    mark("26 (b)-(d) and 27's programs")
    nccl_world_of_one_path(dev, card)
    mark("27")
    host_path(dev, card)
    mark("28")
    launches = benches_path(dev, card, bit["rates"][HEADLINE])
    for report, k in zip([*bit["reports"], tensor], ("K1", "K2", "K3")):
        report["bench_launches"] = launches[k]
    mark("29")
    recipe_path(dev, card)
    mark("30")

    for report in s1:  # every comparison of the run, the fixtures' included
        # S1a is held both as the expansion and as step_bits (step_state)
        names = ("bit_step", "step_state") if report["name"] == "bit_step" else (report["name"],)
        report["max_abs_err"] = max(S1_ERRS[name][1] for name in names)
    report_s1_equal("every comparison of this run")
    print(f"[total] {time.perf_counter() - t_start} s from the build to here")
    print(json.dumps({"kernels": [*bit["reports"], tensor, store, *s1, *s2]}))
    require(learned["a_score"] >= cases.LEARN["bar"],
            f"the learn check: {learned['a_score']} against JAX's bar {cases.LEARN['bar']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
