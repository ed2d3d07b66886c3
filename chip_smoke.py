"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Three paths, each with its kernel's launch count set to 0 just before the
path and read just after (launches made to compare a kernel with its plain
version come before and do not count).  Any failure ends the run with a
non-zero exit.

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from ``twixt_for_open_spiel_tpu_torch/csrc``
     with nvcc for sm_90a, one nvcc per source, all at once, and print the
     build time and nvcc's register report; read each rollout kernel's
     SASS (``cuobjdump -sass``) and count the fewest instructions, per
     class, that a step, a cell of K3's draw and a row of K2's obs stream
     issue (``ops/_sass.py``), for the bounds;

  the bitboard rollout (K1, K2: ``fused_bit_rollout``):
  3. the kernel is bit-equal to its plain torch version, on the card, in
     every state leaf, ``episodes``, ``results`` and the ``obs`` stream;
  4. the JAX anchor: the kernel's final-state digests equal those of the JAX
     engine in ``tests/fixtures/torch_port_rollout_digests.json``;
  5. throughput at the benchmark's rollout rows and the obs row, by CUDA
     events, and of the plain version at the headline size;

  the canonical-engine rollout (K3: ``fused_random_rollout``):
  6. the kernel is bit-equal to its plain version in every state leaf,
     ``actions`` and ``results``, full width (board 24, batch 4096) and a
     second tile included; a batch that is no multiple of the tile raises;
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
      (``expand().contiguous()``) of the same output.

The second-to-last line is a JSON object describing the kernels, each with
its time, its plain version's time and its bound (the least time the card
could take: bytes over 3.35 TB/s or the SASS-counted instructions over
the issue rates, the larger); the last is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits non-zero and prints no result.  It imports no jax.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.ops import _cuda, _sass
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr
from twixt_for_open_spiel_tpu_torch.ops import fused_tensor_rollout as ftr
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll
from twixt_for_open_spiel_tpu_torch.ops import state as tstate
from twixt_for_open_spiel_tpu_torch.ops import store_skeleton as sk

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_rollout_digests.json"
TENSOR_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_tensor_rollout_digests.json"
KERNELS = ("fused_bit_rollout", "fused_tensor_rollout", "store_skeleton")
CSRC = "twixt_for_open_spiel_tpu_torch/csrc/"

# The card's published peaks (H100 SXM, NVIDIA's data sheet): 3.35 TB/s of
# HBM; 132 SMs at the 1.98 GHz boost clock.  The issue rates per SM and
# clock of each instruction class are in ops/_sass.py.
HBM_BYTES_PER_S = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9

# --- the bitboard rollout (K1, K2) ------------------------------------------
# (board_size, batch, num_steps, seed, emit_obs): kernel vs plain version
EQUALITY_CASES = [
    (5, 256, 60, 3, False),
    (8, 4096, 256, 0, False),
    (12, 4096, 128, 7, False),
    (24, 4096, 64, 0, False),
    (8, 1000, 100, 13, False),  # ragged: no multiple of the block
    (24, 8192, 16, 5, True),
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
]
TENSOR_TILE = 256
ROLLOUT_ROW = (12, 4096, 8)  # random_rollout: board, batch, steps

# --- the store-stream probe (K4): the obs stream's shape at board 24 --------
# rows = 12 planes * P words, steps = the obs row's steps per launch, and
# grid * subl * lanes = its batch, one program per 256-env block as in K2
STORE_SHAPE = (12 * 30, 16, 2, 128, 32)  # rows, steps, subl, lanes, grid
STORE_REPS = 20


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


def sass_counts() -> dict:
    """Per-class instruction counts, from the SASS of the built rollout
    kernels, of the fewest a thread can issue for (see ops/_sass.py):

      K1 step        one step, every inner loop passed at most once;
      K2 step        the same through the obs loop, and K2 obs row one
                     more pass of it (one padded row, 12 stores);
      K3 step        one step, every inner loop passed at most once;
      K3 cell        one cell of the draw's P*P scan, not legal;
      K3 legal cell  one legal cell (the hash, the two logf, the compare).
    """
    def is_store(instr) -> bool:
        return instr.base == "STG"

    def is_hash(instr) -> bool:  # hash_u32's first multiplier
        return 0x7FEB352D in instr.immediates()

    bit = _sass.Cfg(_sass.parse(_sass.kernel_sass("fused_bit_rollout")))
    obs = bit.innermost_loop(is_store, at_least=12)
    require(sum(map(is_store, (i for b in obs.body for i in bit.instructions(b)))) == 12,
            "K2's obs loop stores one row of 12 planes a pass")
    ten = _sass.Cfg(_sass.parse(_sass.kernel_sass("fused_tensor_rollout")))
    draw = ten.innermost_loop(is_hash)
    hashes = ten.blocks_with(is_hash, draw.body)
    require(len(hashes) == 1 and sum(map(is_hash, ten.instructions(hashes[0]))) == 1,
            "K3's draw loop hashes one cell a pass")
    counts = {
        "K1 step": bit.iteration(bit.largest_loop()),
        "K2 step": bit.iteration(bit.largest_loop(), via=obs.header),
        "K2 obs row": bit.iteration(obs),
        "K3 step": ten.iteration(ten.largest_loop()),
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
    plus P-1 more passes of the obs loop (one a padded row)."""
    p = n + 2 * geo.PAD
    nbytes = 2 * bit_state_bytes(n, batch) + 5 * 4 * batch
    per_step = sass["K1 step"]
    if obs:
        nbytes += steps * batch * 12 * p * 4
        per_step = combine((1, sass["K2 step"]), (p - 1, sass["K2 obs row"]))
    return bound(nbytes, combine((steps * batch, per_step)))


def tensor_rollout_bound(sass: dict, n: int, batch: int, steps: int, legal_cells: int):
    """K3: the kernel's int32 state ([7,P,P,B] cells, [5,B] scalars) read
    and written once, actions and results written once.  Per env-step the
    SASS count of one step and of P*P-1 more cells of the draw's scan (the
    step's count may hold one); per legal cell drawn (``legal_cells``,
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
    t0 = time.perf_counter()
    _cuda.build(*KERNELS)
    print(f"[build] nvcc sm_90a, {len(KERNELS)} sources in parallel: "
          f"{time.perf_counter() - t0:.3f} s")
    for name in KERNELS:
        for line in (_cuda.BUILD / f"lib{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def bitboard_path(dev, sass: dict) -> dict:
    """Phases 3-5: K1/K2 against the plain version, the JAX anchor, rates."""
    max_err = 0
    for n, b, steps, seed, emit in EQUALITY_CASES:
        bs = tbit.bit_reset(n, b, dev)
        got = fbr.fused_bit_rollout(seed, n, steps, bs, emit_obs=emit)
        torch.cuda.synchronize()
        want = fbr.fused_bit_rollout_reference(seed, n, steps, bs, emit_obs=emit)
        err = max_abs_diff(bit_pairs(got, want))
        max_err = max(max_err, err)
        episodes = int(got[1]["episodes"])
        print(f"[K1 equal] n={n} batch={b} steps={steps} seed={seed} "
              f"emit_obs={emit}: max_abs_err={err} episodes={episodes}")
        require(err == 0, f"K1 kernel != plain at n={n} batch={b}")
        require(int(got[1]["results"].sum()) == episodes, "results sum to episodes")

    # the main path from here on: count only its launches
    fbr.fused_bit_rollout.launches = ftr.fused_random_rollout.launches = 0
    sk.store_skeleton.launches = 0

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
        print(f"[K1 rate] n={n} batch={b} steps={RATE_STEPS} blocks={-(-b // 256)}: "
              f"median {med} ms of {ms} -> {b * RATE_STEPS / med * 1e3} env-steps/s; "
              f"bound {bound_ms} ms ({by})")
    n, b, chunk, launches = OBS_ROW
    state = [tbit.bit_reset(n, b, dev)]

    def run_obs():
        for _ in range(launches):
            state[0], _, obs = fbr.fused_bit_rollout(0, n, chunk, state[0], emit_obs=True)
            require(obs.shape == (chunk, 12, n + 6, b), "obs shape")

    before = fbr.fused_bit_rollout.launches
    fbr.fused_bit_rollout(0, n, chunk, state[0], emit_obs=True)  # warm-up
    (obs_ms,) = timed_ms(run_obs, 1)
    obs_bytes = launches * chunk * b * 12 * (n + 6) * 4
    one_ms, by = bit_rollout_bound(sass, n, b, chunk, obs=True)
    print(f"[K2 rate] emit_obs n={n} batch={b} {launches}x{chunk} steps: {obs_ms} ms -> "
          f"{b * chunk * launches / obs_ms * 1e3} env-steps/s, obs stream "
          f"{obs_bytes / obs_ms / 1e6} GB/s; bound {one_ms * launches} ms ({by}); "
          f"{fbr.fused_bit_rollout.launches - before} emit_obs launches")

    launches_main = fbr.fused_bit_rollout.launches
    require(launches_main > 0, "the bitboard path launched its kernel")
    require(ftr.fused_random_rollout.launches == sk.store_skeleton.launches == 0,
            "the bitboard path launched only its own kernel")

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
    return {
        "report": {
            "name": "fused_bit_rollout",
            "route": "cuda",
            "source": CSRC + "fused_bit_rollout.cu",
            "replaces": "twixt_for_open_spiel_tpu/ops/fused_bit_rollout.py:436",
            "launches": launches_main,
            "max_abs_err": max_err,
            "ms": rates[HEADLINE],
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": by,
            "library_ms": None,
        },
        "obs_bytes_per_s": obs_bytes / obs_ms * 1e3,
    }


def tensor_path(dev, sass: dict) -> dict:
    """Phases 6-9: K3 against the plain version, the JAX anchor, the replay,
    rates and the plain random_rollout."""
    max_err = 0
    for n, b, steps, seed, tile in TENSOR_EQUALITY_CASES:
        s0 = troll.batch_reset(n, b, dev)
        got = ftr.fused_random_rollout(seed, n, steps, s0, tile=tile)
        torch.cuda.synchronize()
        want = ftr.fused_random_rollout_reference(seed, n, steps, s0, tile=tile)
        err = max_abs_diff(tensor_pairs(got, want))
        max_err = max(max_err, err)
        episodes = int(ftr.rollout_stats(got[2])["episodes"])
        print(f"[K3 equal] n={n} batch={b} steps={steps} seed={seed} tile={tile}: "
              f"max_abs_err={err} episodes={episodes}")
        require(err == 0, f"K3 kernel != plain at n={n} batch={b} tile={tile}")
    try:
        ftr.fused_random_rollout(0, 8, 4, troll.batch_reset(8, 4096 + 64, dev))
    except ValueError as e:
        print(f"[K3 equal] batch 4160, tile 256 raises: {e}")
    else:
        raise RuntimeError("check failed: a batch that is no multiple of the tile ran")

    # the main path from here on: count only its launches
    fbr.fused_bit_rollout.launches = ftr.fused_random_rollout.launches = 0
    sk.store_skeleton.launches = 0

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
        print(f"[K3 rate] n={n} batch={b} steps={RATE_STEPS} tile={TENSOR_TILE}: "
              f"median {rates[(n, b)]} ms of {ms} -> "
              f"{b * RATE_STEPS / rates[(n, b)] * 1e3} env-steps/s")

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
    require(fbr.fused_bit_rollout.launches == sk.store_skeleton.launches == 0,
            "the canonical-engine path launched only its own kernel")

    n, b = HEADLINE
    s0 = troll.batch_reset(n, b, dev)
    ftr.fused_random_rollout_reference(0, n, 10, s0, tile=TENSOR_TILE)  # warm-up
    (plain_ms,) = timed_ms(
        lambda: ftr.fused_random_rollout_reference(0, n, RATE_STEPS, s0, tile=TENSOR_TILE), 1
    )
    print(f"[K3 rate] plain n={n} batch={b} steps={RATE_STEPS}: {plain_ms} ms -> "
          f"{b * RATE_STEPS / plain_ms * 1e3} env-steps/s")
    bound_ms, by = tensor_rollout_bound(sass, n, b, RATE_STEPS, legal_cells)
    print(f"[K3 bound] n={n} batch={b} steps={RATE_STEPS}: {bound_ms} ms ({by})")
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

    # the main path from here on: count only its launches
    fbr.fused_bit_rollout.launches = ftr.fused_random_rollout.launches = 0
    sk.store_skeleton.launches = 0
    last = [sk.store_skeleton(*STORE_SHAPE, device=dev)]  # warm-up

    def run():
        last[0] = sk.store_skeleton(*STORE_SHAPE, device=dev)

    ms = statistics.median(timed_ms(run, STORE_REPS))
    require(torch.equal(last[0], want), "K4's timed output equals the plain version's")
    launches_main = sk.store_skeleton.launches
    require(launches_main > 0, "the probe path launched its kernel")
    require(fbr.fused_bit_rollout.launches == ftr.fused_random_rollout.launches == 0,
            "the probe path launched only its own kernel")

    sk.store_skeleton_reference(*STORE_SHAPE, device=dev)  # warm-up
    plain_ms = statistics.median(timed_ms(
        lambda: sk.store_skeleton_reference(*STORE_SHAPE, device=dev), STORE_REPS))
    # the library call: PyTorch's broadcast copy of the k+j column
    column = want[:, :1, :1].clone()
    require(torch.equal(column.expand(want.shape).contiguous(), want), "the library copy")
    library_ms = statistics.median(timed_ms(
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
          f"bound {bound_ms} ms ({by})")
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

    build_all()
    sass = sass_counts()
    bit = bitboard_path(dev, sass)
    tensor = tensor_path(dev, sass)
    store = store_path(dev, bit["obs_bytes_per_s"])

    print(json.dumps({"kernels": [bit["report"], tensor, store]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
