"""The port's benchmark (the root ``bench.py``, ported): batched
random-rollout env throughput on one card.

    python3 -m twixt_for_open_spiel_tpu_torch.bench           # on the card
    python3 -m twixt_for_open_spiel_tpu_torch.bench --quick   # tiny, the CPU

Rows (stderr), ``bench.py``'s rows and seeds:

  * the rollout rows through K1 (``ops/fused_bit_rollout.py``): board 5 at
    batch 256, boards 8 (the headline), 12 and 24 at batch 4096, 1000
    steps a launch, 300/60/60/30 launches, launch i from ``bit_reset`` with
    seed i (1..reps), after a warm-up launch with seed 0;
  * config 4, packed: K2 (``emit_obs=True``) at board 24, batch 8192, 256
    launches of 16 steps, the state carried from launch to launch, launch i
    with seed i.  The wire is K2's ``[T, 12, P, B]`` int32; the JAX bench
    times its own layout, ``[T, B, 12*P]`` u32, which holds the same words;
  * config 4, bf16: the same launches (64 of them), each K2's wire decoded
    by ``ops/observe.py``'s ``unpack_observation_lanes_nchw`` into the
    bfloat16 ``[T, B, 12, n, n-2]`` tensor inside the timed launch, as the
    JAX row writes that tensor as a forced output.

Each launch is timed alone between two CUDA events.  A row's rate is all
its timed launches' env-steps over the sum of their times, so a slow launch
moves it; the row also prints the median and the min-max of a launch, its
episodes, and how many times it launched K1 and K2 (the wrapper's counters
``fused_bit_rollout.launches`` and ``.obs_launches``).  On the CPU
(``--quick``) the wrapper runs its plain version and a host clock times
it.  Then, for context, the plain version at the headline over
``PLAIN_STEPS`` steps on the same device, and the C engine
(``native/engine.py``'s ``random_games``, board 8, one host core: the
reference's own single-threaded form of the game), timed in the same run.

Prints exactly one JSON line on stdout, the JAX bench's keys and metric:
``{"metric": ..., "value": N, "unit": "env-steps/s", "vs_baseline": N}``.
``value`` is the headline row's rate in env-steps/s and ``vs_baseline``
that value over the C engine's moves a second.

``--quick`` runs the JAX bench's CPU branch (20 steps, 3 launches a
rollout row, the obs rows at batch 64 with 4-step launches, 2 of them)
through the plain versions.  Without a CUDA device and without ``--quick``
the program exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.native.engine import random_games
from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset
from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import (
    fused_bit_rollout,
    fused_bit_rollout_reference,
)
from twixt_for_open_spiel_tpu_torch.ops.observe import unpack_observation_lanes_nchw

METRIC = "env-steps/s per chip, twixt board_size=8, batch=4096 lockstep random rollouts"
HEADLINE = (8, 4096)  # board, batch
# (board, batch, launches) at STEPS a launch; then (board, batch, chunk,
# launches, packed) for the config-4 rows (bench.py:180-197)
FULL = {
    "steps": 1000,
    "rollout": [(5, 256, 300), (8, 4096, 60), (12, 4096, 60), (24, 4096, 30)],
    "obs": [(24, 8192, 16, 256, True), (24, 8192, 16, 64, False)],
}
QUICK = {
    "steps": 20,
    "rollout": [(5, 256, 3), (8, 4096, 3), (12, 4096, 3), (24, 4096, 3)],
    "obs": [(24, 64, 4, 2, True), (24, 64, 4, 2, False)],
}
PLAIN_STEPS = 50  # the plain version's context row at the headline
C_BOARD, C_GAMES, C_SECONDS = 8, 1000, 1.0  # the C engine: games a call, seconds in all


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="the JAX bench's CPU rows, through the plain versions")
    args = ap.parse_args(argv)
    if not args.quick and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def launch_ms(fn, device: torch.device):
    """(milliseconds, result) of one call of ``fn``: by CUDA events on the
    card, by the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def warm_then_time(fn, device, reps: int):
    """(milliseconds of each of ``reps`` timed calls of ``fn`` after one
    warm-up call, the last call's result)."""
    fn()
    out, ms = None, []
    for _ in range(reps):
        t, out = launch_ms(fn, device)
        ms.append(t)
    return ms, out


def launch_counts() -> tuple:
    """(K1, K2) launches so far, from the wrapper's counters."""
    obs = fused_bit_rollout.obs_launches
    return fused_bit_rollout.launches - obs, obs


@contextlib.contextmanager
def counted(device: torch.device, row: dict):
    """Put the K1 and K2 launches made inside into ``row``; on the card,
    raise unless the row launched a kernel (no quiet plain path)."""
    k1, k2 = launch_counts()
    yield
    k1_, k2_ = launch_counts()
    row["k1_launches"], row["k2_launches"] = k1_ - k1, k2_ - k2
    if device.type == "cuda" and not k1_ - k1 + k2_ - k2:
        raise RuntimeError("a row on the card launched no kernel")


def rate(row: dict, env_steps: int) -> float:
    """Env-steps a second over all of ``row``'s timed launches, each of
    ``env_steps``."""
    return env_steps * len(row["ms"]) / sum(row["ms"]) * 1e3


def spread(row: dict) -> str:
    ms = row["ms"]
    return (f"over the summed time of {len(ms)} launches; a launch: median "
            f"{statistics.median(ms)} ms, min-max {min(ms)}-{max(ms)} ms; K1 launches "
            f"{row['k1_launches']}, K2 launches {row['k2_launches']}")


def rollout_row(board_size: int, batch: int, steps: int, reps: int, device) -> dict:
    """One rollout row: ``reps`` launches of ``steps`` steps from the initial
    state, seeds 1..reps.  Returns the row with the last launch's final
    state and stats."""
    device = torch.device(device)
    state = bit_reset(board_size, batch, device)
    row = {"ms": []}
    with counted(device, row):
        fused_bit_rollout(0, board_size, steps, state)  # warm-up
        for i in range(reps):
            ms, (row["final"], row["stats"]) = launch_ms(
                lambda: fused_bit_rollout(i + 1, board_size, steps, state), device)
            row["ms"].append(ms)
    row["rate"] = rate(row, batch * steps)
    path = "K1" if device.type == "cuda" else "plain"
    print(f"[bench] n={board_size} batch={batch} steps={steps} obs=False path={path} -> "
          f"{row['rate']} env-steps/s ({spread(row)}; episodes/rep "
          f"{int(row['stats']['episodes'])})", file=sys.stderr)
    return row


def obs_row(board_size: int, batch: int, chunk: int, launches: int, packed: bool,
            device) -> dict:
    """One config-4 row: ``launches`` launches of ``chunk`` steps emitting
    every step's observation, the state carried over, seeds 1..launches.
    ``packed``: K2's wire, int32 ``[T, 12, P, B]``; else that wire decoded
    into the bfloat16 ``[T, B, 12, n, n-2]`` tensor in each launch.
    Returns the row with the final state and the last launch's output."""
    device = torch.device(device)
    n = board_size

    def launch(seed, st):
        st, stats, wire = fused_bit_rollout(seed, n, chunk, st, emit_obs=True)
        obs = wire if packed else unpack_observation_lanes_nchw(wire, n, torch.bfloat16)
        return st, stats, obs

    state = bit_reset(n, batch, device)
    row = {"ms": [], "episodes": 0}
    with counted(device, row):
        launch(0, state)  # warm-up
        for i in range(launches):
            ms, (state, stats, row["obs"]) = launch_ms(lambda: launch(i + 1, state), device)
            row["ms"].append(ms)
            row["episodes"] += int(stats["episodes"])
    row["final"] = state
    row["rate"] = rate(row, batch * chunk)
    fmt = ("packed int32 [T,12,P,B], K2's layout (JAX: [T,B,12P] u32)" if packed
           else "bf16 [T,B,12,n,n-2], decoded from K2's wire")
    path = "K2" if device.type == "cuda" else "plain"
    print(f"[bench] n={n} batch={batch} steps={chunk * launches} obs=PER-STEP ({fmt}, "
          f"written every launch) path={path} -> {row['rate']} env-steps/s ({spread(row)}; "
          f"{chunk} steps a launch; episodes {row['episodes']})", file=sys.stderr)
    return row


def plain_rate(device, steps: int = PLAIN_STEPS) -> float:
    """The plain version's env-steps/s at the headline over ``steps`` steps
    on ``device`` (context only)."""
    device = torch.device(device)
    n, batch = HEADLINE
    state = bit_reset(n, batch, device)
    fused_bit_rollout_reference(0, n, 1, state)  # warm-up
    ms, _ = launch_ms(lambda: fused_bit_rollout_reference(1, n, steps, state), device)
    rate = batch * steps / ms * 1e3
    print(f"[bench] plain n={n} batch={batch} steps={steps} on {device.type} -> {rate} "
          f"env-steps/s ({ms} ms)", file=sys.stderr)
    return rate


def c_engine_rate(seconds: float = C_SECONDS) -> float:
    """Moves a second of the C engine's full random games at board
    ``C_BOARD`` on one host core, over calls of ``C_GAMES`` games until
    ``seconds`` have passed."""
    random_games(C_BOARD, 0, 1)  # build and load
    moves, calls = 0, 0
    t0 = time.perf_counter()
    while True:
        calls += 1
        moves += random_games(C_BOARD, calls * C_GAMES, C_GAMES)[0]
        secs = time.perf_counter() - t0
        if secs >= seconds:
            break
    rate = moves / secs
    print(f"[bench] C engine: n={C_BOARD} {calls * C_GAMES} random games, {moves} moves in "
          f"{secs} s, one host core -> c_rate {rate!r} env-steps/s", file=sys.stderr)
    return rate


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


def run(quick: bool) -> dict:
    """Every row, the context rows and the JSON record; returns them."""
    device = torch.device("cpu" if quick else "cuda")
    cfg = QUICK if quick else FULL
    where = card_line() if not quick else "cpu"
    print(f"[bench] device={device} ({where}) torch {torch.__version__}", file=sys.stderr)
    rows = {}
    for n, batch, reps in cfg["rollout"]:
        rows[(n, batch)] = rollout_row(n, batch, cfg["steps"], reps, device)
    for n, batch, chunk, launches, packed in cfg["obs"]:
        rows["packed" if packed else "bf16"] = obs_row(n, batch, chunk, launches, packed,
                                                       device)
    plain_rate(device)
    c_rate = c_engine_rate(C_SECONDS / 10 if quick else C_SECONDS)
    k1, k2 = launch_counts()
    print(f"[bench] kernel launches: K1 {k1}, K2 {k2}", file=sys.stderr)
    headline = rows[HEADLINE]["rate"]
    record = {
        "metric": METRIC,
        "value": round(headline),
        "unit": "env-steps/s",
        "vs_baseline": round(headline / c_rate, 3),
    }
    return {"rows": rows, "c_rate": c_rate, "record": record}


def main(argv=None) -> int:
    args = parse_args(argv)
    print(json.dumps(run(args.quick)["record"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
