"""Where K2's learner wire spends its time, on one CUDA card.

    python3 -m twixt_for_open_spiel_tpu_torch.profile_wire

K2 (``fused_bit_rollout(..., emit_obs=True)``) at the benchmark's wire
shape (board 24, 8,192 envs, 16 steps a launch), each launch from the last
one's state as the learner feed chains them: 20 warm-up launches, 200
timed without the profiler, then as many under ``torch.profiler`` with
CPU and CUDA activities.  The wrapper is the
program's span ``op.fused_bit_rollout`` (``utils/profiling.SPANS``), read
from the profiler's events by ``profiling.SpanTrace``.

Prints the card's name and power limit; the wall time a launch without and
with the profiler; the span's host time a launch (the wrapper's, from its
entry to its return), the device time launched under it and its calls; the
device time linked to no launch; the device's busy time (the union of
activity intervals) and idle share; the idle gaps by span; and the kernels
with the most device time, each with the span that launched it.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset
from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import fused_bit_rollout
from twixt_for_open_spiel_tpu_torch.profile_search import (
    busy_ms,
    print_kernels,
    print_spans,
    span_trace,
)

SHAPE = (24, 8192, 16)  # board, envs, steps a launch
WARMUP, LAUNCHES = 20, 200
SPAN = "op.fused_bit_rollout"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_wire(dev, launches: int = LAUNCHES, shape=SHAPE, warmup: int = WARMUP) -> None:
    n, batch, steps = shape
    state = bit_reset(n, batch, dev)
    seed = 0

    def run(count):
        nonlocal state, seed
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(count):
            state = fused_bit_rollout(seed, n, steps, state, emit_obs=True)[0]
            seed += 1
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3

    run(warmup)
    plain_ms = run(launches)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        prof_ms = run(launches)

    trace = span_trace(prof)
    calls = trace.span_count(SPAN)
    busy = busy_ms(trace)
    print(f"[profile] fused_bit_rollout emit_obs n={n} envs={batch} steps={steps}, "
          f"{launches} chained launches: wall {plain_ms / launches} ms a launch unprofiled, "
          f"{prof_ms / launches} ms profiled; {SPAN} host "
          f"{trace.span_host_seconds(SPAN) / max(calls, 1) * 1e6} us a call")
    print_spans(trace, "op.")
    print(f"[profile] device busy {busy} ms (union of activity intervals): idle share "
          f"{1 - busy / prof_ms} of the profiled launches; {len(trace.activities)} device "
          f"activities = {len(trace.activities) / launches} a launch")
    print_kernels(trace, 8)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_wire: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    profile_wire(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
