"""Where a full-width learner step spends its time, on one CUDA card.

    python3 -m twixt_for_open_spiel_tpu_torch.profile_train

One ``train_step`` at ``chip_smoke.py``'s train row (config 5: board 12,
the 16,384 frames of a 512-env, 32-step chunk, the 64-channel 4-block bf16
net, AdamW) under ``torch.profiler`` with CPU and CUDA activities, after a
warm-up step and one step timed without the profiler.  The chunk comes
from ``selfplay_chunk`` at 2 simulations: the step's shapes and work do
not depend on the targets' values.

Prints the card's name and power limit; the step's wall time without and
with the profiler; per program span (``train.forward``, ``train.backward``,
``train.optimizer``: ``utils/profiling.SPANS``) its host time, the device
time of the activities launched under it and its calls, and the idle gaps
by span; the device's busy time (the union of activity intervals)
and idle share; the device time and launches of each kernel class
(``profile_search.CLASSES``: S2's LayerNorm forward and backward, any
library LayerNorm, convolutions forward and backward, matrix products,
dtype casts and copies, the optimizer's fused loops, the rest);
and the fifteen kernels with the most device time, each with the span
that launched it.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from twixt_for_open_spiel_tpu_torch.models.network import create_net
from twixt_for_open_spiel_tpu_torch.models.selfplay import (
    make_optimizer,
    selfplay_chunk,
    train_step,
)
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.profile_search import (
    busy_ms,
    print_classes,
    print_kernels,
    print_spans,
    span_trace,
)

ROW = (12, 512, 32, 64, 4)  # board, batch, chunk steps, channels, blocks


def profile_train(dev) -> None:
    n, b, steps, ch, blocks = ROW
    net = create_net(n, ch, blocks, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, sample = selfplay_chunk(net, tbit.bit_reset(n, b, dev), gen, board_size=n,
                               num_steps=steps, num_simulations=2, temp_moves=16)
    opt = make_optimizer(net.parameters(), 1e-3)

    def step():
        train_step(net, opt, sample)
        torch.cuda.synchronize()

    step()  # warm-up
    t0 = time.perf_counter()
    step()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        prof_ms = (time.perf_counter() - t0) * 1e3

    trace = span_trace(prof)
    busy = busy_ms(trace)
    print(f"[profile] train_step n={n} frames={steps * b} net {ch}x{blocks} bf16: wall "
          f"{plain_ms} ms unprofiled, {prof_ms} ms profiled; device busy {busy} ms (union of "
          f"activity intervals): idle share {1 - busy / prof_ms} of the profiled step, "
          f"{1 - busy / plain_ms} of the unprofiled one; {len(trace.activities)} device "
          f"activities")
    print_spans(trace, "train.")
    print_classes(trace)
    print_kernels(trace, 15)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    profile_train(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
