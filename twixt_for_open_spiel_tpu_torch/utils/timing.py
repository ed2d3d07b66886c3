"""Two timers of a short call on the card, with CUDA events.

  device_ms        the card's time a call, the calls enqueued behind a spin
                   kernel so that the card runs them back to back
  back_to_back_ms  ms a call, calls enqueued back to back by the host, so
                   that a call's host time shows where it outlasts the card's

Imports torch only: ``bench_bit_step`` loads this file by its path into a
worker that imports another checkout's package.
"""

from __future__ import annotations

import time

import torch

# the H100's boost clock: the spin kernel's (``torch.cuda._sleep``) cycles a
# second
CLOCK_HZ = 1.98e9


def device_ms(fn, reps: int) -> float:
    """The card's time a call of ``fn``: CUDA events around ``reps`` calls
    enqueued behind a spin kernel (``torch.cuda._sleep``) that outlasts
    the host's enqueue, so that the card runs them back to back without
    waiting on the host.  The gaps between launches count, and so do the
    writes a launch leaves to drain from L2 into the next one, as in a
    net's run; torch.profiler's kernel intervals leave both out (by them a
    ``clone`` of 256 MiB read 5.0 TB/s on an H100 80GB HBM3)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t  # at least the host's enqueue of reps calls
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * enqueue_s * CLOCK_HZ) + 100_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def back_to_back_ms(fn, reps: int, runs: int = 5) -> list:
    """Milliseconds a call of ``fn`` in each of ``runs`` runs of ``reps``
    calls back to back between one pair of CUDA events: the host enqueues
    the next call while the card runs one, so a short kernel's time is not
    the wrapper's host time."""
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out
