"""Where a full-width PUCT search spends its time, on one CUDA card.

    python3 -m twixt_for_open_spiel_tpu_torch.profile_search [--simulations=64]
        [--backup=auto|amask|walk]

One ``search_batch`` at ``chip_smoke.py``'s search row (board 12, batch
512, 64 simulations, ``dirichlet_frac=0.25``, the untrained bf16 net at
create_net's full width; the flags change the simulations and the
backup) under ``torch.profiler`` with CPU and CUDA
activities, after a warm-up search and one search timed without the
profiler.  The search's parts are the program's own spans
(``utils/profiling.SPANS``), read from the profiler's events by
``profiling.SpanTrace``:

  search.root      the root's legal mask, evaluation, noise and tree
  search.select    the root entry and the selection walk (S1b,
                   ``op.select_walk``)
  search.expand    the expansion (S1a, ``op.bit_step``: the parent slot's
                   step, the child's legal mask and slot write)
  search.evaluate  the evaluator (observation and net) and the masked prior
  search.backup    the tree's writes and the backup (S1c under the walk
                   backup)

Prints the card's name and power limit; the search's wall time without and
with the profiler; per span its host time, the device time of the
activities launched under it and its calls; the device time linked to no
launch; the device's busy time (the union of activity intervals) and its
idle share of the profiled and of the unprofiled search; the idle gaps by
the innermost span; device activities per simulation and host reads
(``aten::_local_scalar_dense`` and device-to-host copies, each a sync) per
search; the device time and launches of each kernel class (``CLASSES``:
S2's LayerNorm kernels apart from any library LayerNorm, convolutions,
matrix products, casts, the rest); the ten kernels with the most device
time, each with the innermost span that launched it.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.utils import profiling

BOARD, BATCH = 12, 512
# kernel classes by name, the first match wins: S2's kernels
# (csrc/layer_norm.cu), then PyTorch's own LayerNorm kernels, should any run
CLASSES = (
    ("S2b layer_norm backward", ("layer_norm_backward_kernel", "layer_norm_param_grad_kernel")),
    ("S2a layer_norm forward", ("layer_norm_forward_kernel",)),
    ("library layer_norm backward", ("layer_norm_grad", "GammaBeta", "LayerNormBackward",
                                     "layer_norm_backward")),
    ("library layer_norm forward", ("layer_norm",)),
    ("conv backward", ("dgrad", "wgrad")),
    ("conv forward", ("fprop", "conv")),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("cast and copy", ("copy", "cast")),
)


def span_trace(prof) -> profiling.SpanTrace:
    return profiling.SpanTrace.from_events(prof.profiler.kineto_results.events())


def window(trace: profiling.SpanTrace) -> tuple:
    """From the first program span's start to the last span's or device
    activity's end, in ns."""
    start = min(s for _, s, _ in trace.spans)
    return start, max(e for _, _, e, *_ in trace.spans + trace.activities)


def busy_ms(trace: profiling.SpanTrace) -> float:
    """Union of the device activities' intervals, in ms."""
    return sum(e - s for s, e in trace.busy_intervals(*window(trace))) / 1e6


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


def print_spans(trace: profiling.SpanTrace, prefix: str) -> None:
    """Host and device ms and calls of each program span named ``prefix*``,
    the device ms linked to no launch, and the idle gaps by span."""
    for name in profiling.SPANS:
        if name.startswith(prefix) or name.startswith("op."):
            if trace.span_count(name):
                print(f"[profile] span {name}: host {trace.span_host_seconds(name) * 1e3} ms, "
                      f"device {trace.device_seconds_under(name) * 1e3} ms, "
                      f"calls {trace.span_count(name)}")
    print(f"[profile] device {trace.device_seconds() * 1e3} ms in all, "
          f"{trace.unlinked_seconds() * 1e3} ms linked to no launch")
    for name, sec in trace.idle_gaps(*window(trace))[:8]:
        print(f"[profile] idle under {name}: {sec * 1e3} ms")


def print_classes(trace: profiling.SpanTrace) -> None:
    """Device time and launches of each kernel class, the largest first."""
    by_class = {}
    for name, start, end, _ in trace.activities:
        label = kernel_class(name)
        total, count = by_class.get(label, (0.0, 0))
        by_class[label] = (total + (end - start) / 1e6, count + 1)
    for label, (ms, count) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] class {label}: device {ms} ms, launches {count}")


def print_kernels(trace: profiling.SpanTrace, k: int) -> None:
    """The ``k`` (launching span, kernel) pairs with the most device time."""
    for span, name, sec in trace.by_launching_span(k):
        print(f"[profile] kernel {name[:90]} under {span}: device {sec * 1e3} ms")


def profile_search(dev, sims: int = 64, backup: str = "auto") -> None:
    n, b = BOARD, BATCH
    net = create_net(n, device=dev)
    roots = tbit.bit_random_rollout(3, n, 24, tbit.bit_reset(n, b, dev))[0]
    evaluate = mcts.net_evaluator(call_net, n)
    gen = torch.Generator(device=dev).manual_seed(0)

    def search(evaluator):
        out = mcts.search_batch(net, roots, gen, evaluator=evaluator, board_size=n,
                                num_simulations=sims, dirichlet_frac=0.25, return_stats=True,
                                backup=backup)
        torch.cuda.synchronize()
        return out

    search(evaluate)  # warm-up
    t0 = time.perf_counter()
    search(evaluate)
    plain_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = search(evaluate)
        prof_ms = (time.perf_counter() - t0) * 1e3

    trace = span_trace(prof)
    busy = busy_ms(trace)
    print(f"[profile] search_batch n={n} batch={b} sims={sims} backup={backup}: wall "
          f"{plain_ms} ms unprofiled ({plain_ms / sims} ms a simulation), "
          f"{prof_ms} ms profiled; walks {stats}")
    print_spans(trace, "search.")
    print(f"[profile] device busy {busy} ms (union of activity intervals): idle share "
          f"{1 - busy / prof_ms} of the profiled search, {1 - busy / plain_ms} of the "
          f"unprofiled one; {len(trace.activities)} device activities = "
          f"{len(trace.activities) / sims} a simulation; "
          f"{trace.host_reads_under('search.')} host reads under search spans a search")
    print_classes(trace)
    print_kernels(trace, 10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--backup", default="auto", choices=("auto", "amask", "walk"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_search: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    profile_search(torch.device("cuda", 0), args.simulations, args.backup)
    return 0


if __name__ == "__main__":
    sys.exit(main())
