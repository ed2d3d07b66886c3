"""Where a full-width PUCT search spends its time, on one CUDA card.

    python3 -m twixt_for_open_spiel_tpu_torch.profile_search [--simulations=64]
        [--backup=auto|amask|walk]

One ``search_batch`` at ``chip_smoke.py``'s search row (board 12, batch
512, 64 simulations, ``dirichlet_frac=0.25``, the untrained bf16 net at
create_net's full width; the flags change the simulations and the
backup) under ``torch.profiler`` with CPU and CUDA
activities, after a warm-up search and one search timed without the
profiler.  The search's parts are labelled by wrapping, for the profiled
call only, the functions ``models/mcts.py`` calls:

  select     ``select_walk`` (the PUCT root entry and the selection below
             it, S1b)
  expand     ``bit_step`` (the parent slot's step, the child's legal mask
             and its slot write, S1a)
  evaluate   the evaluator: observation and net
  prior      ``masked_policy``
  backup     ``backup_walk`` (S1c; the walk backup only)

Prints the card's name and power limit; the search's wall time without and
with the profiler; per label its host time, the device time of the kernels
launched under it and its calls; the device's busy time (the union of
kernel intervals) and its idle share of the profiled and of the unprofiled
search; device activities and host reads (``aten::_local_scalar_dense``,
each a sync) per simulation; the device time and launches of each kernel
class (``CLASSES``: S2's LayerNorm kernels apart from any library
LayerNorm, convolutions, matrix products, casts, the rest); the ten
kernels with the most device time.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

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
LABELS = {"select": "select_walk", "expand": "bit_step", "prior": "masked_policy",
          "backup": "backup_walk"}


def _labelled(label, fn):
    def wrapped(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def labelled_search():
    """The mcts module's callees wrapped in profiler labels, for the block."""
    saved = {name: getattr(mcts, name) for name in LABELS.values()}
    try:
        for label, name in LABELS.items():
            setattr(mcts, name, _labelled(label, saved[name]))
        yield
    finally:
        for name, fn in saved.items():
            setattr(mcts, name, fn)


def _device_us(event) -> float:
    """Device time of the kernels an op (and the ops under it) launched."""
    us = getattr(event, "device_time_total", None)
    return us if us is not None else event.cuda_time_total


def _busy_ms(kernels) -> float:
    """Union of the kernels' [start, end) intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


def print_classes(kernels) -> None:
    """Device time and launches of each kernel class, the largest first."""
    by_class = {}
    for k in kernels:
        label = kernel_class(k.name)
        total, count = by_class.get(label, (0.0, 0))
        by_class[label] = (total + k.time_range.elapsed_us(), count + 1)
    for label, (us, count) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] class {label}: device {us / 1e3} ms, launches {count}")


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

    with labelled_search(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = search(_labelled("evaluate", evaluate))
        prof_ms = (time.perf_counter() - t0) * 1e3

    labels = ("select", "expand", "evaluate", "prior", "backup")
    events = prof.events()
    # device activities, without the labels' own ranges on the device timeline
    kernels = [e for e in events if e.device_type.name == "CUDA" and e.name not in labels
               and not getattr(e, "is_user_annotation", False)]
    reads = sum(e.name == "aten::_local_scalar_dense" for e in events)
    busy = _busy_ms(kernels)
    print(f"[profile] search_batch n={n} batch={b} sims={sims} backup={backup}: wall "
          f"{plain_ms} ms unprofiled ({plain_ms / sims} ms a simulation), "
          f"{prof_ms} ms profiled; walks {stats}")
    for label in labels:
        spans = [e for e in events if e.device_type.name == "CPU" and e.name == label]
        host = sum(e.cpu_time_total for e in spans) / 1e3
        device = sum(_device_us(e) for e in spans) / 1e3
        print(f"[profile] {label}: host {host} ms, device {device} ms, calls {len(spans)}")
    print(f"[profile] device busy {busy} ms (union of kernel intervals): idle share "
          f"{1 - busy / prof_ms} of the profiled search, {1 - busy / plain_ms} of the "
          f"unprofiled one; {len(kernels)} device activities = {len(kernels) / sims} a "
          f"simulation; {reads} host reads = {reads / sims} a simulation")
    print_classes(kernels)
    by_name = {}
    for k in kernels:
        total, count = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (total + k.time_range.elapsed_us(), count + 1)
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[profile] kernel {name[:90]}: device {us / 1e3} ms, launches {count}")


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
