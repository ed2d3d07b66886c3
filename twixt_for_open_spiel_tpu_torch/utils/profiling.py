"""Tracing / profiling helpers (``twixt_for_open_spiel_tpu/utils/profiling.py``,
on ``torch.profiler`` where JAX's use ``jax.profiler``).

Steps/s counters that wait for the card, a trace of a region written for
TensorBoard (and Chrome's trace viewer), and named spans in that trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree`` (a tensor,
    or tuples and lists of them, as a ``BitState``)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            _synchronize(leaf)


class Throughput:
    """Steps/s counter; ``rate(sync=...)`` waits for the work that made
    ``sync`` first, as ``jax.block_until_ready`` does."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        return self

    def add(self, n: int):
        self.steps += n

    def rate(self, sync=None) -> float:
        if sync is not None:
            _synchronize(sync)
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the host and, when there is a
    card, the device, written into ``log_dir`` as ``*.pt.trace.json``
    (TensorBoard's profiler format) when ``log_dir`` is set."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield
