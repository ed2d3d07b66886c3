"""Tracing / profiling helpers (``twixt_for_open_spiel_tpu/utils/profiling.py``,
on ``torch.profiler`` where JAX's use ``jax.profiler``).

Steps/s counters that wait for the card, a trace of a region written for
TensorBoard (and Chrome's trace viewer), the program's named spans in that
trace, and a profiler's events read by those spans (``SpanTrace``).

``annotate(name)`` is the package's one span helper.  A span is a
``record_function`` range only while a ``torch.profiler`` records, and
otherwise the shared no-op context, one C call a span: spans are on
exactly while a profiler is.  ``SPANS`` names every span the package
opens, at the boundaries of its layers (code outside the package, as
``chip_smoke.py``, may open spans of its own, which ``SpanTrace`` does not
read):

  search.root      a search's root: legal mask, evaluation, root noise,
                   tree init (``models/mcts.py``)
  search.select    a simulation's root entry and selection walk
  search.expand    its expansion step into the new slot
  search.evaluate  its leaf evaluation and masked prior
  search.backup    its tree writes and backup
  train.forward    ``loss_fn`` of a train step's slice (``models/selfplay.py``)
  train.backward   that slice's ``backward()``
  train.optimizer  the global-norm clip and AdamW
  op.fused_bit_rollout, op.bit_step, op.select_walk
                   the K1/K2, S1a and S1b wrappers (``ops/``)

Spans nest by time on the host.  ``SpanTrace`` puts each device activity
down to the spans open at the CUDA runtime call that launched it (by the
activity's correlation id; an activity with no such call is unlinked,
never guessed), each idle gap to the innermost span at its middle, and
counts the host reads under each span: an ``aten::_local_scalar_dense``
(behind ``.item()``, ``bool()`` and ``int()``) that copies from the card or
waits for it, and every other device-to-host copy.  The tools that read
the spans are ``profile_search`` (``search.*``, ``op.bit_step``,
``op.select_walk``), ``profile_train`` (``train.*``) and ``profile_wire``
(``op.fused_bit_rollout``).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

SPANS = (
    "search.root", "search.select", "search.expand", "search.evaluate", "search.backup",
    "train.forward", "train.backward", "train.optimizer",
    "op.fused_bit_rollout", "op.bit_step", "op.select_walk",
)
OUTSIDE = "host.outside_spans"
SCALAR_READ = "aten::_local_scalar_dense"

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


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


def annotate(name: str):
    """The span ``name`` (one of ``SPANS``) on the profiler's timeline while
    a profiler records, else the shared no-op context."""
    if _recording():
        return record_function(name)
    return _OFF


def _is_runtime_call(event) -> bool:
    """A CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaMemcpyAsync``, ...), whose correlation id the device activity it
    started carries.  Torch ops (``aten::...``) number their own ids, which
    may coincide; a kernel launched through ctypes, outside any op, has a
    runtime call and no op."""
    name = event.name()
    return name.startswith("cu") and "::" not in name and not event.is_user_annotation()


def _open_spans(spans: list, times: list) -> list:
    """The names of the spans open at each of ``times``, outermost first
    (a tuple a time, in the order of ``times``); ``spans`` (name, start_ns,
    end_ns) nest."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [()] * len(times)
    nxt, stack = 0, []
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while nxt < len(spans) and spans[nxt][1] <= t:
            while stack and stack[-1][2] <= spans[nxt][1]:  # closed before it opened
                stack.pop()
            stack.append(spans[nxt])
            nxt += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = tuple(s[0] for s in stack)
    return out


@dataclass
class SpanTrace:
    """A profiler's events by span: the spans as (name, start_ns, end_ns);
    the device activities as (name, start_ns, end_ns, spans open at their
    launch, or None when no runtime call is linked); the host reads as the
    spans open at each."""

    spans: list = field(default_factory=list)
    activities: list = field(default_factory=list)
    reads: list = field(default_factory=list)

    @classmethod
    def from_events(cls, events) -> "SpanTrace":
        """Read kineto's events (``prof.profiler.kineto_results.events()``);
        the spans are the host events named in ``SPANS``."""
        host = [e for e in events if e.device_type() == DeviceType.CPU]
        spans = [(e.name(), e.start_ns(), e.end_ns()) for e in host if e.name() in SPANS]
        calls = [e for e in host if _is_runtime_call(e)]
        launch = {e.correlation_id(): e.start_ns() for e in calls}
        device = [e for e in events
                  if e.device_type() != DeviceType.CPU and not e.is_user_annotation()]
        at = [launch.get(e.correlation_id()) for e in device]
        copied = sorted(t for e, t in zip(device, at) if t is not None and "DtoH" in e.name())
        waits = sorted(e.start_ns() for e in calls if "Synchronize" in e.name())
        scalar = sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == SCALAR_READ)

        starts = [s for s, _ in scalar]

        def within(times, start, end):
            i = bisect.bisect_left(times, start)
            return i < len(times) and times[i] <= end

        def in_scalar_read(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= scalar[i][1]

        # a scalar read of a host tensor neither copies nor waits: no read;
        # a device-to-host copy is a read of its own unless a scalar read
        # launched it (the same read)
        reads = [s for s, e in scalar if within(copied, s, e) or within(waits, s, e)]
        copies = [t for t in copied if not in_scalar_read(t)]
        linked = [t for t in at if t is not None]
        chains = iter(_open_spans(spans, linked + reads + copies))
        acts = [(e.name(), e.start_ns(), e.end_ns(), None if t is None else next(chains))
                for e, t in zip(device, at)]
        return cls(spans=spans, activities=acts, reads=list(chains))

    def device_seconds_under(self, name: str) -> float:
        """Device seconds of the activities launched while ``name`` was open."""
        return sum(e - s for _, s, e, c in self.activities if c and name in c) / 1e9

    def unlinked_seconds(self) -> float:
        """Device seconds of the activities with no linked runtime call."""
        return sum(e - s for _, s, e, c in self.activities if c is None) / 1e9

    def device_seconds(self) -> float:
        return sum(e - s for _, s, e, _ in self.activities) / 1e9

    def span_host_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9

    def span_count(self, name: str) -> int:
        return sum(n == name for n, _, _ in self.spans)

    def host_reads_under(self, prefix: str) -> int:
        """Host reads made while a span whose name starts with ``prefix``
        was open."""
        return sum(any(n.startswith(prefix) for n in c) for c in self.reads)

    def by_launching_span(self, k: int = 10) -> list:
        """Device seconds by (innermost span at launch, activity name), the
        ``k`` largest; unlinked activities under ``None``."""
        out = defaultdict(float)
        for name, s, e, c in self.activities:
            out[(c[-1] if c else (OUTSIDE if c == () else None), name)] += (e - s) / 1e9
        return sorted(([*key, sec] for key, sec in out.items()), key=lambda x: -x[2])[:k]

    def busy_intervals(self, start_ns: int, end_ns: int) -> list:
        """The union of the device activities' intervals, clipped to
        [start_ns, end_ns], in time order."""
        busy = []
        for _, s, e, _ in sorted(self.activities, key=lambda a: a[1]):
            s, e = max(s, start_ns), min(e, end_ns)
            if e <= s:
                continue
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        return busy

    def idle_gaps(self, start_ns: int, end_ns: int) -> list:
        """Idle seconds of [start_ns, end_ns] between the device activities'
        union, by the innermost span at each gap's middle."""
        busy = self.busy_intervals(start_ns, end_ns)
        edges = [start_ns] + [t for iv in busy for t in iv] + [end_ns]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        out = defaultdict(float)
        for (s, e), chain in zip(gaps, _open_spans(self.spans, [(s + e) // 2 for s, e in gaps])):
            out[chain[-1] if chain else OUTSIDE] += (e - s) / 1e9
        return sorted(([n, sec] for n, sec in out.items()), key=lambda x: -x[1])
