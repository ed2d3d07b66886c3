"""The traced part of a window: ``torch.profiler`` over CPU and CUDA, reduced
to the facts the per-layer readers and the result's ``device`` and
``breakdown`` take.

Spans are the harness's own ``record_function`` ranges, named ``bench.*``,
around its calls into each layer of the program.  The device's busy time is
the union of the intervals of every device activity (kernels, copies,
fills); the idle gaps between them are put down to the innermost span the
host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

OUTSIDE = "host.outside_spans"
WINDOW = "bench.window"


@dataclass
class Facts:
    """What one traced window showed: device activities as (name, start_ns,
    end_ns), the spans as (name, start_ns, end_ns), the window's bounds and
    the work counts the runner put in (``counts``)."""

    activities: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0
    counts: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device activities' intervals, clipped to the
        window, in time order."""
        out = []
        for _, start, end in sorted(self.activities, key=lambda a: a[1]):
            start, end = max(start, self.start_ns), min(end, self.end_ns)
            if end <= start:
                continue
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return out

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end in self.busy_intervals()) / 1e9

    def device_seconds(self, match) -> float:
        """Device seconds of the activities whose name ``match`` accepts."""
        return sum(end - start for name, start, end in self.activities if match(name)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        by_name = defaultdict(float)
        for name, start, end in self.activities:
            by_name[name] += (end - start) / 1e9
        return sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle seconds of the window by the innermost span around each
        gap's middle."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [t for iv in busy for t in iv] + [self.end_ns]
        spans = sorted(self.spans, key=lambda s: (s[1], -s[2]))
        by_span = defaultdict(float)
        nxt, stack = 0, []  # the spans open at the gap's middle; they nest
        for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
            if gap_end <= gap_start:
                continue
            mid = (gap_start + gap_end) // 2
            while nxt < len(spans) and spans[nxt][1] <= mid:
                while stack and stack[-1][2] < spans[nxt][1]:
                    stack.pop()
                stack.append(spans[nxt])
                nxt += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            by_span[stack[-1][0] if stack else OUTSIDE] += (gap_end - gap_start) / 1e9
        return sorted(([n, s] for n, s in by_span.items()), key=lambda x: -x[1])[:k]


@contextlib.contextmanager
def traced(facts: Facts, device):
    """Profile the block; on exit fill ``facts`` with its device activities
    and spans.  The window is the span ``bench.window`` around the block,
    from a synchronised device to the device's end of the block's work."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        sync(device)
        with record_function(WINDOW):
            yield
            sync(device)
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    window = [e for e in host if e.name() == WINDOW][0]
    facts.start_ns, facts.end_ns = window.start_ns(), window.end_ns()
    facts.spans = [(e.name(), e.start_ns(), e.end_ns()) for e in host
                   if e.name().startswith("bench.") and e.name() != WINDOW]
    facts.activities = [(e.name(), e.start_ns(), e.end_ns()) for e in events
                        if e.device_type() != torch.autograd.DeviceType.CPU
                        and not e.is_user_annotation()]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A ``bench.<name>`` span on the host's timeline."""
    return record_function(f"bench.{name}")
