"""The port's program spans (``utils/profiling.py``) on the CPU: the search's
root and four phases, the train step's three, and the K1/K2 wrapper under
``torch.profiler``, the wrapper's as ``profile_wire`` reads it; the profile
tools without a card; ``annotate`` with the profiler off; every span name in
``SPANS``; and ``SpanTrace`` on synthetic kineto events, with linked and
unlinked device activities and host reads, against hand-computed values."""

import re
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from twixt_for_open_spiel_tpu_torch import profile_search, profile_train, profile_wire
from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.models import selfplay as sp
from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import fused_bit_rollout
from twixt_for_open_spiel_tpu_torch.utils import profiling

N, B, SIMS = 5, 3, 4
PACKAGE = Path(profiling.__file__).resolve().parent.parent
PHASES = ["search.select", "search.expand", "search.evaluate", "search.backup"]


def traced_spans(fn) -> list:
    """The program spans ``fn`` opens under the profiler, by start time."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    trace = profiling.SpanTrace.from_events(prof.profiler.kineto_results.events())
    return [name for name, _, _ in sorted(trace.spans, key=lambda s: (s[1], -s[2]))]


def small_net():
    torch.manual_seed(0)
    return create_net(N, channels=8, blocks=1, device="cpu")


def run_search(kind: str):
    net, gen = small_net(), torch.Generator().manual_seed(1)
    roots = tbit.bit_reset(N, B, "cpu")
    kw = dict(evaluator=mcts.net_evaluator(call_net, N), board_size=N, num_simulations=SIMS)
    if kind == "puct":
        return lambda: mcts.search_batch(net, roots, gen, **kw)
    if kind == "gumbel":
        return lambda: mcts.gumbel_search_batch(net, roots, gen, max_considered=2, **kw)
    tree = mcts.init_reuse_tree(roots, board_size=N, num_simulations=SIMS)
    none = torch.full((B,), -1, dtype=torch.int64)
    return lambda: mcts.search_batch_reuse(net, roots, gen, tree, none,
                                           torch.zeros(B, dtype=torch.bool), **kw)


@pytest.mark.parametrize("kind", ["puct", "gumbel", "reuse"])
def test_search_spans_in_order(kind):
    names = traced_spans(run_search(kind))
    search = [n for n in names if n.startswith("search.")]
    assert search == ["search.root"] + PHASES * SIMS
    # the S1 wrappers open inside their phases, once a simulation each
    assert names.count("op.select_walk") == names.count("op.bit_step") == SIMS
    for i, name in enumerate(names):
        if name == "op.select_walk":
            assert names[i - 1] == "search.select"
        if name == "op.bit_step":
            assert names[i - 1] == "search.expand"


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_spans(microbatch):
    net = small_net()
    _, sample = sp.selfplay_chunk(net, tbit.bit_reset(N, 2, "cpu"),
                                  torch.Generator().manual_seed(3), board_size=N, num_steps=4,
                                  num_simulations=2)
    opt = sp.make_optimizer(net.parameters(), 1e-3)
    names = traced_spans(lambda: sp.train_step(net, opt, sample, microbatch=microbatch))
    train = [n for n in names if n.startswith("train.")]
    assert train == ["train.forward", "train.backward"] * microbatch + ["train.optimizer"]


def test_fused_bit_rollout_span_on_cpu():
    bs = tbit.bit_reset(N, 2, "cpu")
    names = traced_spans(lambda: fused_bit_rollout(7, N, 3, bs, emit_obs=True))
    assert names == ["op.fused_bit_rollout"]


def test_profile_wire_reads_the_wrapper_span_on_cpu(capsys):
    """``profile_wire``'s reading at a tiny shape on the CPU, where the
    wrapper runs the plain version: one span a launch, host time each."""
    profile_wire.profile_wire(torch.device("cpu"), launches=3, shape=(N, 2, 3), warmup=1)
    out = capsys.readouterr().out
    assert re.search(r"op\.fused_bit_rollout host \d+(\.\d+)? us a call", out), out
    assert re.search(r"span op\.fused_bit_rollout: host \S+ ms, device 0\.0 ms, calls 3\n",
                     out), out


@pytest.mark.parametrize("tool", [profile_search, profile_train, profile_wire])
def test_profile_tools_need_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(*([[]] if tool is profile_search else [])) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_annotate_off_is_the_shared_no_op(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "record_function", lambda name: made.append(name))
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.annotate("search.select"), profiling.annotate("train.forward")
    assert first is second
    with first:
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.annotate("search.select")
    assert made == ["search.select"]


def test_every_span_name_is_listed_and_used():
    used = set()
    for path in PACKAGE.rglob("*.py"):
        if path == Path(profiling.__file__).resolve():
            continue  # the helper itself
        for name in re.findall(r"\bannotate\((.*?)\)", path.read_text()):
            assert re.fullmatch(r'"[a-z_.]+"', name), f"{path}: annotate({name})"
            used.add(name.strip('"'))
    assert used <= set(profiling.SPANS), used - set(profiling.SPANS)
    assert set(profiling.SPANS) <= used, set(profiling.SPANS) - used
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)


class Ev:
    """A stand-in for one of kineto's events, with the methods
    ``SpanTrace.from_events`` calls."""

    def __init__(self, name, start, end, *, kind="cpu_op", corr=0, device=False):
        self._name, self._start, self._end = name, start, end
        self._kind, self._corr, self._device = kind, corr, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def span(name, start, end):
    return Ev(name, start, end, kind="user_annotation")


def launch(corr, at, name="cudaLaunchKernel"):
    return Ev(name, at, at + 5, kind="cuda_runtime", corr=corr)


def kernel(name, corr, start, end):
    return Ev(name, start, end, kind="kernel", corr=corr, device=True)


def synthetic_events() -> list:
    """Two searches' worth of spans (times in ns):

      search.root 0-100; search.select 100-200 with op.select_walk 110-190;
      search.evaluate 200-400; bench.chunk 0-1000 around all of them.

    Kernels: k1 launched at 120 (under op.select_walk) runs 300-340; k2
    launched at 250 (search.evaluate) runs 340-440; k3 launched at 500
    (under no program span, by ``cuLaunchKernelEx``, beside an op whose own
    id is also 3) runs 600-650; k4 has no runtime call (its correlation id
    9 has only an op, an id of another kind, which must not link) and runs
    700-760; a DtoH copy launched at 260 inside a scalar read and one
    launched at 50 outside any; a device-side annotation, never counted.
    Host reads: scalar reads at 255 (search.evaluate, its copy at 260) and
    520 (no span, a stream sync at 522); the scalar read at 150 (under
    op.select_walk) neither copies nor waits, a host tensor's: no read.
    The harness's span bench.chunk is not a program span.
    """
    return [
        span("bench.chunk", 0, 1000),
        span("search.root", 0, 100),
        span("search.select", 100, 200),
        span("op.select_walk", 110, 190),
        span("search.evaluate", 200, 400),
        Ev("aten::_local_scalar_dense", 255, 270),
        Ev("aten::_local_scalar_dense", 520, 530),
        Ev("aten::_local_scalar_dense", 150, 160),
        launch(7, 522, "cudaStreamSynchronize"),
        Ev("aten::add", 9, 12, corr=9),
        launch(1, 120), kernel("k1", 1, 300, 340),
        launch(2, 250), kernel("k2", 2, 340, 440),
        launch(3, 500, "cuLaunchKernelEx"), kernel("k3", 3, 600, 650),
        kernel("k4", 9, 700, 760),
        launch(5, 260), kernel("Memcpy DtoH (Device -> Pinned)", 5, 440, 450),
        launch(6, 50), kernel("Memcpy DtoH (Device -> Pageable)", 6, 450, 460),
        Ev("search.evaluate", 300, 440, kind="gpu_user_annotation", device=True),
        Ev("aten::mul", 130, 140, corr=3),
    ]


def test_span_trace_links_launches_to_spans():
    trace = profiling.SpanTrace.from_events(synthetic_events())
    assert sorted(trace.spans) == [("op.select_walk", 110, 190), ("search.evaluate", 200, 400),
                                   ("search.root", 0, 100), ("search.select", 100, 200)]
    assert len(trace.activities) == 6
    assert trace.device_seconds_under("search.select") == 40e-9
    assert trace.device_seconds_under("op.select_walk") == 40e-9
    assert trace.device_seconds_under("search.evaluate") == (100 + 10) * 1e-9
    assert trace.device_seconds_under("search.root") == 10e-9
    assert trace.device_seconds_under("search.backup") == 0
    assert trace.unlinked_seconds() == 60e-9
    assert trace.device_seconds() == (40 + 100 + 50 + 60 + 10 + 10) * 1e-9
    assert trace.span_host_seconds("search.select") == 100e-9
    assert trace.span_count("search.select") == 1 and trace.span_count("search.backup") == 0
    # the copy at 260 is the scalar read's own; the one at 50 is a read
    assert trace.host_reads_under("search.") == 2
    assert trace.host_reads_under("search.root") == 1
    assert trace.host_reads_under("op.") == 0
    assert len(trace.reads) == 3
    top = trace.by_launching_span(3)
    assert top[0] == ["search.evaluate", "k2", pytest.approx(100e-9)]
    assert top[1] == [None, "k4", pytest.approx(60e-9)]
    assert top[2] == [profiling.OUTSIDE, "k3", pytest.approx(50e-9)]


def test_span_trace_idle_gaps_by_innermost_span():
    trace = profiling.SpanTrace.from_events(synthetic_events())
    # busy 300-460, 600-650, 700-760 of 0-1000: gaps 0-300 (middle 150:
    # op.select_walk), 460-600 (530), 650-700, 760-1000 (no program span;
    # bench.chunk, open over all of them, is not one)
    assert trace.busy_intervals(0, 1000) == [[300, 460], [600, 650], [700, 760]]
    assert trace.idle_gaps(0, 1000) == [[profiling.OUTSIDE, pytest.approx(430e-9)],
                                        ["op.select_walk", pytest.approx(300e-9)]]
