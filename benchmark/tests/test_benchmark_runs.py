"""Each cell's runner on the CPU at a tiny size: its result line, the
reference against the port on each cell's entry at boards 5-8, and the
timed path broken underneath, which the check has to catch."""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys

import pytest
import torch

import tiny
from benchmark.harness.result import emit
from benchmark.reference import engine, learner, net, search

CELLS = list(tiny.SMALL)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    got = tiny.run(tiny.cell(name), trace=trace)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        emit(got)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == keys
    assert line["correct"] is True, line["checks"]
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_reference_rollout_is_the_ports(n):
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset, bitstate_leaves
    from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import fused_bit_rollout

    final, stats, wire = fused_bit_rollout(977 + n, n, 60, bit_reset(n, 16, "cpu"), emit_obs=True)
    rfinal, episodes, results, rwire = engine.rollout(977 + n, n, 60, engine.bit_reset(n, 16, "cpu"))
    assert torch.equal(wire, rwire)
    assert all(torch.equal(a, b) for a, b in zip(bitstate_leaves(final),
                                                  engine.bitstate_leaves(rfinal)))
    assert int(stats["episodes"]) == int(episodes) and int(episodes) > 0
    assert torch.equal(stats["results"], results)


@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_reference_search_is_the_ports(n):
    """The port's PUCT search with a float32 net against the reference's,
    given the noise the port drew."""
    from twixt_for_open_spiel_tpu_torch.models import mcts
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
        bit_random_rollout,
        bit_reset,
        bitstate_leaves,
    )

    from benchmark.harness import inputs, selfplay

    c = tiny.cell("selfplay.b12-32768")
    c.config = dict(c.config, board_size=n)
    weights = inputs.weights(c.config, 31 + n, "cpu")
    model = selfplay.program_net(c.config, weights, "cpu")
    roots = bit_random_rollout(5, n, 3, bit_reset(n, 8, "cpu"))[0]
    gen = torch.Generator().manual_seed(n)
    drawn = []
    real = mcts.dirichlet

    def keep(*args):
        drawn.append(real(*args))
        return drawn[-1]

    mcts.dirichlet = keep
    try:
        probs, _ = mcts.search_batch(model, roots, gen, evaluator=mcts.net_evaluator(
            lambda m, o: m(o), n), board_size=n, num_simulations=12)
    finally:
        mcts.dirichlet = real
    ref_roots = engine.bitstate_from_leaves(x.clone() for x in bitstate_leaves(roots))
    want = search.search(lambda o: net.forward(weights, o), ref_roots, drawn[0], board_size=n,
                         num_simulations=12, dirichlet_frac=0.25)
    assert float(selfplay.total_variation(probs, want).max()) < 1e-6


def test_reference_learner_is_the_ports():
    """The port's float32 loss and gradients on drawn frames against the
    reference learner's."""
    from twixt_for_open_spiel_tpu_torch.models.network import call_net
    from twixt_for_open_spiel_tpu_torch.models.selfplay import Sample, loss_fn

    from benchmark.harness import inputs, selfplay

    c = tiny.cell("train.b12-16384")
    weights = inputs.weights(c.config, 5, "cpu")
    model = selfplay.program_net(c.config, weights, "cpu")
    frames = inputs.frames(c.config, 3, 8, 5, 0, "cpu")
    loss, _ = loss_fn(model, call_net, Sample(**frames))
    loss.backward()
    flat = {k: v.flatten(0, 1) for k, v in frames.items()}
    ref_loss, grads = learner.grads(weights, flat, c.config["board_size"], block=7)
    assert abs(float(loss) - ref_loss) < 1e-5 * abs(ref_loss)
    for name, p in model.named_parameters():
        assert torch.allclose(p.grad, grads[name], rtol=1e-4, atol=1e-6), name


def _broken(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


def wire_faults():
    from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bitstate_from_leaves, bitstate_leaves

    def unchanged(real):
        def fn(seed, n, steps, state, emit_obs):
            _, stats, wire = real(seed, n, steps, state, emit_obs=emit_obs)
            return state, stats, wire
        return fn

    def half(real):
        def fn(seed, n, steps, state, emit_obs):
            final, stats, wire = real(seed, n, steps, state, emit_obs=emit_obs)
            b = wire.shape[-1] // 2
            wire = wire.clone()
            wire[..., b:] = 0
            leaves = [x.clone() for x in bitstate_leaves(final)]
            for x, y in zip(leaves, bitstate_leaves(state)):
                x[..., b:] = y[..., b:]
            return bitstate_from_leaves(leaves), stats, wire
        return fn

    def altered(real):
        def fn(seed, n, steps, state, emit_obs):
            final, stats, wire = real(seed, n, steps, state, emit_obs=emit_obs)
            wire = wire.clone()
            wire[-1, 3, 4, 1] ^= 1 << 4
            return final, stats, wire
        return fn

    return [(fbr, "fused_bit_rollout", f) for f in (unchanged, half, altered)]


def selfplay_faults():
    from twixt_for_open_spiel_tpu_torch.models import mcts
    from twixt_for_open_spiel_tpu_torch.models import selfplay as sp

    def unchanged(real):
        def fn(bs, action, n):
            _, done, result = real(bs, action, n)
            return bs, torch.zeros_like(done), torch.zeros_like(result)
        return fn

    def half(real):
        def fn(params, bs, gen, **kw):
            probs, q = real(params, bs, gen, **kw)
            b = probs.shape[0] // 2
            probs = probs.clone()
            probs[b:2 * b] = probs[:b]
            return probs, q
        return fn

    def altered(real):
        def fn(gen, logits):
            return (real(gen, logits) + 1) % logits.shape[-1]
        return fn

    return [(sp, "bit_step_auto_reset", unchanged), (mcts, "search_batch", half),
            (sp, "_categorical", altered)]


def train_faults():
    from twixt_for_open_spiel_tpu_torch.models import selfplay as sp

    def unchanged(real):
        def fn(self, closure=None):
            return None
        return fn

    def half(real):
        def fn(model, opt, sample, **kw):
            b = sample.weight.shape[1] // 2
            return real(model, opt, type(sample)(*(x[:, :b] for x in sample)), **kw)
        return fn

    return [(sp.ClippedAdamW, "step", unchanged), (sp, "train_step", half)]


FAULTS = {"wire.b24-8192": wire_faults, "selfplay.b12-32768": selfplay_faults,
          "train.b12-16384": train_faults}


@pytest.mark.parametrize("name", list(FAULTS))
@pytest.mark.parametrize("which", [0, 1, 2])
def test_a_broken_path_is_not_correct(name, which, monkeypatch):
    faults = FAULTS[name]()
    if which >= len(faults):
        pytest.skip(f"{name} has {len(faults)} faults")
    module, attr, make = faults[which]
    _broken(monkeypatch, module, attr, make)
    got = tiny.run(tiny.cell(name))
    assert got["correct"] is False, got["checks"]


def test_nothing_loads_jax_or_the_jax_package():
    """A run's process, the harness, the readers and the reference load
    no module named jax, jaxlib, flax or twixt_for_open_spiel_tpu (whole
    top-level names); the reference loads nothing of the port."""
    code = """
import sys, time
sys.path[:0] = [{root!r}, {tests!r}]
import benchmark.reference.engine, benchmark.reference.search, benchmark.reference.net
import benchmark.reference.learner
assert not any(m.split('.')[0] == 'twixt_for_open_spiel_tpu_torch' for m in sys.modules)
import tiny
from benchmark.harness import spec
from benchmark.harness.result import forbidden_modules
for name in tiny.SMALL:
    tiny.run(tiny.cell(name))
    for m, _, _ in spec.per_layer(name):
        pass
print(forbidden_modules())
"""
    from conftest import ROOT

    tests = str(ROOT / "benchmark" / "tests")
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), tests=tests)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
