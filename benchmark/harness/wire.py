"""Traffic of kind ``wire``: chained launches of the bitboard rollout that
emits the learner wire (``fused_bit_rollout(..., emit_obs=True)``), each
from the state the last one left, ``batch`` envs and ``steps`` steps a
launch.

Set-up makes the envs' initial state and runs ``warmup_launches`` launches;
the window then launches until ``--seconds`` have passed (``--trace 1``:
``trace_launches`` launches under the profiler) and synchronises.  The rate
is every env-step of the window's launches over its time.

The check: the reference rollout (``benchmark/reference/engine.py``) runs
the warm-up launches from its own initial state, then, from the program's
own input state, ``checked_launches`` launches of the window drawn from the
seed (a reservoir sample); every wire word, every word of the final state
and the episode and result counters are compared.  ``wire_mismatch``
counts the words that differ.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import inputs, result
from benchmark.harness.trace import Facts, span, sync, traced
from benchmark.reference import engine


def _diff(got, want) -> int:
    return int((got != want).sum())


def mismatches(program_out, reference_out) -> int:
    """Differing words between a program launch's (final state, stats,
    wire) and the reference's (final, episodes, results, wire)."""
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bitstate_leaves

    final, stats, wire = program_out
    rfinal, episodes, results, rwire = reference_out
    count = _diff(wire, rwire)
    count += sum(_diff(a, b) for a, b in zip(bitstate_leaves(final), engine.bitstate_leaves(rfinal)))
    count += _diff(stats["episodes"], episodes) + _diff(stats["results"], results)
    return count


def run(cell, *, seed: int, seconds: float, trace: bool, start: float, device="cuda") -> dict:
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset, bitstate_leaves
    from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import fused_bit_rollout

    device = inputs.device_of(device)
    n = cell.config["board_size"]
    t = cell.traffic
    batch, steps = t["batch"], t["steps"]

    def launch(i, state):
        return fused_bit_rollout(inputs.launch_seed(seed, i), n, steps, state, emit_obs=True)

    state = initial = bit_reset(n, batch, device)
    warm = []
    for i in range(t["warmup_launches"]):
        out = launch(i, state)
        warm.append(out)
        state = out[0]
    sync(device)
    setup_s = time.perf_counter() - start

    # a reservoir sample of the window's launches: (index, input, output)
    rng = random.Random(seed)
    kept, done = [], 0
    facts = Facts() if trace else None

    def one(i, state):
        nonlocal done
        with span("wire_launch"):
            out = launch(i, state)
        done += 1
        if len(kept) < t["checked_launches"]:
            kept.append((i, state, out))
        elif (j := rng.randrange(done)) < t["checked_launches"]:
            kept[j] = (i, state, out)
        return out[0]

    i = len(warm)
    if trace:
        with traced(facts, device):
            for _ in range(t["trace_launches"]):
                state = one(i, state)
                i += 1
        elapsed = facts.window_s
    else:
        sync(device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            state = one(i, state)
            i += 1
        sync(device)
        elapsed = time.perf_counter() - t0
    peak = inputs.peak_bytes(device)
    del state

    # the check: the start from the reference's own initial state, then
    # the sampled launches from the program's input state
    count = 0
    ref = engine.bit_reset(n, batch, device)
    count += sum(_diff(a, b) for a, b in zip(bitstate_leaves(initial), engine.bitstate_leaves(ref)))
    for k, out in enumerate(warm):
        want = engine.rollout(inputs.launch_seed(seed, k), n, steps, ref)
        count += mismatches(out, want)
        ref = want[0]
    del warm
    for k, given, out in kept:
        ref = engine.bitstate_from_leaves(bitstate_leaves(given))
        count += mismatches(out, engine.rollout(inputs.launch_seed(seed, k), n, steps, ref))
    checks = {"wire_mismatch": {"value": count, "limit": cell.limits["wire_mismatch"]}}
    if facts is not None:
        facts.counts = {"launches": t["trace_launches"], "batch": batch, "steps": steps,
                        "board_size": n}
    rate = done * batch * steps / elapsed
    return result.finish(cell, trace=trace, checks=checks, attempted=done, failed=0, rate=rate,
                         setup_s=setup_s, facts=facts,
                         device=result.device_block(device, cell.chips, peak, facts and [facts]))
