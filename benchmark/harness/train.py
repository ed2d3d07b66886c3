"""Traffic of kind ``train``: the learner's step on chunks of
``steps_per_chunk`` x ``envs`` frames drawn from the seed on the device,
AdamW with the global-norm clip (``make_optimizer``), driving
``train_step`` on one card.

Set-up builds the net from the seed's weights and its optimizer, and runs
the first three steps through the window's own call on three different
chunks of the pool (``pool`` chunks, the window cycling through them).
It keeps each step's loss, the first step's gradients as the optimizer
took them (its first moment over 1 - beta1) and the parameters' change
after the third.  The window runs steps, ``CLOCK_EVERY`` between
reads of the clock, until ``--seconds`` have passed (``--trace 1``:
``trace_steps`` steps under the profiler).  The rate is every frame over
the window's time.

The check, after the window: the reference learner
(``benchmark/reference/learner.py``, float32, TF32 off) from the same
weights through the same three steps on the same frames; the gap of each
step's count of finished frames, the value term's denominator
(``frames_gap``, exact); for the median leaf,
the norm of the difference between the program's first gradient (as the
optimizer took it) and the reference's, over the same for the reference's
own first gradient with its net in bfloat16, the precision the
configuration states (``grad_ratio``: how far rounding moves a seed's
gradient depends on the net and frames it draws, fivefold from seed to
seed, the ratio not); and the median leaf's gap between the two norms of
the parameters' change after the three (``change_gap``).  A leaf's
distance or gap is over the reference leaf's norm or the median leaf's,
whichever is larger.  The first step's loss gap (``loss_gap``,
``controls.py``) is read, not compared: the control does not separate
from the program on it (``PERF.md``).  Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are left out
of the change.  (The later steps' losses and the worst leaf swing from
seed to seed: Adam's first steps on drawn frames, and small leaves whose
gradients are sums that cancel; ``PERF.md`` gives both readings.)
"""

from __future__ import annotations

import statistics
import time

import torch

from benchmark.harness import inputs, result
from benchmark.harness.selfplay import program_net
from benchmark.harness.trace import Facts, span, sync, traced
from benchmark.reference import learner

CLOCK_EVERY = 4
CHECKED_STEPS = 3
NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median leaf's


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def run(cell, *, seed: int, seconds: float, trace: bool, start: float, device="cuda") -> dict:
    from twixt_for_open_spiel_tpu_torch.models.selfplay import Sample, make_optimizer, train_step

    cfg, t = cell.config, cell.traffic
    device = inputs.device_of(device)
    weights = inputs.weights(cfg, seed, device)
    model = program_net(cfg, weights, device)
    opt = make_optimizer(model.parameters(), lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                         clip_norm=cfg["clip_norm"])
    pool = [Sample(**inputs.frames(cfg, t["steps_per_chunk"], t["envs"], seed, i, device))
            for i in range(t["pool"])]

    def step(i):
        with span("train_step"):
            return train_step(model, opt, pool[i % len(pool)])

    losses, frames = [], []
    for i in range(CHECKED_STEPS):
        metrics = step(i)
        losses.append(float(metrics["loss"]))
        frames.append(float(metrics["train_frames"]))
        if i == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            # a leaf the optimizer holds no moment for took no gradient
            grad1 = {name: (opt.state[p]["exp_avg"] / (1 - beta1) if "exp_avg" in
                            opt.state.get(p, {}) else torch.zeros_like(p)).detach().cpu()
                     for name, p in model.named_parameters()}
    change = leaf_norms({name: p.detach() - weights[name] for name, p in model.named_parameters()})
    sync(device)
    setup_s = time.perf_counter() - start

    facts = Facts() if trace else None
    i = CHECKED_STEPS
    if trace:
        with traced(facts, device):
            for _ in range(t["trace_steps"]):
                step(i)
                i += 1
        elapsed = facts.window_s
        facts.counts = {"frames": t["steps_per_chunk"] * t["envs"], "steps": t["trace_steps"]}
    else:
        sync(device)
        t0 = time.perf_counter()
        while True:
            for _ in range(CLOCK_EVERY):
                step(i)
                i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        elapsed = time.perf_counter() - t0
    peak = inputs.peak_bytes(device)
    got = {"loss": losses, "frames": frames, "grad": grad1, "change": change}
    del model, opt, pool
    checks = check(cell, seed, weights, got, device)
    steps = i - CHECKED_STEPS
    dev = result.device_block(device, cell.chips, peak, [facts] if trace else None)
    return result.finish(cell, trace=trace, checks=checks, attempted=steps, failed=0,
                         rate=t["steps_per_chunk"] * t["envs"] * steps / elapsed,
                         setup_s=setup_s, device=dev, facts=facts)


def chunk(cell, seed: int, i: int, device) -> dict:
    """Chunk ``i`` of the pool, flat over frames."""
    t = cell.traffic
    got = inputs.frames(cell.config, t["steps_per_chunk"], t["envs"], seed, i, device)
    return {k: v.flatten(0, 1) for k, v in got.items()}


def reference_steps(cell, seed: int, weights: dict, device, *, precision: str = "float32",
                    keep=None) -> dict:
    """The reference's three steps on the same frames: each step's loss
    and count of finished frames, the first gradient (clipped) and the
    change's norm a leaf.  ``keep`` (frames -> frames) plants a fault in
    the reference put in the program's place."""
    cfg, t = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = learner.AdamW(weights, cfg["lr"], cfg["weight_decay"], cfg["clip_norm"])
    losses, frames, grad1 = [], [], None
    for i in range(CHECKED_STEPS):
        batch = chunk(cell, seed, i, device)
        if keep is not None:
            batch = keep(batch)
        loss, g = learner.grads(ref.params, batch, cfg["board_size"], t["reference_block"],
                                precision=precision)
        g = ref.step(g)
        losses.append(loss)
        frames.append(float(batch["weight"].sum()))
        if i == 0:
            grad1 = {k: v.detach().cpu() for k, v in g.items()}
    change = leaf_norms({k: ref.params[k] - weights[k] for k in weights})
    return {"loss": losses, "frames": frames, "grad": grad1, "change": change}


def first_gradient(cell, seed: int, weights: dict, device, precision: str) -> dict:
    """The reference's first gradient, clipped, with its net rounded to
    ``precision``."""
    cfg, t = cell.config, cell.traffic
    _, g = learner.grads(weights, chunk(cell, seed, 0, device), cfg["board_size"],
                         t["reference_block"], precision=precision)
    clip = learner.AdamW(weights, cfg["lr"], cfg["weight_decay"], cfg["clip_norm"]).clipped(g)
    return {k: v.detach().cpu() for k, v in clip.items()}


def left_out(grads: dict) -> list:
    """The leaves whose reference gradient is under ``NEGLIGIBLE`` of the
    median leaf's: they move by round-off alone."""
    norms = leaf_norms(grads)
    g_med = statistics.median(norms.values())
    return sorted(k for k, w in norms.items() if w < NEGLIGIBLE * g_med)


def grad_distance(got: dict, want: dict, pick) -> float:
    """The picked leaf's distance between two first gradients, over the
    reference leaf's norm or the median leaf's, whichever is larger."""
    norms = leaf_norms(want)
    g_med = statistics.median(norms.values())
    return pick([float((got[k].double() - g.double()).norm()) / max(norms[k], g_med)
                 for k, g in want.items()])


def gaps(got: dict, want: dict, unit: dict, steady: bool = True) -> dict:
    """The compared numbers of one side against the reference.  Steady:
    the first step's loss; the median leaf's distance from the reference's
    first gradient, over the same distance of ``unit`` (the reference's
    first gradient in bfloat16), and the median leaf's gap of the change's
    norm.  Else every step's loss and the worst leaf (for the readings
    alone: later steps and small leaves swing from seed to seed,
    ``PERF.md``)."""
    pick = statistics.median if steady else max
    pairs = list(zip(got["loss"], want["loss"]))[:1 if steady else None]
    loss = max(abs(a - b) / abs(b) for a, b in pairs)
    frames = max(abs(a - b) / b for a, b in zip(got["frames"], want["frames"]))
    grad = grad_distance(got["grad"], want["grad"], pick) / grad_distance(unit, want["grad"],
                                                                            pick)
    still = set(left_out(want["grad"]))
    moving = [k for k in want["grad"] if k not in still]
    c_med = statistics.median(want["change"][k] for k in moving)
    change = pick([abs(got["change"][k] - want["change"][k]) / max(want["change"][k], c_med)
                   for k in moving])
    return {"loss_gap": loss, "frames_gap": frames, "grad_ratio": grad, "change_gap": change}


def check(cell, seed: int, weights: dict, got: dict, device) -> dict:
    """The numbers that the cell holds to a limit."""
    want = reference_steps(cell, seed, weights, device)
    unit = first_gradient(cell, seed, weights, device, "bfloat16")
    read = gaps(got, want, unit)
    return {k: {"value": read[k], "limit": cell.limits[k]} for k in cell.limits}
