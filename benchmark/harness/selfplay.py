"""Traffic of kind ``selfplay``: ``selfplay_chunk`` with the PUCT search on
``batch`` envs from fresh boards (auto-reset), chunks of ``chunk_plies``
plies, the configuration's simulations, temperature moves and Dirichlet
root noise, one ``torch.Generator`` on the card seeded from ``--seed``.

Set-up makes the net's weights from the seed, loads them into the port's
``AZNet`` (bfloat16 compute) and plays ``warmup_plies`` plies.  The window
plays whole chunks until ``--seconds`` have passed, the last one finished
past it (``--trace 1``: ``trace_chunks`` chunks under the profiler); the
rate is every env's plies of those chunks over their time.

The check, after the window, follows the program ply by ply on
``checked_envs`` envs drawn from the seed, from fresh boards, with the
reference engine (``benchmark/reference/engine.py``) and the program's
played moves, replaying the generator's draws (``reference/search.py``'s
``ply_draws``) over the whole batch:

* ``engine_mismatch``: every wire word of every frame, visit mass off the
  legal set, every value target and weight, every chunk's final state;
* ``action_mismatch``: every played move against the reference's draw
  from the program's visit distribution (a sampled ply) or its first
  maximum (past ``temp_moves``);
* ``search_tv_ratio``: at ``checked_roots`` (ply, env) roots drawn from
  the seed among the plies of the warm-up and the window's first chunk,
  the reference's float32 search with the same root noise; the mean
  total-variation distance between its visit distribution and the
  program's, over the same distance of the reference's search with its
  net rounded to bfloat16, the precision the configuration states.  How
  far rounding moves a search depends on the net the seed draws (tenfold
  from seed to seed); the ratio does not.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from benchmark.harness import inputs, result
from benchmark.harness.trace import Facts, span, sync, traced
from benchmark.reference import engine, net, search

PROGRAM_STREAM = 2


@contextlib.contextmanager
def spans_in_program():
    """The search and the env step inside a chunk wrapped in ``bench.*``
    spans, for the traced chunks only."""
    from twixt_for_open_spiel_tpu_torch.models import mcts
    from twixt_for_open_spiel_tpu_torch.models import selfplay as sp

    saved = (mcts.search_batch, sp.bit_step_auto_reset)

    def wrap(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner

    mcts.search_batch = wrap("search", saved[0])
    sp.bit_step_auto_reset = wrap("env_step", saved[1])
    try:
        yield
    finally:
        mcts.search_batch, sp.bit_step_auto_reset = saved


def program_net(config: dict, weights: dict, device):
    from twixt_for_open_spiel_tpu_torch.models.network import AZNet

    with torch.device(device):
        model = AZNet(config["board_size"], config["channels"], config["blocks"],
                      dtype=getattr(torch, config["compute_dtype"]))
    model.load_state_dict(weights)
    return model


def play(cell, *, seed: int, seconds: float, trace: bool, start: float, device) -> dict:
    """Set-up and the window; returns what the check and the result take."""
    from twixt_for_open_spiel_tpu_torch.models.selfplay import selfplay_chunk
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset

    cfg, t = cell.config, cell.traffic
    n, batch = cfg["board_size"], t["batch"]
    weights = inputs.weights(cfg, seed, device)
    model = program_net(cfg, weights, device)
    gen = inputs.generator(seed, PROGRAM_STREAM, device)

    def chunk(state, plies):
        with span("selfplay_chunk"):
            return selfplay_chunk(
                model, state, gen, board_size=n, num_steps=plies,
                num_simulations=cfg["num_simulations"], temperature=cfg["temperature"],
                temp_moves=cfg["temp_moves"], search="puct",
                dirichlet_alpha=cfg["dirichlet_alpha"], dirichlet_frac=cfg["dirichlet_frac"],
                debug_trace=True)

    played = [chunk(bit_reset(n, batch, device), t["warmup_plies"])]
    sync(device)
    setup_s = time.perf_counter() - start

    facts = Facts() if trace else None
    chunks = 0
    if trace:
        with spans_in_program(), traced(facts, device):
            for _ in range(t["trace_chunks"]):
                played.append(chunk(played[-1][0], t["chunk_plies"]))
                chunks += 1
        elapsed = facts.window_s
        facts.counts = {"plies": chunks * t["chunk_plies"], "batch": batch,
                        "simulations": cfg["num_simulations"]}
    else:
        sync(device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            played.append(chunk(played[-1][0], t["chunk_plies"]))
            chunks += 1
        sync(device)
        elapsed = time.perf_counter() - t0
    return {"played": played, "weights": weights, "setup_s": setup_s, "elapsed": elapsed,
            "moves": chunks * t["chunk_plies"] * batch, "peak": inputs.peak_bytes(device),
            "facts": facts}


def run(cell, *, seed: int, seconds: float, trace: bool, start: float, device="cuda") -> dict:
    device = inputs.device_of(device)
    out = play(cell, seed=seed, seconds=seconds, trace=trace, start=start, device=device)
    checks = check(cell, seed, out["weights"], out["played"], device)
    facts = out["facts"]
    return result.finish(cell, trace=trace, checks=checks, attempted=out["moves"], failed=0,
                         rate=out["moves"] / out["elapsed"], setup_s=out["setup_s"], facts=facts,
                         device=result.device_block(device, cell.chips, out["peak"],
                                                    facts and [facts]))


def _diff(got, want) -> int:
    return int((got != want).sum())


def follow(cell, seed: int, played: list, device):
    """Replay the program's chunks on the checked envs; returns the two
    mismatch counts and the sampled roots, a (state, noise, program
    policy) a ply that has any."""
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bitstate_leaves

    cfg, t = cell.config, cell.traffic
    n, batch, a_dim = cfg["board_size"], t["batch"], cfg["board_size"] ** 2
    g = torch.Generator().manual_seed(inputs.stream_seed(seed, 3))
    envs = torch.randperm(batch, generator=g)[:t["checked_envs"]].sort().values.to(device)
    # the roots compared lie in the plies that every run plays, traced or
    # not: the warm-up's and the window's first chunk's
    root_plies = sum(c[1].policy.shape[0] for c in played[:2])
    picks = torch.randperm(root_plies * len(envs), generator=g)[:t["checked_roots"]].tolist()
    root_cols = {}  # ply -> the checked envs' columns whose root is compared
    for i in sorted(picks):
        root_cols.setdefault(i // len(envs), []).append(i % len(envs))
    draws = inputs.generator(seed, PROGRAM_STREAM, device)
    init = engine.bit_reset(n, 1, device)
    state = engine.bit_reset(n, len(envs), device)
    engine_bad = action_bad = 0
    roots = []
    ply = 0
    for final, sample, aux in played:
        movers, dones, results = [], [], []
        for step in range(sample.policy.shape[0]):
            noise, exp_draws = search.ply_draws(draws, batch, a_dim, cfg["dirichlet_alpha"],
                                                device)
            noise, exp_draws = noise[envs], exp_draws[envs]
            mover = state.current_player.clamp(0, 1)
            legal = engine.bit_legal_mask_flat(state, mover, n).T
            engine_bad += _diff(sample.obs[step][envs],
                                engine.bit_observation_packed_with_legal(state, n))
            probs = sample.policy[step][envs]
            engine_bad += int(((probs > 0) & ~legal).sum())
            logits = torch.where(legal, torch.log(probs.clamp_min(1e-9)) / cfg["temperature"],
                                 -torch.inf)
            want = torch.where(state.move_counter < cfg["temp_moves"],
                               search.categorical(exp_draws, logits),
                               torch.where(legal, probs, -1.0).argmax(-1))
            action = aux["actions"][step][envs]
            action_bad += _diff(action, want.to(action.dtype))
            if ply in root_cols:
                cols = torch.tensor(root_cols[ply], device=device)
                roots.append((engine.bitstate_from_leaves(
                    x[..., cols] for x in engine.bitstate_leaves(state)), noise[cols], probs[cols]))
            nxt = engine.step_bits_reference(state, n, action.to(torch.int32))
            done = nxt.result != engine.RESULT_OPEN
            movers.append(mover)
            dones.append(done)
            results.append(nxt.result)
            state = engine._reset_done(nxt, init)
            ply += 1
        # each frame's value target: its episode's result from its mover's
        # view, weight 1; frames of unfinished episodes weight 0
        z = torch.zeros(len(envs), device=device)
        w = torch.zeros(len(envs), device=device)
        for step in reversed(range(len(dones))):
            z = torch.where(dones[step], search.outcome_value(results[step], 0), z)
            w = torch.where(dones[step], 1.0, w)
            engine_bad += _diff(sample.value[step][envs], torch.where(movers[step] == 0, z, -z))
            engine_bad += _diff(sample.weight[step][envs], w)
        engine_bad += sum(_diff(a[..., envs], b) for a, b in
                          zip(bitstate_leaves(final), engine.bitstate_leaves(state)))
    return engine_bad, action_bad, roots


def root_batch(sampled: list):
    """The sampled roots as one batch: (state, noise, program policy)."""
    leaves = [engine.bitstate_leaves(s) for s, _, _ in sampled]
    state = engine.bitstate_from_leaves(torch.cat(parts, dim=-1) for parts in zip(*leaves))
    return state, torch.cat([r[1] for r in sampled]), torch.cat([r[2] for r in sampled])


def reference_policy(cell, weights: dict, state, noise, *, precision: str = "float32"):
    """The reference search's visit distribution at the roots, its net in
    float32 (TF32 off), or rounded to ``precision`` (``reference/net.py``)."""
    cfg = cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = functools.partial(net.forward, weights, precision=precision)
    return search.search(fn, state, noise, board_size=cfg["board_size"],
                         num_simulations=cfg["num_simulations"],
                         dirichlet_frac=cfg["dirichlet_frac"], c_puct=cfg["c_puct"])


def total_variation(p, q) -> torch.Tensor:
    return 0.5 * (p - q).abs().sum(-1)


def readings(cell, seed: int, weights: dict, played: list, device, control: bool = False):
    """The compared numbers; with ``control`` also the control's search
    ratio (the reference's search with its net in fp8)."""
    engine_bad, action_bad, sampled = follow(cell, seed, played, device)
    del played[:]
    out = {"engine_mismatch": engine_bad, "action_mismatch": action_bad, "search_tv_ratio": 0.0}
    if sampled:
        state, noise, prog = root_batch(sampled)
        ref = reference_policy(cell, weights, state, noise)
        unit = float(total_variation(
            reference_policy(cell, weights, state, noise, precision="bfloat16"), ref).mean())
        out["search_tv_ratio"] = ratio(float(total_variation(prog, ref).mean()), unit)
        if control:
            low = reference_policy(cell, weights, state, noise, precision="fp8")
            out["control_search_tv_ratio"] = ratio(float(total_variation(low, ref).mean()), unit)
    return out


def ratio(tv: float, unit: float) -> float:
    """``tv`` in units of the bfloat16 reference's distance (0 over 0 is 0)."""
    if unit > 0:
        return tv / unit
    return 0.0 if tv == 0 else float("inf")


def check(cell, seed: int, weights: dict, played: list, device) -> dict:
    got = readings(cell, seed, weights, played, device)
    return {k: {"value": v, "limit": cell.limits[k]} for k, v in got.items()}
