"""Inputs shared by the port's pins and ``chip_smoke.py``, torch only.

Seeded net parameters and observations for the net pins; the torch twins
of the evaluators in ``tests/test_mcts_exact.py`` (the same float32
operations, so both sides compute the same bits); a table net for the
deterministic arena; the deterministic self-play chunks (PUCT, and the
reuse and Gumbel arms) with their JSON record; a check that every arena
move is legal; what a spawned rank of the distributed learner runs
(:func:`dist_rank` and its cases); and for the host side, the golden
playthrough's parser and the C engine's games with their final snapshots
(:func:`c_games`, :func:`state_mismatches`).  ``chip_smoke.py`` uses them
on the card, where jax is not installed, so this module imports torch,
numpy and the port only.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import re
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from twixt_for_open_spiel_tpu_torch import parallel
from twixt_for_open_spiel_tpu_torch.models import arena, convert, mcts
from twixt_for_open_spiel_tpu_torch.models.network import AZNet, call_net, create_net
from twixt_for_open_spiel_tpu_torch.models.selfplay import (
    Sample,
    make_optimizer,
    selfplay_chunk,
    train_step,
)
from twixt_for_open_spiel_tpu_torch.native.engine import NativeEngine, random_game
from twixt_for_open_spiel_tpu_torch.ops import _cuda, bitboard, observe, state, step
from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo


def random_state_dict(board_size: int, channels: int, blocks: int, seed: int) -> dict:
    """Float32 parameters of an ``AZNet`` drawn by numpy from ``seed``, none
    trivial: kernels N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.01) and
    biases N(0, 0.01), the value head's output kernel included.  Carry them
    to flax with ``convert.params_to_flax``."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in AZNet(board_size, channels, blocks).state_dict().items():
        shape = tuple(p.shape)
        if p.ndim > 1:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = 0.1 * rng.standard_normal(shape)
            if "norm" in name and name.endswith("weight"):
                a += 1.0
        state[name] = torch.from_numpy(a.astype(np.float32))
    return state


def random_obs(batch: int, board_size: int, seed: int, density: float = 0.2) -> np.ndarray:
    """Binary float32 observations ``[B, 12, n, n-2]`` drawn by numpy."""
    rng = np.random.default_rng(seed)
    shape = (batch, 12, board_size, board_size - 2)
    return (rng.random(shape) < density).astype(np.float32)


def make_table(a_dim: int) -> np.ndarray:
    """Static pseudo-random logits, exactly representable on both sides
    (``test_mcts_exact._make_table``)."""
    return (
        ((np.arange(a_dim) * 2654435761) % 97).astype(np.float32)
        / np.float32(24.0)
        - np.float32(2.0)
    )


def table_evaluator(a_dim: int):
    """Fixed logits and a value of the move counter,
    f32((7*mc mod 11) - 5) / 7 (``test_mcts_exact.table_evaluator``)."""
    table = torch.from_numpy(make_table(a_dim))

    def evaluate(params, bs, generator):
        del params, generator
        b = bs.current_player.shape[-1]
        logits = table.to(bs.red.device).expand(b, a_dim)
        mc = bs.move_counter.float()
        return logits, (torch.remainder(mc * 7.0, 11.0) - 5.0) / 7.0

    return evaluate


def uniform_evaluator(a_dim: int):
    """Zero logits, zero value (``test_mcts_exact.uniform_evaluator``)."""

    def evaluate(params, bs, generator):
        del params, generator
        b = bs.current_player.shape[-1]
        dev = bs.red.device
        return (torch.zeros((b, a_dim), dtype=torch.float32, device=dev),
                torch.zeros(b, dtype=torch.float32, device=dev))

    return evaluate


EVALUATORS = {"table": table_evaluator, "uniform": uniform_evaluator}


def arena_table_params(a_dim: int, side: int, device) -> tuple:
    """Side ``side``'s parameters of the arena's table net: a logit row
    (the table, reversed for side 1) and a value offset."""
    table = make_table(a_dim)
    if side:
        table = table[::-1].copy()
    return torch.from_numpy(table).to(device), float(3 * side + 1)


def arena_table_net(params, obs):
    """``net_apply`` of a table net: the parameters' logit row for every
    env, and the value f32(((7*count + offset) mod 11) - 5) / 7 of the
    observation's set-plane count (an exact integer in float32)."""
    table, offset = params
    b = obs.shape[0]
    count = obs.float().sum(dim=(1, 2, 3))
    value = (torch.remainder(count * 7.0 + offset, 11.0) - 5.0) / 7.0
    return table.expand(b, table.shape[0]), value


def scenario_roots(scenarios, board_size: int, device):
    """A BitState batch with one env per move list of ``scenarios``, each
    played from reset on the port's canonical engine."""
    envs = []
    for moves in scenarios:
        s = state.reset(board_size, device)
        for a in moves:
            s = step.step(s, board_size, a)
        envs.append(s)
    return bitboard.from_state(state.State(*[torch.stack(xs, -1) for xs in zip(*envs)]))


def gumbel_case_noise(num_simulations: int, max_considered: int, envs: int) -> np.ndarray:
    """The injected Gumbels of a case of ``tests/test_gumbel_exact.py``
    (float32 [envs, 25], numpy-seeded from the case)."""
    rng = np.random.RandomState(1234 + num_simulations * 31 + max_considered)
    return rng.gumbel(size=(envs, 25)).astype(np.float32)


def next_actions(visits: np.ndarray, legal: np.ndarray, move: int) -> np.ndarray:
    """The moves of ``tests/test_reuse_exact.py``'s sequences: the visit
    argmax, and at every third move the lowest legal action without
    visits (an action with no child, so a cold start)."""
    actions = visits.argmax(-1)
    if move % 3 == 2:
        for i in range(len(actions)):
            zero = np.flatnonzero(legal[i] & (visits[i] == 0))
            if zero.size:
                actions[i] = zero[0]
    return actions


def reuse_sequence(device, scenarios, board_size: int, num_simulations: int, reuse_cap: int,
                   kind: str, backup: str, moves: int) -> list:
    """``search_batch_reuse`` along a sequence of :func:`next_actions` from
    the scenario roots, with finished games auto-reset and no root noise:
    per move, (root visits [B, A] with the inherited ones, root_q, stats,
    the actions played), numpy on the host."""
    n = board_size
    bs = scenario_roots(scenarios, n, device)
    nb = bs.current_player.shape[0]
    tree = mcts.init_reuse_tree(bs, board_size=n, num_simulations=num_simulations,
                                reuse_cap=reuse_cap, backup=backup)
    played = torch.full((nb,), -1, dtype=torch.int32, device=device)
    done = torch.ones(nb, dtype=torch.bool, device=device)
    out = []
    for move in range(moves):
        probs, root_q, tree, stats = mcts.search_batch_reuse(
            None, bs, torch.Generator(device=device).manual_seed(move), tree, played, done,
            evaluator=EVALUATORS[kind](n * n), board_size=n, num_simulations=num_simulations,
            reuse_cap=reuse_cap, dirichlet_frac=0.0, backup=backup, return_stats=True)
        legal = bitboard.bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), n).T
        visits = torch.where(legal, mcts._root_visits(tree), 0)
        if not torch.equal(probs, visits.float() / visits.sum(-1, keepdim=True).float()):
            raise AssertionError(f"visit_probs are not the root visits' shares at move {move}")
        visits, legal = visits.long().cpu().numpy(), legal.cpu().numpy()
        actions = next_actions(visits, legal, move)
        out.append((visits, root_q.cpu().numpy(), stats, actions))
        played = torch.from_numpy(actions).int().to(device)
        bs, done, _ = bitboard.bit_step_auto_reset(bs, played, n)
    return out


# The host side: BASELINE config 1's golden playthrough
# (``tests/test_parity_playthrough.py``), the reference's win line
# (twixt_test.cc:163-183) and the C engine's games for the replay soak.
PLAYTHROUGH_FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "playthrough_board8.txt"
WIN_LINE = [21, 38, 15, 11, 27, 17, 42, 45, 48]


def playthrough_structure(text: str):
    """(actions, fully dumped state indices) of a playthrough file, read as
    ``tests/test_parity_playthrough.py::parse_structure`` reads them."""
    actions = [int(m) for m in re.findall(r"^action: (\d+)$", text, re.M)]
    dumped = set()
    lines = text.split("\n")
    for i, line in enumerate(lines):
        m = re.match(r"^# State (\d+)$", line)
        if m and i + 1 < len(lines) and not lines[i + 1].startswith("# Apply action"):
            dumped.add(int(m.group(1)))
    return actions, dumped


def c_games(n: int, seeds) -> tuple:
    """The C engine's random games at board ``n``, one a seed: (their
    histories padded with -1 to int32 [T_max, B], the C engine's final
    snapshots {"color", "links", "blocked", "flags": [B, n*n]; "result",
    "move_counter", "swapped": [B]}, in the port's dtypes)."""
    histories, facts = [], {k: [] for k in ("color", "links", "blocked", "flags", "result",
                                           "move_counter", "swapped")}
    for seed in seeds:
        actions, result = random_game(n, seed)
        eng = NativeEngine(n)
        for a in actions:
            eng.apply(a)
        if eng.result != result:
            raise RuntimeError(f"C game {seed}: replayed result {eng.result} != {result}")
        histories.append(actions)
        for k, v in zip(("color", "links", "blocked", "flags"), eng.snapshot()):
            facts[k].append(v)
        facts["result"].append(result)
        facts["move_counter"].append(eng.move_counter)
        facts["swapped"].append(eng.swapped)
    padded = np.full((max(map(len, histories)), len(histories)), -1, np.int32)
    for b, h in enumerate(histories):
        padded[: len(h), b] = h
    facts = {k: np.asarray(v) for k, v in facts.items()}
    facts.update(result=facts["result"].astype(np.int32),
                 move_counter=facts["move_counter"].astype(np.int32))
    return padded, facts


def state_mismatches(s, n: int, facts: dict) -> list:
    """Names of the snapshot fields where a canonical ``State`` with a
    trailing env axis differs from :func:`c_games`' C snapshots."""
    inner = slice(geo.PAD, geo.PAD + n)
    got = {k: getattr(s, k)[inner, inner].reshape(n * n, -1).T.cpu().numpy()
           for k in ("color", "links", "blocked", "flags")}
    got.update(result=s.result.cpu().numpy(), move_counter=s.move_counter.cpu().numpy(),
               swapped=s.swapped.cpu().numpy())
    return [k for k in facts if not (got[k].dtype == facts[k].dtype
                                     and np.array_equal(got[k], facts[k]))]


def replay_mismatches(final, n: int, facts: dict) -> list:
    """:func:`state_mismatches` of a replayed ``BitState`` (through
    ``to_state``)."""
    return state_mismatches(bitboard.to_state(final, n), n, facts)


# The deterministic self-play chunk of the port's pins and ``chip_smoke.py``:
# the table net below, greedy plies (``temp_moves=0``) and no root noise,
# from roots part-way through random games (the bitboard rollout, which is
# bit-identical to JAX's), so that episodes end inside the chunk.
CHUNK = {"board_size": 5, "batch": 8, "num_steps": 12, "num_simulations": 8,
         "rollout_seed": 3, "rollout_steps": 9}


def chunk_roots(device):
    n = CHUNK["board_size"]
    return bitboard.bit_random_rollout(
        CHUNK["rollout_seed"], n, CHUNK["rollout_steps"],
        bitboard.bit_reset(n, CHUNK["batch"], device))[0]


def chunk_table_net(params, obs):
    """``arena_table_net`` with its value over 8, not 7: XLA on the CPU
    turns a division by the constant 7 into a product with its reciprocal,
    a unit in the last place off torch's quotient, and the self-play value
    targets carry the search's root values.  Eighths are exact on both
    sides."""
    table, offset = params
    count = obs.float().sum(dim=(1, 2, 3))
    value = (torch.remainder(count * 7.0 + offset, 11.0) - 5.0) / 8.0
    return table.expand(obs.shape[0], table.shape[0]), value


def deterministic_chunk(device, value_bootstrap: float = 0.0, debug_trace: bool = False):
    """The chunk on ``device``: (final BitState, Sample[, aux])."""
    n = CHUNK["board_size"]
    return selfplay_chunk(
        arena_table_params(n * n, 0, device), chunk_roots(device),
        torch.Generator(device=device).manual_seed(0), net_apply=chunk_table_net,
        board_size=n, num_steps=CHUNK["num_steps"],
        num_simulations=CHUNK["num_simulations"], temp_moves=0, dirichlet_frac=0.0,
        value_bootstrap=value_bootstrap, debug_trace=debug_trace)


# The other search arms' deterministic chunks, on the same roots and table
# net with the value bootstrap (which reads the searches' root values):
# ``puct_reuse`` greedy without root noise, ``gumbel`` with zero Gumbels.
ARMS = ("puct_reuse", "gumbel")
ARM_BOOTSTRAP = 0.5


@contextlib.contextmanager
def zero_gumbels():
    """Gumbel searches inside the block draw zeros for their Gumbels."""
    real = mcts._draw_gumbel
    mcts._draw_gumbel = lambda generator, shape, device: torch.zeros(shape, device=device)
    try:
        yield
    finally:
        mcts._draw_gumbel = real


def arm_chunk(device, search: str):
    """The ``search`` arm's deterministic chunk on ``device``: (final
    BitState, Sample, aux)."""
    n = CHUNK["board_size"]
    with zero_gumbels():
        return selfplay_chunk(
            arena_table_params(n * n, 0, device), chunk_roots(device),
            torch.Generator(device=device).manual_seed(0), net_apply=chunk_table_net,
            board_size=n, num_steps=CHUNK["num_steps"],
            num_simulations=CHUNK["num_simulations"], temp_moves=0, dirichlet_frac=0.0,
            search=search, value_bootstrap=ARM_BOOTSTRAP, debug_trace=True)


@contextlib.contextmanager
def checked_moves():
    """Inside the block every move the arena plays is checked against the
    legal mask of the state it is played in (frozen envs play on a reset
    board, which has legal moves too); yields ``{"moves", "illegal",
    "actions"}``, the last a list of each ply's actions."""
    counts = {"moves": 0, "illegal": 0, "actions": []}
    real = arena.step_bits

    def step(bs, n, action):
        legal = bitboard.bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), n).T
        ok = legal[torch.arange(action.shape[0], device=action.device), action.long()]
        counts["moves"] += int(ok.numel())
        counts["illegal"] += int((~ok).sum())
        counts["actions"].append(action.clone())
        return real(bs, n, action)

    arena.step_bits = step
    try:
        yield counts
    finally:
        arena.step_bits = real


def sample_record(final, sample, aux=None) -> dict:
    """A chunk's outputs as JSON: the obs wire's sha256 (as u32 words), the
    policy, value and weight targets as lists, the final-state digest and
    the debug aux."""
    words = sample.obs.cpu().numpy().view(np.uint32)
    rec = {
        "obs_sha256": hashlib.sha256(words.tobytes()).hexdigest(),
        "obs_shape": list(words.shape),
        "policy": sample.policy.cpu().tolist(),
        "value": sample.value.cpu().tolist(),
        "weight": sample.weight.cpu().tolist(),
        "final_digest": bitboard.state_digest(final),
    }
    if aux is not None:
        rec["aux"] = {k: v.cpu().tolist() for k, v in aux.items()}
    return rec


# The learner pins: a seeded float32 net at board 5 trained on the
# deterministic chunk with the bootstrap (weights 0.5 and 1)
TRAIN = {"channels": 8, "blocks": 1, "param_seed": 4, "value_bootstrap": 0.5, "lr": 1e-3,
         "steps": 3, "clips": {"below": 1e3, "above": 0.05}}


def summarize(state: dict) -> dict:
    """Each tensor of a ``state_dict`` (torch layout) as [its L2 norm, its
    dot product with a fixed normal vector seeded by the name], float64."""
    out = {}
    for name, x in state.items():
        a = np.asarray(x.detach().cpu().double() if torch.is_tensor(x) else x, np.float64).ravel()
        r = np.random.default_rng(int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                                                 "little")).standard_normal(a.size)
        out[name] = [float(np.linalg.norm(a)), float(a @ r)]
    return out


def summary_err(got: dict, want: dict) -> float:
    """Largest difference of two :func:`summarize` results, over each
    tensor's norm (at least 1e-12)."""
    if set(got) != set(want):
        raise KeyError(sorted(set(got) ^ set(want)))
    return max(max(abs(g - w) for g, w in zip(got[k], want[k])) / max(want[k][0], 1e-12)
               for k in want)


# --- the training path at the recipe's board (12) ----------------------------
# A board-12 chunk in the deterministic modes (greedy plies, no root noise)
# with a seeded float32 16x1 net, two chunks in a row from roots part-way
# through random games, so that games end inside the first chunk and the
# games that auto-reset carry into the second.
CHUNK12 = {"board_size": 12, "batch": 4, "num_steps": 32, "num_simulations": 8,
           "channels": 16, "blocks": 1, "param_seed": 12, "rollout_seed": 5,
           "rollout_steps": 40, "chunks": 2}


def chunk12_state() -> dict:
    c = CHUNK12
    return random_state_dict(c["board_size"], c["channels"], c["blocks"], c["param_seed"])


def board12_chunks(device) -> list:
    """The chunks in a row on ``device``: [(final BitState, Sample, aux)]."""
    c = CHUNK12
    n = c["board_size"]
    net = AZNet(n, c["channels"], c["blocks"], torch.float32)
    net.load_state_dict(chunk12_state())
    net.to(device)
    bs = bitboard.bit_random_rollout(c["rollout_seed"], n, c["rollout_steps"],
                                     bitboard.bit_reset(n, c["batch"], device))[0]
    out = []
    for k in range(c["chunks"]):
        final, sample, aux = selfplay_chunk(
            net, bs, torch.Generator(device=device).manual_seed(k), board_size=n,
            num_steps=c["num_steps"], num_simulations=c["num_simulations"], temp_moves=0,
            dirichlet_frac=0.0, debug_trace=True)
        out.append((final, sample, aux))
        bs = final
    return out


# The bf16 learner step at config-5 width (board 12, 64x4): a sample of
# 256 frames (8 steps of 32 envs of a random rollout, the policy targets
# sparse over each frame's legal set, outcomes +-1, 40 % of the frames
# finished) and seeded parameters, one ``train_step`` in bfloat16 and in
# float32 on each side.  The JAX record keeps each leaf's norm and
# ``BF16_STEP["projections"]`` seeded projections (:func:`projections`),
# from which the card's error is estimated without the whole tensors.
BF16_STEP = {"board_size": 12, "channels": 64, "blocks": 4, "param_seed": 5, "steps": 8,
             "batch": 32, "rollout_seed": 7, "rollout_steps": 20, "target_seed": 0,
             "lr": 1e-3, "projections": 32}
BF16_TOLERANCE = ("metrics rtol 2e-3 (train_frames, target_entropy 1e-6); "
                  "e = |port bf16 - jax f32| / |jax f32|: a gradient leaf's e <= 2 jax's + 2e-3, "
                  "an update leaf of >= 2048 elements 1.5 jax's + 0.02, all leaves 1.25 jax's")
METRIC_RTOL = {"loss": 2e-3, "policy_loss": 2e-3, "value_loss": 2e-3,
               "train_frames": 1e-6, "target_entropy": 1e-6}
BIG_LEAF = 2048


def bf16_step_state() -> dict:
    c = BF16_STEP
    return random_state_dict(c["board_size"], c["channels"], c["blocks"], c["param_seed"])


def bf16_step_sample(device) -> Sample:
    """The step's sample, built on the CPU and moved to ``device``."""
    c = BF16_STEP
    n = c["board_size"]
    bs = bitboard.bit_random_rollout(c["rollout_seed"], n, c["rollout_steps"],
                                     bitboard.bit_reset(n, c["batch"], "cpu"))[0]
    wire = []
    for t in range(c["steps"]):
        wire.append(observe.bit_observation_packed_with_legal(bs, n))
        bs = bitboard.bit_random_rollout(c["rollout_seed"] + 1 + t, n, 1, bs)[0]
    obs = torch.stack(wire)
    pk = obs.reshape(c["steps"], c["batch"], 12, -1)
    legal = observe.unpack_legal_words_flat(observe.legal_words_from_obs(pk), n).numpy()
    rng = np.random.default_rng(c["target_seed"])
    policy = rng.gamma(0.3, size=legal.shape) * legal
    policy = (policy / policy.sum(-1, keepdims=True)).astype(np.float32)
    value = rng.choice([-1.0, 1.0], size=legal.shape[:2]).astype(np.float32)
    weight = (rng.random(legal.shape[:2]) < 0.4).astype(np.float32)
    return Sample(obs.to(device), *(torch.from_numpy(x).to(device)
                                    for x in (policy, value, weight)))


def bf16_port_step(device, dtype) -> dict:
    """The port's step on ``device`` in ``dtype``: the loss metrics, the
    gradients and the AdamW update (parameters after less before), CPU
    float32 tensors by leaf."""
    c = BF16_STEP
    state = bf16_step_state()
    net = AZNet(c["board_size"], c["channels"], c["blocks"], dtype)
    net.load_state_dict(state)
    net.to(device)
    opt = make_optimizer(net.parameters(), c["lr"])
    grads = {}
    clip_and_step = opt.step

    def step(closure=None):  # the gradients as the step receives them
        grads.update({k: p.grad.detach().float().cpu().clone()
                      for k, p in net.named_parameters()})
        return clip_and_step(closure)

    opt.step = step
    metrics = train_step(net, opt, bf16_step_sample(device))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "update": {k: v.detach().float().cpu() - state[k]
                       for k, v in net.state_dict().items()}}


def metric_failures(got: dict, want: dict) -> list:
    """The loss metrics outside ``METRIC_RTOL``: (key, got, want)."""
    return [(k, got[k], want[k]) for k, rtol in METRIC_RTOL.items()
            if not abs(got[k] - want[k]) <= rtol * abs(want[k])]


def bf16_errors(port_bf16: dict, record: dict, part: str) -> dict:
    """By leaf and ``"all"``: (the port's bf16 error to JAX's float32
    result, estimated from the record's projections, and JAX's own)."""
    err = rel_errors(port_bf16[part], record["f32"][part])
    return {leaf: (e, record["jax_bf16_err"][part][leaf]) for leaf, e in err.items()}


def bf16_failures(port_bf16: dict, record: dict, part: str) -> list:
    """The leaves of ``part`` ("grads" or "update") where the port's bf16
    step is further from JAX's float32 step than ``BF16_TOLERANCE`` allows
    beside JAX's own bf16 step: (leaf, port's error, JAX's)."""
    bad = []
    for leaf, (e, j) in bf16_errors(port_bf16, record, part).items():
        if leaf == "all":
            ok = e <= 1.25 * j
        elif part == "grads":
            ok = e <= 2 * j + 2e-3
        else:
            ok = port_bf16[part][leaf].numel() < BIG_LEAF or e <= 1.5 * j + 0.02
        if not ok:
            bad.append((leaf, e, j))
    return bad


def projections(tensors: dict, k: int) -> dict:
    """Each tensor as [its L2 norm, then its dot products with ``k`` fixed
    standard normal vectors seeded by its name], float64."""
    out = {}
    for name, x in tensors.items():
        a = np.asarray(x.detach().cpu().double() if torch.is_tensor(x) else x,
                       np.float64).ravel()
        rng = np.random.default_rng(int.from_bytes(
            hashlib.sha256(name.encode()).digest()[:4], "little"))
        out[name] = [float(np.linalg.norm(a))] + [
            float(a @ rng.standard_normal(a.size)) for _ in range(k)]
    return out


def rel_errors(got: dict, want: dict) -> dict:
    """|got - want| / |want| by leaf, from whole tensors or, where either
    side is a :func:`projections` entry, estimated from the projections
    (the mean square of their differences estimates |got - want|^2 without
    bias, each vector being standard normal); ``"all"`` over every leaf
    together."""
    out, num, den = {}, 0.0, 0.0
    for name, w in want.items():
        g = got[name]
        if isinstance(w, list) or isinstance(g, list):
            k = len(w if isinstance(w, list) else g) - 1
            g, w = (x if isinstance(x, list) else projections({name: x}, k)[name]
                    for x in (g, w))
            sq, ref = float(np.mean(np.subtract(g[1:], w[1:]) ** 2)), w[0] ** 2
        else:
            sq = float(((g.double() - w.double()) ** 2).sum())
            ref = float((w.double() ** 2).sum())
        out[name] = (sq / max(ref, 1e-30)) ** 0.5
        num, den = num + sq, den + ref
    out["all"] = (num / max(den, 1e-30)) ** 0.5
    return out


# --- the distributed learner: what a spawned rank runs ------------------------
# ``parallel.spawn_ranks(dist_rank, N, (device, jobs))`` runs each job
# ``(name, case, kwargs)`` as ``DIST_CASES[case](mesh, **kwargs)`` on every
# rank and returns each rank's ``{name: result}``; results are CPU tensors
# and plain values.


def dist_rank(rank: int, world_size: int, rdzv: str, device: str, jobs: list) -> dict:
    """A spawned rank: join the group, run ``jobs`` in order.  ``"cpu"``: a
    gloo group through ``initialize_distributed``.  ``"cuda"``: one card a
    rank over NCCL, through ``initialize_distributed``, which makes the
    rank's card (``cuda:<rank>`` on one host) current before anything
    touches CUDA.  ``"cuda:<k>"``: every rank on card k; NCCL refuses two
    ranks on one device, so the group is gloo over the card's tensors,
    made here and passed to the mesh."""
    device = torch.device(device)
    if device.type == "cpu":
        parallel.initialize_distributed(rdzv, world_size, rank, device="cpu")
        mesh = parallel.make_env_mesh(device)
    elif device.index is None:
        parallel.initialize_distributed(rdzv, world_size, rank, device="cuda")
        mesh = parallel.make_env_mesh()
    else:
        dist.init_process_group("gloo", init_method=rdzv, world_size=world_size, rank=rank,
                                timeout=parallel.launch.GROUP_TIMEOUT)
        mesh = parallel.make_env_mesh(device, group=dist.group.WORLD)
    return {name: DIST_CASES[case](mesh, **kw) for name, case, kw in jobs}


def world_of_one_rank(rank: int, world_size: int, rdzv: str) -> dict:
    """A spawned process that asks for no group: ``initialize_world`` makes
    its world of one, whose all-reduce and mesh it returns."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(var, None)
    world = parallel.initialize_world(device="cpu")
    mesh = parallel.make_env_mesh("cpu")
    return {"world": world, "backend": dist.get_backend(),
            "sum": mesh.all_reduce(torch.tensor([3.0, 4.0])).tolist(),
            "again": parallel.initialize_world(device="cpu"), "mesh": (mesh.rank, mesh.size)}


def _cpu(tree) -> list:
    return [x.cpu() for x in tree]


def case_bit_rollout(mesh, board_size: int, batch: int, num_steps: int, seed: int,
                     fused: bool = True, check_plain: bool = False, reps: int = 0) -> dict:
    """``make_sharded_bit_rollout`` from the sharded reset: the rank's final
    leaves, the reduced stats and K1's launches in that one call.  With
    ``check_plain`` the plain rollout runs on the same shard and seed
    (``fused=False``) and its leaves and reduced stats are returned beside;
    with ``reps`` the rank's K1 launch is timed that many times (CUDA
    events, after a barrier) and, apart from it after a second barrier, the
    host time of the whole sharded call (K1 and the all-reduce)."""
    bs = parallel.sharded_bit_reset(board_size, batch, mesh)
    roll, _ = parallel.make_sharded_bit_rollout(board_size, num_steps, mesh, fused=fused)
    fbr.fused_bit_rollout.launches = 0
    final, stats = roll(seed, bs)
    out = {"leaves": _cpu(bitboard.bitstate_leaves(final)), "episodes": int(stats["episodes"]),
           "results": stats["results"].tolist(), "launches": fbr.fused_bit_rollout.launches}
    if check_plain:
        plain, _ = parallel.make_sharded_bit_rollout(board_size, num_steps, mesh, fused=False)
        pfinal, pstats = plain(seed, bs)
        out["plain"] = {"leaves": _cpu(bitboard.bitstate_leaves(pfinal)),
                        "episodes": int(pstats["episodes"]), "results": pstats["results"].tolist()}
    if reps:
        k1 = functools.partial(fbr.fused_bit_rollout, parallel.envsharding.rank_seed(
            seed, mesh.rank), board_size, num_steps, bs)
        kernel_ms, call_ms = [], []
        for _ in range(reps):
            kernel_ms += cuda_ms(k1, 1, mesh)
            dist.barrier(group=mesh.group)
            torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            roll(seed, bs)
            torch.cuda.synchronize(mesh.device)
            call_ms.append((time.perf_counter() - t0) * 1e3)
        out["kernel_ms"], out["call_ms"] = kernel_ms, call_ms
    return out


def cuda_ms(fn, reps: int, mesh=None) -> list:
    """Milliseconds of each of ``reps`` calls of ``fn``, each between a pair
    of CUDA events; with ``mesh``, each after a barrier of its group and a
    wait for the rank's card."""
    out = []
    for _ in range(reps):
        if mesh is not None:
            dist.barrier(group=mesh.group)
            torch.cuda.synchronize(mesh.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def case_k1_alone(mesh, board_size: int, batch: int, num_steps: int, seed: int,
                  reps: int) -> dict:
    """Rank 0 times K1 on ``batch`` envs from the reset, after one launch
    untimed, ``reps`` times by CUDA events, while the other ranks wait at a
    barrier: one card's rate with the other cards idle."""
    out = {}
    if mesh.rank == 0:
        k1 = functools.partial(fbr.fused_bit_rollout, parallel.envsharding.rank_seed(seed, 0),
                               board_size, num_steps,
                               bitboard.bit_reset(board_size, batch, mesh.device))
        k1()
        out["kernel_ms"] = cuda_ms(k1, reps)
    dist.barrier(group=mesh.group)
    return out


def case_rollout(mesh, board_size: int, batch: int, num_steps: int, seed: int) -> dict:
    """``make_sharded_rollout`` (the canonical engine) from the sharded reset."""
    roll, _ = parallel.make_sharded_rollout(board_size, num_steps, mesh)
    final, stats = roll(parallel.rank_generator(seed, mesh),
                        parallel.sharded_batch_reset(board_size, batch, mesh))
    return {"color_shape": tuple(final.color.shape), "color": final.color.cpu(),
            "all_open": bool((final.result == geo.RESULT_OPEN).all()),
            "episodes": int(stats["episodes"]), "results": stats["results"].tolist()}


def train_net(flax_params, board_size: int, channels: int, blocks: int, device):
    """The float32 net of the learner pins, with ``flax_params`` loaded."""
    net = create_net(board_size, channels, blocks, dtype=torch.float32, device=device)
    return convert.load_flax_params(net, flax_params)


def case_train(mesh, flax_params, sample: Sample, channels: int, blocks: int, optimizer: str,
               lr: float, microbatch: int, steps: int) -> dict:
    """``steps`` distributed train steps of the float32 net from
    ``flax_params`` on the rank's columns of the global ``sample``: the
    parameters after, and each step's metrics."""
    # float32 convolutions and matmuls without TF32 on a card
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    n = round(sample.policy.shape[-1] ** 0.5)
    net = train_net(flax_params, n, channels, blocks, mesh.device)
    opt = (torch.optim.SGD(net.parameters(), lr) if optimizer == "sgd"
           else make_optimizer(net.parameters(), lr))
    trainer, _ = parallel.make_distributed_train_step(call_net, opt, mesh, microbatch)
    shard = parallel.shard_env_pytree(sample, mesh)
    metrics = [{k: float(v) for k, v in trainer(net, shard).items()} for _ in range(steps)]
    return {"params": {k: v.cpu() for k, v in net.state_dict().items()}, "metrics": metrics}


def case_broadcast(mesh) -> dict:
    """Each rank builds a differently seeded net and AdamW state (rank 0's
    has stepped, the others' have not); ``broadcast_params`` makes every
    rank's rank 0's."""
    net = create_net(5, channels=8, blocks=1, dtype=torch.float32, device=mesh.device)
    net.load_state_dict(random_state_dict(5, 8, 1, seed=10 + mesh.rank))
    opt = make_optimizer(net.parameters(), 1e-3)
    if mesh.rank == 0:
        for p in net.parameters():
            p.grad = torch.full_like(p, 0.5)
        opt.step()
    parallel.broadcast_params(net, mesh, opt)
    state = {f"opt.{i}.{k}": v.cpu() for i, p in enumerate(net.parameters())
             for k, v in opt.state[p].items()}
    return {**{k: v.cpu() for k, v in net.state_dict().items()}, **state}


def case_chunk(mesh, value_bootstrap: float) -> dict:
    """The deterministic chunk of :func:`deterministic_chunk` through
    ``make_distributed_selfplay`` on the rank's columns of its roots."""
    n = CHUNK["board_size"]
    roots = parallel.shard_env_pytree(chunk_roots(mesh.device), mesh)
    selfplay, _ = parallel.make_distributed_selfplay(
        chunk_table_net, n, CHUNK["num_steps"], CHUNK["num_simulations"], mesh, temp_moves=0,
        dirichlet_frac=0.0, value_bootstrap=value_bootstrap)
    final, sample = selfplay(arena_table_params(n * n, 0, mesh.device), roots,
                             parallel.rank_generator(0, mesh))
    return {"final": _cpu(bitboard.bitstate_leaves(final)), "sample": Sample(*_cpu(sample))}


# The learn check of tests/test_sharding.py::test_dist_training_improves_gate
# with its seeds: board 5, batch 32, chunk 8, 8 simulations, a 16x1 net,
# AdamW 1e-3, 24 iterations, then 32 arena games against the initial net.
# The initial net is JAX's own, init_params(PRNGKey(param_seed)), carried bit
# for bit by LEARN_INIT; the self-play and arena seeds seed torch's streams
LEARN = {"board_size": 5, "batch": 32, "chunk_steps": 8, "simulations": 8, "channels": 16,
         "blocks": 1, "lr": 1e-3, "iterations": 24, "games": 32, "param_seed": 0,
         "selfplay_seed": 1, "arena_seed": 123, "bar": 0.6}
LEARN_INIT = pathlib.Path(__file__).parent / "fixtures" / "torch_port_learn_init.npz"


def learn_init_flax() -> dict:
    """The learn check's initial parameters as flax variables of numpy
    arrays, read from ``LEARN_INIT`` (one array a leaf, keyed by its
    ``/``-joined flax path; ``tests/test_torch_parallel.py`` writes it
    from JAX and checks it)."""
    tree: dict = {}
    with np.load(LEARN_INIT) as leaves:
        for path in leaves.files:
            *parents, leaf = path.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = leaves[path]
    return tree


def case_learn(mesh) -> dict:
    """The learn check from JAX's initial net: rank 0 plays the trained
    net against it and returns the tally; every rank returns its
    parameters."""
    c = LEARN
    n = c["board_size"]
    net = convert.load_flax_params(create_net(n, c["channels"], c["blocks"], device=mesh.device),
                                   learn_init_flax())
    init = copy.deepcopy(net).requires_grad_(False)
    parallel.broadcast_params(net, mesh)
    opt = make_optimizer(net.parameters(), c["lr"])
    selfplay, _ = parallel.make_distributed_selfplay(call_net, n, c["chunk_steps"],
                                                     c["simulations"], mesh)
    trainer, _ = parallel.make_distributed_train_step(call_net, opt, mesh)
    state_ = parallel.sharded_bit_reset(n, c["batch"], mesh)
    gen = parallel.rank_generator(c["selfplay_seed"], mesh)
    t0 = time.perf_counter()
    losses = []
    for _ in range(c["iterations"]):
        state_, sample = selfplay(net, state_, gen)
        losses.append(float(trainer(net, sample)["loss"]))
    out = {"params": {k: v.cpu() for k, v in net.state_dict().items()}, "losses": losses,
           "train_s": time.perf_counter() - t0}
    if mesh.rank == 0:
        t0 = time.perf_counter()
        tally = arena.arena_match(
            net, init, torch.Generator(device=mesh.device).manual_seed(c["arena_seed"]),
            board_size=n, batch=c["games"], num_simulations=c["simulations"],
            device=mesh.device)
        out["tally"] = {k: float(tally[k]) for k in ("a_score", "a_wins", "b_wins", "draws")}
        out["arena_s"] = time.perf_counter() - t0
    return out


def case_driver(mesh, runs: list, stderr_dir: str) -> list:
    """``train_arena_gate`` in this rank once per argument list of
    ``runs``, its stderr to ``stderr_dir/stderr<rank>.txt``: each run's
    trained parameters and first iteration."""
    from twixt_for_open_spiel_tpu_torch import train_arena_gate as tg

    out = []
    with open(f"{stderr_dir}/stderr{mesh.rank}.txt", "w") as err, \
            contextlib.redirect_stderr(err):
        for argv in runs:
            res = tg.run(tg.parse_args(argv))
            out.append({"net": {k: v.cpu() for k, v in res["net"].state_dict().items()},
                        "start_iteration": res["start_iteration"]})
    return out


def case_example(mesh, argv: list, stdout_dir: str) -> int:
    """``examples.selfplay_train`` in this rank, its stdout to
    ``stdout_dir/stdout<rank>.txt``; it ends the process group."""
    from twixt_for_open_spiel_tpu_torch.examples import selfplay_train

    with open(f"{stdout_dir}/stdout{mesh.rank}.txt", "w") as out, \
            contextlib.redirect_stdout(out):
        return selfplay_train.main(argv)


def primary_contexts() -> list:
    """The cards (by ordinal) on which this process holds an active primary
    context, as the CUDA driver reports them
    (``cuDevicePrimaryCtxGetState``)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what} returned CUDA driver error {rc}")

    count = ctypes.c_int()
    check(cu.cuInit(0), "cuInit")
    check(cu.cuDeviceGetCount(ctypes.byref(count)), "cuDeviceGetCount")
    active = []
    for i in range(count.value):
        dev, flags, on = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
        check(cu.cuDeviceGet(ctypes.byref(dev), i), "cuDeviceGet")
        check(cu.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags), ctypes.byref(on)),
              "cuDevicePrimaryCtxGetState")
        if on.value:
            active.append(i)
    return active


def case_placement(mesh) -> dict:
    """Where this rank ran, read after the jobs before it: its rank, size,
    backend and mesh device; on a card the current device, the cards
    holding its CUDA contexts and, from rank 0 while every rank is alive
    (between two barriers), ``nvidia-smi``'s compute processes by card
    uuid and the cards' uuids (None where nvidia-smi fails) and whether
    card 0 reaches each other card by peer access; the nvcc runs the
    process started (``ops/_cuda.py``) and its pid."""
    out = {"rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(mesh.group),
           "device": str(mesh.device), "nvcc_runs": _cuda.build.nvcc_runs, "pid": os.getpid()}
    if mesh.device.type == "cuda":
        out["current"] = torch.cuda.current_device()
        out["contexts"] = primary_contexts()
        dist.barrier(group=mesh.group)
        if mesh.rank == 0:
            query = ["nvidia-smi", "--format=csv,noheader"]
            for key, what in (("apps", "--query-compute-apps=pid,gpu_uuid,used_memory"),
                              ("uuids", "--query-gpu=index,uuid")):
                proc = subprocess.run(query + [what], capture_output=True, text=True,
                                      timeout=60)
                out[key] = proc.stdout if proc.returncode == 0 else None
            out["peers"] = [torch.cuda.can_device_access_peer(0, j)
                            for j in range(1, mesh.size)]
        dist.barrier(group=mesh.group)
    return out


def case_allreduce(mesh, numel: int, reps: int) -> list:
    """Milliseconds of each of ``reps`` all-reduces of a flat float32 buffer
    of ``numel`` (the learner's gradients), one a pair of CUDA events, each
    after a barrier, after one untimed."""
    flat = torch.zeros(numel, dtype=torch.float32, device=mesh.device)
    mesh.all_reduce(flat)
    return cuda_ms(lambda: mesh.all_reduce(flat), reps, mesh)


def case_train_timed(mesh, board_size: int, batch: int, chunk_steps: int, root_steps: int,
                     simulations: int, channels: int, blocks: int, lr: float,
                     reps: int) -> dict:
    """The learner step at its real width: each rank plays a
    ``chunk_steps``-ply chunk of ``batch`` envs (roots ``root_steps`` random
    plies in, seeded by the rank, so that episodes end in it) with the
    seeded bf16 net.  Then rank 0 alone, the others at a barrier, times the
    local ``train_step`` on its frames tiled over the ranks' count of envs
    (the global batch's frames on one card), after one untimed step; then
    every rank takes three distributed steps on its own frames, checks its
    parameters against rank 0's (``replicas_differ``), times ``reps`` more
    by CUDA events and checks again."""
    n = board_size
    net = create_net(n, channels, blocks, device=mesh.device)
    parallel.broadcast_params(net, mesh)
    roots = bitboard.bit_random_rollout(mesh.rank, n, root_steps,
                                        bitboard.bit_reset(n, batch, mesh.device))[0]
    play, _ = parallel.make_distributed_selfplay(call_net, n, chunk_steps, simulations, mesh,
                                                 temp_moves=16, dirichlet_alpha=0.3)
    _, sample = play(net, roots, parallel.rank_generator(0, mesh))
    out = {"frames": sample.weight.numel(), "finished": float(sample.weight.sum())}
    if mesh.rank == 0:
        local = copy.deepcopy(net)
        local_opt = make_optimizer(local.parameters(), lr)
        tiled = Sample(*(torch.cat([x] * mesh.size, 1) for x in sample))
        train_step(local, local_opt, tiled)
        out["local_frames"] = tiled.weight.numel()
        out["local_ms"] = cuda_ms(lambda: train_step(local, local_opt, tiled), reps)
    dist.barrier(group=mesh.group)
    dist_step, _ = parallel.make_distributed_train_step(
        call_net, make_optimizer(net.parameters(), lr), mesh)
    for _ in range(3):
        dist_step(net, sample)
    out["differ_after_3"] = parallel.replicas_differ(net, mesh)
    dist.barrier(group=mesh.group)
    out["dist_ms"] = cuda_ms(lambda: dist_step(net, sample), reps)
    out["differ_after"] = parallel.replicas_differ(net, mesh)
    out["tensors"] = len(net.state_dict())
    return out


def case_train_local(mesh, flax_params, sample: Sample, channels: int, blocks: int,
                     lr: float) -> dict | None:
    """On rank 0 only: the local ``train_step`` (SGD ``lr``) of the float32
    net from ``flax_params`` on the whole ``sample``, on the rank's device
    with TF32 off: the parameters after and the metrics."""
    if mesh.rank != 0:
        return None
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    n = round(sample.policy.shape[-1] ** 0.5)
    net = train_net(flax_params, n, channels, blocks, mesh.device)
    metrics = train_step(net, torch.optim.SGD(net.parameters(), lr),
                         Sample(*(x.to(mesh.device) for x in sample)))
    return {"params": {k: v.cpu() for k, v in net.state_dict().items()},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def case_replicas(mesh, flip_rank=None) -> list:
    """``replicas_differ`` over a seeded float32 net equal on every rank,
    with one bit of one weight flipped on ``flip_rank`` first."""
    net = create_net(5, channels=8, blocks=1, dtype=torch.float32, device=mesh.device)
    net.load_state_dict(random_state_dict(5, 8, 1, seed=0))
    if mesh.rank == flip_rank:
        with torch.no_grad():
            words = next(net.parameters()).view(-1).view(torch.int32)
            words[3] ^= 1 << 9
    return parallel.replicas_differ(net, mesh)


DIST_CASES = {"bit_rollout": case_bit_rollout, "rollout": case_rollout, "train": case_train,
              "broadcast": case_broadcast, "chunk": case_chunk, "learn": case_learn,
              "driver": case_driver, "example": case_example, "placement": case_placement,
              "k1_alone": case_k1_alone, "allreduce": case_allreduce,
              "train_timed": case_train_timed, "train_local": case_train_local,
              "replicas": case_replicas}


def concat_ranks(parts: list, dim: int = -1) -> list:
    """The ranks' shards of each leaf, joined along the env axis."""
    return [torch.cat(leaves, dim) for leaves in zip(*parts)]


def shared_result(tmp_path_factory, name: str, compute):
    """``compute()``, run once a pytest session: under pytest-xdist the
    workers share the session's temporary root, where the first to take
    the lock computes and saves the result (or its error) and the others
    load it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path, failed = root / f"{name}.pt", root / f"{name}.failed"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if failed.exists():
            raise RuntimeError(f"{name} failed in another test process:\n{failed.read_text()}")
        if not path.exists():
            try:
                result = compute()
            except BaseException as exc:
                failed.write_text(repr(exc))
                raise
            torch.save(result, f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
    return torch.load(path, weights_only=False)
