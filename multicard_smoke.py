"""Drive the PyTorch port's distributed learner over the CUDA cards of one
host, one rank a card over NCCL, and check it end to end.

    python3 multicard_smoke.py

N = ``torch.cuda.device_count()`` ranks, N >= 2.  Every kernel is built
once here, before any rank starts, so that the ranks only load the
libraries; this process makes no CUDA context.  ``chip_smoke.py`` checks
one card (and phase 26's ranks sharing it over gloo); this script checks
what exists only across cards:

  (a) ``parallel.dryrun_multichip(N)``: six self-play -> train iterations
      at board 8, a 16x1 net, 2 envs a rank; the ranks' losses equal and
      the second half's mean below the first half's;
  one spawn of N ranks (``tests/torch_port_cases.dist_rank``, NCCL):
  (b) the sharded K1 rollout at the fixture's size (board 8, global
      B=4096, 1000 steps, seed 0): each rank launched K1, its shard
      bit-equal to the plain version on the same card and to the digest of
      ``tests/fixtures/torch_port_sharded_rollout.json``'s case of N ranks,
      the reduced counters to the fixture's;
  (b') weak scaling: K1 on 4096 envs a card (global 4096 N), each card's
      median by CUDA events and the sharded call with its all-reduce,
      beside rank 0's card timed alone in the same spawn (the other cards
      idle); the global env-steps/s and the parallel efficiency;
  (c) the all-reduce of the learner's flat float32 gradient buffer at
      config-5 width (the 64x4 board-12 net, 1,845,009 floats) alone: the
      median of 20 by CUDA events, the bus bandwidth 2 (N-1)/N bytes / t,
      and the link between the cards (``nvidia-smi topo -m``'s matrix,
      or the active NVLinks of ``nvidia-smi nvlink --status`` where the
      matrix cannot be read; one host: the links inside it, not a network
      between hosts);
  (d) the train step: ``tests/test_sharding.py``'s float32 case (board 5,
      a 16x1 net, TF32 off, SGD 0.1, microbatch 1 and 3) over N ranks
      against the local ``train_step`` on the whole sample (parameters
      rtol 2e-5 / atol 1e-6, metrics rtol 2e-5, ``chip_smoke.py`` phase 26
      (b)'s bars); at config-5 width the distributed step on 4096 frames
      a rank (a chunk of 8 plies at 512 envs) beside the local step on
      4096 N frames on one card, and the ranks' parameters bitwise rank
      0's after three steps and after the timed ones
      (``parallel.replicas_differ``: rank 0's per-tensor checksums
      broadcast, each rank's count of differing tensors all-reduced);
      each rank's placement: backend NCCL, ``cuda:<rank>`` current, CUDA
      contexts on its own card only (the driver's primary-context state),
      one compute process a card (``nvidia-smi --query-compute-apps``,
      where it lists them; this process holds none), no nvcc run;
  programs, as a user starts them:
  (e) ``torchrun --nproc_per_node=N -m twixt_for_open_spiel_tpu_torch.bench_selfplay``
      at config-5 width: strong (a global 512, 512 / N envs a rank) and
      ``--weak`` (512 a rank), beside the same program in a world of one;
      moves/s a card, s an iteration, peak memory a rank, the host's CPUs,
      the parallel efficiency;
  (f) ``torchrun ... train_arena_gate --mesh=N`` at ``chip_smoke.py``
      phase 19's cut (board 8, B=64, chunk 8, 16 simulations, 64x4, three
      iterations with gates at 2 and 3), then ``--resume`` for one more:
      the record kinds in order, written and printed by rank 0 alone (each
      once in the ranks' shared stderr), the ranks' parameters bitwise
      equal after the first iteration of each run;
  (g) ``examples.selfplay_train`` with ``--coordinator/--num_processes/
      --process_id`` as N processes for two iterations.

Each figure is printed beside every card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them) and the link type.  The last line is ``{"ok": true, "cards": N,
"kind": "<card name>"}``.  With fewer than two cards it prints why and
exits 1; a failed rank, check or timeout exits 1.  No phase falls back to
another backend, the host or a plain version.  It imports no jax.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke
from chip_smoke import require
from twixt_for_open_spiel_tpu_torch import parallel
from twixt_for_open_spiel_tpu_torch.models.network import create_net
from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.utils import serialization

cases = chip_smoke.cases
PKG = "twixt_for_open_spiel_tpu_torch"

# (b') K1 at the headline's board and steps, 4096 envs a card
WEAK_ROW = (8, 4096, 1000, 0)  # board, envs a card, steps, seed
K1_REPS = 5
# (c) and (d): config 5's net (board 12, 64x4) and its batch; the chunk cut
# from 32 plies to 8, so that a rank's step takes 4096 frames
TRAIN_ROW = {"board_size": 12, "batch": 512, "chunk_steps": 8, "root_steps": 160,
             "simulations": 64, "channels": 64, "blocks": 4, "lr": 1e-3, "reps": 5}
GRAD_FLOATS = 1_845_009
# (e) the world of one first, then N ranks strong and weak
SELFPLAY_RUNS = (("one", 1, []), ("strong", None, []), ("weak", None, ["--weak"]))
PROGRAM_TIMEOUT = 300


def bus_gbps(nbytes: int, ms: float, world: int) -> float:
    """An all-reduce's bus bandwidth in GB/s: a ring all-reduce moves
    2 (N-1)/N times the buffer through each rank's link."""
    return 2 * (world - 1) / world * nbytes / (ms * 1e-3) / 1e9


def topo_links(text: str, cards: int) -> dict:
    """``{(i, j): link}`` for i != j from ``nvidia-smi topo -m``'s matrix:
    the row of GPUi, column GPUj (``NV<k>``: k NVLinks; ``PIX``, ``PXB``,
    ``PHB``, ``NODE``, ``SYS``: PCIe through a switch, bridges, the host
    bridge, a NUMA node or across sockets)."""
    rows = {}
    for line in re.sub(r"\x1b\[[0-9;]*m", "", text).splitlines():
        parts = line.split()
        if parts and re.fullmatch(r"GPU\d+", parts[0]) and len(parts) > cards:
            rows[int(parts[0][3:])] = parts[1:cards + 1]
    return {(i, j): rows[i][j] for i in range(cards) for j in range(cards)
            if i != j and i in rows}


def nvlinks(text: str) -> list:
    """The active NVLinks of each card, as ``nvidia-smi nvlink --status``
    lists them (a ``GPU i:`` line, then a ``Link k: <rate>`` line a link):
    ``[(count, rates)]`` card by card."""
    cards = []
    for line in text.splitlines():
        if re.match(r"GPU \d+:", line.strip()):
            cards.append([])
        elif cards and re.match(r"Link \d+:", line.strip()):
            rate = line.split(":", 1)[1].strip()
            if rate != "<inactive>":
                cards[-1].append(rate)
    return [(len(r), sorted(set(r))) for r in cards]


def link_type(cards: int) -> str:
    """The link between the cards, printed beside every figure:
    ``nvidia-smi topo -m``'s matrix, or where that fails (as in a container
    that hides the PCI tree) the active NVLinks a card from ``nvidia-smi
    nvlink --status``; each command and its output are printed."""
    found = []
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status"]):
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        print(f"$ {' '.join(cmd)}  (exit {proc.returncode})\n{proc.stdout.rstrip()}"
              f"{proc.stderr.rstrip()}")
        if proc.returncode:
            continue
        if cmd[1] == "topo":
            links = topo_links(proc.stdout, cards)
            if len(links) == cards * (cards - 1):
                found.append("topo -m " + "/".join(sorted(set(links.values()))))
        else:
            per_card = nvlinks(proc.stdout)
            if len(per_card) == cards:
                found.append("NVLink: " + ", ".join(f"card {i} {k} active at {'/'.join(r)}"
                                                     for i, (k, r) in enumerate(per_card)))
    link = "; ".join(found) or "not read (nvidia-smi topo and nvlink both failed)"
    print(f"links between the cards: {link}")
    return link


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_program(cmd: list, timeout: float = PROGRAM_TIMEOUT) -> tuple:
    """``cmd`` from the repo's root: (exit code, stdout, stderr, seconds);
    killed at ``timeout``, which fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=chip_smoke.ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err, time.perf_counter() - t0


def torchrun(n: int, module: str, args: list, hidden: tuple = ()) -> list:
    """``torchrun --standalone --nproc_per_node=n -m <module> args``: the
    ranks write to this process's pipes, unprefixed.  ``hidden`` are
    arguments that torchrun's own parser must not see: torch 2.11's refuses
    ``--log=...`` after the module as an ambiguous abbreviation of its
    ``--log-dir``/``--logs-specs``.  With them the module runs under
    ``--no-python`` through ``sh -c 'exec "$@" <hidden>'``, whose script
    torchrun takes for a plain argument."""
    if not hidden:
        return [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={n}", "-m", f"{PKG}.{module}", *args]
    script = 'exec "$@" ' + " ".join(shlex.quote(a) for a in hidden)
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={n}", "--no-python", "sh", "-c", script, "sh", sys.executable,
            "-m", f"{PKG}.{module}", *args]


# --- (a) -----------------------------------------------------------------------

def dryrun_phase(n: int, card: str) -> None:
    t0 = time.perf_counter()
    losses = parallel.dryrun_multichip(n, device="cuda", timeout=PROGRAM_TIMEOUT)
    h = len(losses) // 2
    print(f"[a dryrun] {n} ranks over NCCL, one a card: board 8, 16x1 net, 2 envs a rank, "
          f"{len(losses)} iterations: losses {losses}, equal on every rank, halves "
          f"{sum(losses[:h]) / h} -> {sum(losses[h:]) / (len(losses) - h)}; "
          f"{time.perf_counter() - t0} s with the spawn [{card}]")


# --- (b)-(d): one spawn of N ranks ---------------------------------------------

def ranks_phase(n: int, card: str) -> None:
    rec, fixture_job = chip_smoke.sharded_rollout_job(n, reps=0)
    board, per_card, steps, seed = WEAK_ROW
    tree, sample = chip_smoke.sharded_train_case(torch.device("cpu"))
    _, _, _, _, ch, blocks = chip_smoke.DIST_TRAIN
    train = dict(flax_params=tree, sample=sample, channels=ch, blocks=blocks, optimizer="sgd",
                 lr=0.1, steps=1)
    grads = sum(p.numel() for p in create_net(12, 64, 4, device="cpu").parameters())
    require(grads == GRAD_FLOATS, f"config 5's net has {GRAD_FLOATS} parameters: {grads}")
    jobs = [("rollout", *fixture_job),
            ("alone", "k1_alone", dict(board_size=board, batch=per_card, num_steps=steps,
                                       seed=seed, reps=K1_REPS)),
            ("weak", "bit_rollout", dict(board_size=board, batch=per_card * n, num_steps=steps,
                                         seed=seed, reps=K1_REPS)),
            ("allreduce", "allreduce", dict(numel=grads, reps=chip_smoke.ALLREDUCE_REPS)),
            ("timed", "train_timed", TRAIN_ROW),
            ("train1", "train", dict(train, microbatch=1)),
            ("train3", "train", dict(train, microbatch=3)),
            ("local", "train_local", dict(flax_params=tree, sample=sample, channels=ch,
                                          blocks=blocks, lr=0.1)),
            ("placement", "placement", {})]
    t0 = time.perf_counter()
    ranks = parallel.spawn_ranks(cases.dist_rank, n, ("cuda", jobs), timeout=PROGRAM_TIMEOUT)
    print(f"[ranks] (b)-(d): {n} ranks spawned over NCCL in {time.perf_counter() - t0} s")

    # (b) the fixture's case, every rank on its own card
    check_rollout = [r["rollout"] for r in ranks]
    chip_smoke.check_sharded_rollout(check_rollout, rec, "on its own card, nccl", card)

    # (b') weak scaling
    alone = statistics.median(ranks[0]["alone"]["kernel_ms"])
    weak = [r["weak"] for r in ranks]
    k1 = [statistics.median(w["kernel_ms"]) for w in weak]
    calls = [statistics.median(w["call_ms"]) for w in weak]
    one = per_card * steps / alone * 1e3
    total = n * per_card * steps / max(calls) * 1e3
    require(all(w["launches"] >= 1 and w["episodes"] > 0 for w in weak), "K1 ran on every card")
    print(f"[b' weak K1] n={board}, {per_card} envs a card, {steps} steps: card 0 alone "
          f"{alone} ms of {ranks[0]['alone']['kernel_ms']} -> {one} env-steps/s; the {n} cards "
          f"at once, each card's K1 median {k1} ms, the sharded call with its all-reduce "
          f"median {calls} ms -> {total} env-steps/s globally (the slowest call), parallel "
          f"efficiency {total / (n * one)} [{card}]")

    # (c) the gradient all-reduce alone
    ar = [statistics.median(r["allreduce"]) for r in ranks]
    nbytes = grads * 4
    print(f"[c allreduce] {grads} float32 ({nbytes} bytes) over {n} ranks, NCCL: median of "
          f"{chip_smoke.ALLREDUCE_REPS} a rank {ar} ms (CUDA events); the slowest "
          f"{max(ar)} ms -> bus bandwidth {bus_gbps(nbytes, max(ar), n)} GB/s "
          f"(2 (N-1)/N bytes / t; links inside one host) [{card}]")

    # (d) the float32 step against the local one, then config-5 width
    local = ranks[0]["local"]
    chip_smoke.check_dist_train(ranks, local["params"], local["metrics"], "NCCL, one card a rank")
    timed = [r["timed"] for r in ranks]
    for r, t in enumerate(timed):
        require(t["differ_after_3"] == [0] * n and t["differ_after"] == [0] * n,
                f"the ranks' parameters bitwise rank 0's (rank {r}): {t}")
    dist_ms = [statistics.median(t["dist_ms"]) for t in timed]
    local_ms = statistics.median(timed[0]["local_ms"])
    c = TRAIN_ROW
    print(f"[d train] config-5 width (board 12, 64x4 bf16, AdamW {c['lr']}): the distributed "
          f"step on {timed[0]['frames']} frames a rank, median a rank {dist_ms} ms (of "
          f"{[t['dist_ms'] for t in timed]}); the local train_step on "
          f"{timed[0]['local_frames']} frames on card 0 alone {local_ms} ms of "
          f"{timed[0]['local_ms']}; the global batch {local_ms / max(dist_ms)}x faster on "
          f"{n} cards (parallel efficiency {local_ms / (n * max(dist_ms))}); the ranks' "
          f"{timed[0]['tensors']} tensors bitwise rank 0's after 3 steps and after "
          f"{3 + c['reps']} [{card}]")
    placement_check(ranks)


def placement_check(ranks: list) -> None:
    """Every rank on its own card over NCCL, with CUDA contexts there only,
    having started no nvcc."""
    n = len(ranks)
    places = [r["placement"] for r in ranks]
    for r, p in enumerate(places):
        print(f"[placement] rank {r}: pid {p['pid']}, {p['backend']}, mesh device "
              f"{p['device']}, current cuda:{p['current']}, CUDA contexts on cards "
              f"{p['contexts']}, nvcc runs {p['nvcc_runs']}")
        require((p["rank"], p["size"], p["backend"]) == (r, n, "nccl"), f"rank {r}'s group")
        require(p["device"] == f"cuda:{r}" and p["current"] == r, f"rank {r} on cuda:{r}")
        require(p["contexts"] == [r], f"rank {r} holds CUDA contexts on its card only")
        require(p["nvcc_runs"] == 0, f"rank {r} loaded the libraries without building")
    apps, uuids = places[0]["apps"], places[0]["uuids"]
    print(f"[placement] card 0 reaches cards 1-{n - 1} by peer access: {places[0]['peers']}; "
          f"nvidia-smi --query-compute-apps: "
          f"{apps.splitlines() if apps is not None else 'failed'}")
    if apps is None or uuids is None:
        print("[placement] nvidia-smi lists no compute processes here; the driver's "
              "primary-context state above stands for it")
        return
    index = dict(reversed([x.strip() for x in line.split(",")]) for line in uuids.splitlines())
    listed = [[x.strip() for x in line.split(",")] for line in apps.splitlines()]
    cards = sorted(int(index[uuid]) for _, uuid, _ in listed)
    require(cards == list(range(n)), f"nvidia-smi lists one compute process a card: {cards}")
    pids = {p["pid"]: r for r, p in enumerate(places)}
    seen = {pids[int(pid)]: int(index[uuid]) for pid, uuid, _ in listed
            if pid.isdigit() and int(pid) in pids}
    print(f"[placement] one compute process a card; the ranks' pids among them: "
          f"{seen or 'none (nvidia-smi sees another PID namespace)'}")
    require(all(r == card for r, card in seen.items()), f"each rank's pid on its card: {seen}")


# --- (e)-(g): programs ------------------------------------------------------------

SELFPLAY_LINE = re.compile(r"\[selfplay .* ranks=(\d+) .*\] ([\d.e+-]+) ms/iter -> "
                           r"([\d.e+-]+) env-moves/s")
RANK_LINE = re.compile(r"\[rank (\d+) of (\d+)\] card (-?\d+): ([\d.e+-]+) ms/iter, "
                       r"([\d.e+-]+) env-moves/s on its (\d+) envs, peak ([\d.e+-]+) MiB")


def selfplay_phase(n: int, card: str) -> None:
    rates = {}
    for name, world, flags in SELFPLAY_RUNS:
        world = world or n
        cmd = ([sys.executable, "-m", f"{PKG}.bench_selfplay", *flags] if world == 1
               else torchrun(world, "bench_selfplay", flags))
        rc, _, err, secs = run_program(cmd)
        require(rc == 0, f"bench_selfplay ({name}) exits 0: {err[-3000:]}")
        (head,) = [m.groups() for m in map(SELFPLAY_LINE.search, err.splitlines()) if m]
        rows = [m.groups() for m in map(RANK_LINE.search, err.splitlines()) if m]
        require(int(head[0]) == world and len(rows) == world, f"{world} ranks' lines: {err}")
        require(all(int(r[0]) == int(r[2]) for r in rows), f"rank r on card r: {rows}")
        cpus = re.search(r"\[host\] (\d+) CPUs", err).group(1)
        rates[name] = float(head[2])
        print(f"[e selfplay] {name}: {world} rank(s), {int(rows[0][5])} envs a rank, config 5 "
              f"(board 12, chunk 16, 64 simulations, 64x4 bf16): {float(head[1]) / 1e3} s an "
              f"iteration (the slowest rank) -> {head[2]} env-moves/s globally; by rank "
              f"(card, s an iteration, env-moves/s, peak MiB): "
              f"{[(int(r[2]), float(r[3]) / 1e3, float(r[4]), float(r[6])) for r in rows]}; "
              f"{cpus} CPUs on the host; {secs} s with the start [{card}]")
    for name in ("strong", "weak"):
        print(f"[e selfplay] {name} scaling: {rates[name]} env-moves/s on {n} cards against "
              f"{rates['one']} on one -> parallel efficiency "
              f"{rates[name] / (n * rates['one'])} [{card}]")


def driver_phase(n: int, card: str) -> None:
    with tempfile.TemporaryDirectory(prefix="multicard_driver_") as tmp:
        ckpt, log = os.path.join(tmp, "ckpt"), os.path.join(tmp, "gate.jsonl")
        base = [*(f"--{k}={v}" for k, v in chip_smoke.DRIVER.items()), f"--mesh={n}",
                f"--checkpoint_dir={ckpt}"]
        runs = (["--iterations=3", "--gates=2,3"], ["--iterations=4", "--gates=2,3,4", "--resume"])
        expect = (["train", "gate_vs_init", "train", "gate_vs_init", "best", "gate_vs_random",
                   "done"], ["resume", "gate_vs_init", "best", "gate_vs_random", "done"])
        first_its = (1, 4)
        seen = 0
        for extra, kinds_want, first_it in zip(runs, expect, first_its):
            rc, _, err, secs = run_program(torchrun(n, "train_arena_gate", base + extra,
                                                    hidden=(f"--log={log}",)))
            require(rc == 0, f"the driver --mesh={n} exits 0: {err[-3000:]}")
            with open(log) as f:
                recs = [json.loads(line) for line in f][seen:]
            seen += len(recs)
            kinds = [r["kind"] for k, r in enumerate(recs)
                     if k == 0 or r["kind"] != recs[k - 1]["kind"]]
            # the N ranks share the program's stderr: a line printed by more
            # than rank 0 would show more than once
            lines = err.splitlines()
            printed = [json.loads(x) for x in lines if x.startswith("{")]
            heads = [x for x in lines if x.startswith("[train] device=")]
            differ = [x for x in lines if x.startswith("[mesh] after iteration")]
            print(f"[f driver] --mesh={n} {' '.join(extra)}: {secs} s, records "
                  f"{[r['kind'] for r in recs]}; {heads}; {differ} [{card}]")
            for r in recs:
                print(f"[f driver]   {json.dumps(r)}")
            require(kinds == kinds_want, f"the record kinds in order: {kinds}")
            require(printed == recs, "each record printed once, by rank 0, and logged")
            require(len(heads) == 1 and "device=cuda:0" in heads[0] and f"mesh={n}" in heads[0],
                    "rank 0 alone ran the driver's head line, on cuda:0")
            require(differ == [f"[mesh] after iteration {first_it}: the {n} ranks' tensors that "
                               f"differ from rank 0's, by rank: {[0] * n}"],
                    f"the ranks' parameters bitwise rank 0's after iteration {first_it}")
        resume = next(r for r in recs if r["kind"] == "resume")
        require(resume["from_iteration"] == 3, "resume from iteration 3")
        _, _, it = serialization.restore_training(ckpt, "cpu")
        require(it == 4, f"the checkpoint at iteration 4: {it}")
        require(sorted(os.listdir(ckpt)) == ["best", "best_meta.json", "iteration.txt",
                                             "opt_state", "params"], "the checkpoint's layout")


def example_phase(n: int, card: str) -> None:
    with tempfile.TemporaryDirectory(prefix="multicard_example_") as tmp:
        d = chip_smoke.DRIVER
        coordinator = f"localhost:{free_port()}"
        argv = [*(f"--{k}={d[k]}" for k in ("board_size", "batch", "chunk_steps", "simulations",
                                              "channels", "blocks", "seed")),
                "--iterations=2", f"--checkpoint_dir={os.path.join(tmp, 'ckpt')}",
                f"--coordinator={coordinator}", f"--num_processes={n}"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.examples.selfplay_train", *argv, f"--process_id={r}"],
            cwd=chip_smoke.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        try:
            outs = [p.communicate(timeout=PROGRAM_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        lines = outs[0][0].splitlines()
        print(f"[g example] examples.selfplay_train --coordinator={coordinator} "
              f"--num_processes={n}, {n} processes, 2 iterations: {secs} s; rank 0 printed "
              f"{lines} [{card}]")
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            require(p.returncode == 0, f"process {r} exits 0: {err[-2000:]}")
            require(r == 0 or out == "", f"process {r} prints nothing: {out}")
        require(f"mesh: {n} ranks" in lines[0] and "on cuda (nccl)" in lines[0] and
                [x.split(":")[0] for x in lines[1:]] == ["iter 0", "iter 1"],
                "the example's two iterations over the cards")
        require(serialization.restore_training(os.path.join(tmp, "ckpt"), "cpu")[2] == 2,
                "the example's checkpoint")


# --- main ---------------------------------------------------------------------------

def main() -> int:
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"multicard_smoke: needs at least 2 CUDA cards, one a rank, and this machine has "
              f"{cards}", file=sys.stderr)
        return 1
    query = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    require(len(query) == cards, f"nvidia-smi lists the {cards} cards: {query}")
    for i, line in enumerate(query):
        print(f"card {i}: {line}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"nccl {torch.cuda.nccl.version()} cpus {os.cpu_count()}")
    card = f"{'; '.join(query)}; links {link_type(cards)}"

    t_start = time.perf_counter()
    _cuda.build(*chip_smoke.KERNELS)  # here, once: the ranks only load
    print(f"[build] {_cuda.build.nvcc_runs} nvcc runs in {time.perf_counter() - t_start} s")
    for phase in (dryrun_phase, ranks_phase, selfplay_phase, driver_phase, example_phase):
        t0 = time.perf_counter()
        phase(cards, card)
        print(f"[time] {phase.__name__}: {time.perf_counter() - t0} s")
    print(f"[total] {time.perf_counter() - t_start} s from the build to here")
    print(json.dumps({"ok": True, "cards": cards, "kind": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
