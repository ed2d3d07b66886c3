"""Config-5 benchmark: self-play feeding a learner, through the distributed
learner's functions (``scripts/bench_selfplay.py``, ported).

    python3 -m twixt_for_open_spiel_tpu_torch.bench_selfplay [--gumbel|--reuse] [--weak]
    python3 -m twixt_for_open_spiel_tpu_torch.bench_selfplay --quick     # tiny, the CPU
    python3 -m twixt_for_open_spiel_tpu_torch.bench_selfplay --ranks=8   # gloo ranks, the CPU

``parallel.make_distributed_selfplay`` and ``make_distributed_train_step``
in a world of one (NCCL on the card): board 12, batch 512, chunk 16, 64
simulations, the 64x4 net (bf16), PUCT (``--gumbel``: Gumbel;
``--reuse``: PUCT with tree reuse).  Two iterations (a chunk, then a train
step on its frames, the trained net playing the next chunk) warm up; then
three iterations are timed on the host clock, the card synchronised at
the end.  Prints ms an iteration (the slowest rank's), moves/s, MCTS
simulations/s and train frames/s (frames = batch x chunk), then each
rank's ms an iteration, moves/s, peak memory and card, and the host's CPU
count.  Under ``torchrun --nproc_per_node=N`` each of N ranks plays
``batch / N`` envs on its own card (``--weak``: ``batch`` each).

``--ranks=N`` (the JAX script's ``--virtual=N``) spawns N gloo ranks on the
CPU (``parallel.spawn_ranks``) at the CPU shapes, then the same global work
on one rank, and prints the parallel efficiency; ranks that share one
host's cores validate the sharded path and do not measure scaling.
``--weak`` holds each rank's batch and grows the global batch with the
ranks.  ``--quick`` runs the JAX script's CPU shapes (batch 32, chunk 4, 8
simulations, a 16x1 net) in one process.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from twixt_for_open_spiel_tpu_torch import parallel
from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net
from twixt_for_open_spiel_tpu_torch.models.selfplay import make_optimizer

BOARD = 12
CARD = {"batch": 512, "chunk": 16, "sims": 64, "channels": 64, "blocks": 4}
CPU = {"batch": 32, "chunk": 4, "sims": 8, "channels": 16, "blocks": 1}
WEAK_CPU_BATCH = 8  # a rank's batch under --weak on the CPU
WARMUP, REPS = 2, 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gumbel", action="store_true", help="Gumbel search")
    ap.add_argument("--reuse", action="store_true", help="PUCT with tree reuse")
    ap.add_argument("--weak", action="store_true", help="a fixed batch a rank")
    ap.add_argument("--ranks", type=int, default=0, help="N gloo ranks on the CPU")
    ap.add_argument("--quick", action="store_true", help="the CPU shapes in one process")
    args = ap.parse_args(argv)
    if not (args.quick or args.ranks) and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    return args


def config(args, world: int) -> dict:
    cfg = dict(CPU if args.quick or args.ranks else CARD)
    if args.weak:
        cfg["batch"] = (WEAK_CPU_BATCH if args.quick or args.ranks else cfg["batch"]) * world
    cfg["search"] = "puct_reuse" if args.reuse else "gumbel" if args.gumbel else "puct"
    return cfg


def iterations(cfg: dict, device, reps: int) -> float:
    """Seconds an iteration over ``reps`` timed iterations of this rank's
    shard, after the warm-up, in the process group that exists (a world
    of one if none)."""
    mesh = parallel.make_env_mesh(device)
    net = create_net(BOARD, cfg["channels"], cfg["blocks"], device=device)  # seed 0 on every rank
    selfplay, _ = parallel.make_distributed_selfplay(
        call_net, BOARD, cfg["chunk"], cfg["sims"], mesh, search=cfg["search"])
    opt = make_optimizer(net.parameters(), 1e-3)
    trainer, _ = parallel.make_distributed_train_step(call_net, opt, mesh)
    state = parallel.sharded_bit_reset(BOARD, cfg["batch"], mesh)
    gen = parallel.rank_generator(1, mesh)

    def iteration():
        nonlocal state
        state, sample = selfplay(net, state, gen)
        return trainer(net, sample)

    for _ in range(WARMUP):  # the trained net plays the next chunk, as timed
        float(iteration()["loss"])
    t0 = time.perf_counter()
    for _ in range(reps):
        metrics = iteration()
    float(metrics["loss"])  # waits for the card
    return (time.perf_counter() - t0) / reps


def _rank(rank: int, world: int, rdzv: str, cfg: dict, reps: int) -> float:
    dist.init_process_group("gloo", init_method=rdzv, world_size=world, rank=rank)
    return iterations(cfg, torch.device("cpu"), reps)


def on_ranks(cfg: dict, world: int, reps: int) -> float:
    """The slowest rank's seconds an iteration, over ``world`` spawned gloo
    ranks on the CPU."""
    return max(parallel.spawn_ranks(_rank, world, (cfg, reps), timeout=3600))


def report(cfg: dict, dt: float, ranks: int, device) -> None:
    moves = cfg["batch"] * cfg["chunk"]
    print(f"[selfplay n={BOARD} batch={cfg['batch']} chunk={cfg['chunk']} sims={cfg['sims']} "
          f"search={cfg['search']} net={cfg['channels']}x{cfg['blocks']} ranks={ranks} "
          f"device={device}] {dt * 1e3} ms/iter -> {moves / dt} env-moves/s, "
          f"{moves * cfg['sims'] / dt} MCTS sims/s, {moves / dt} train frames/s "
          f"(frames {moves})", file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.ranks:
        cfg = config(args, args.ranks)
        dt = on_ranks(cfg, args.ranks, REPS)
        report(cfg, dt, args.ranks, "cpu")
        if not args.weak and args.ranks > 1:
            dt1 = on_ranks(cfg, 1, REPS)
            print(f"[scaling] 1-rank {dt1 * 1e3} ms vs {args.ranks}-rank {dt * 1e3} ms -> "
                  f"parallel efficiency {dt1 / (dt * args.ranks)}  [gloo ranks on the CPU "
                  f"contend for the same cores: this validates the sharded code path, it does "
                  f"NOT measure real scaling; run on several cards for that]", file=sys.stderr)
        return 0
    device = torch.device("cpu" if args.quick else "cuda")
    made = not dist.is_initialized()
    rank, world = parallel.initialize_world(device=device)  # torchrun's ranks, else one
    try:
        if device.type == "cuda":  # the rank's card, made current by the launch
            device = torch.device("cuda", torch.cuda.current_device())
            if rank == 0:
                print(f"device={torch.cuda.get_device_name(device)}", file=sys.stderr)
        cfg = config(args, world)
        rows = per_rank(iterations(cfg, device, REPS), device, rank, world)
        if rank == 0:
            report(cfg, max(r[0] for r in rows), world, device)
            report_ranks(cfg, rows)
    finally:
        if made:
            dist.destroy_process_group()
    return 0


def per_rank(dt: float, device: torch.device, rank: int, world: int) -> list:
    """Every rank's ``[seconds an iteration, peak MiB allocated on its card,
    its card's index]`` (-1 for both on the CPU), rank by rank, on every
    rank: one all-reduce of a row a rank."""
    rows = torch.zeros(world, 3, dtype=torch.float64, device=device)
    peak, index = -1.0, -1
    if device.type == "cuda":
        peak, index = torch.cuda.max_memory_allocated(device) / 2**20, device.index
    rows[rank] = torch.tensor([dt, peak, index], dtype=torch.float64)
    return parallel.make_env_mesh(device).all_reduce(rows).tolist()


def report_ranks(cfg: dict, rows: list) -> None:
    world = len(rows)
    moves = cfg["batch"] // world * cfg["chunk"]
    for rank, (dt, peak, index) in enumerate(rows):
        print(f"[rank {rank} of {world}] card {int(index)}: {dt * 1e3} ms/iter, "
              f"{moves / dt} env-moves/s on its {cfg['batch'] // world} envs, peak "
              f"{peak} MiB allocated (-1: the CPU)", file=sys.stderr)
    print(f"[host] {os.cpu_count()} CPUs", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
