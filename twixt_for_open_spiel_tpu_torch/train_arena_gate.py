"""Train by self-play and gate the result in the arena
(``scripts/train_arena_gate.py``, ported).

    python -m twixt_for_open_spiel_tpu_torch.train_arena_gate \\
        --checkpoint_dir=ckpt --log=gate.jsonl          # on the card
    python -m twixt_for_open_spiel_tpu_torch.train_arena_gate --smoke   # tiny, CPU
    torchrun --nproc_per_node=4 -m twixt_for_open_spiel_tpu_torch.train_arena_gate \\
        --mesh=4 --checkpoint_dir=ckpt --log=gate.jsonl     # four cards

(torch 2.11's torchrun refuses ``--log=`` after the module, taking it for an
ambiguous abbreviation of its own ``--log-dir``; the README shows how to
pass it past torchrun's parser.)

Each iteration plays one self-play chunk (``models/selfplay.py``) and takes
one ``train_step`` on it.  At every gate iteration the current net plays the
initial net (both searching with the same simulations) and the best-scoring
gate's net is kept; at the end the best net plays uniform random moves.
The pass criteria of the JAX script: trained-vs-init and trained-vs-random
``a_score`` >= 0.8 over >= 256 games.

The flags, their defaults and the JSONL records (``train``,
``gate_vs_init``, ``resume``, ``warn``, ``best``, ``gate_vs_random``,
``done``) are the JAX script's, so logs compare with ``docs/runs/*.jsonl``;
checkpoints keep its layout (``utils/serialization.py``; ``best/`` and
``best_meta.json`` beside the latest).  It runs on the card; ``--cpu`` runs
the same arguments on the CPU, ``--smoke`` a tiny budget there.
``--search`` picks self-play's search (PUCT, PUCT with tree reuse,
Gumbel), ``--arena_search`` the gates' (PUCT or Gumbel).
``--dirichlet_frac`` defaults to None and means 0.25, so that any explicit
Dirichlet flag with ``--search=gumbel`` is refused.

``--mesh=N`` runs the distributed learner (``parallel/``) on a world of N
ranks, one a card: torchrun's N processes, or this one process for N = 1
(a world of one, whose collectives still run).  ``--batch`` is global and
each rank plays its ``batch / N`` envs and trains on them; the gradients
are averaged by an all-reduce.  Rank 0 alone plays the gates, writes the
records and checkpoints, and on ``--resume`` reads the checkpoint and
broadcasts the parameters and optimizer state to the other ranks.  After
the first iteration of a run over several ranks every rank checks that
its parameters are rank 0's bit for bit (``parallel.replicas_differ``;
rank 0 prints the ``[mesh]`` line), and a rank that differs raises.

Randomness comes from one ``torch.Generator`` seeded from ``--seed``; a
resumed run re-seeds it from (seed, first iteration), as the JAX script
folds the iteration into its key; with ``--mesh`` each rank folds its rank
into that seed.  The gates' opponents (the initial net,
the best net) are copies of the module taken when they are fixed; the
trained module changes in place.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from twixt_for_open_spiel_tpu_torch.models.arena import arena_match
from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net, init_params
from twixt_for_open_spiel_tpu_torch.models.selfplay import (
    make_optimizer,
    selfplay_chunk,
    train_step,
)
from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset
from twixt_for_open_spiel_tpu_torch.parallel.envsharding import sharded_bit_reset
from twixt_for_open_spiel_tpu_torch.parallel.launch import initialize_world
from twixt_for_open_spiel_tpu_torch.parallel.learner_feed import (
    make_distributed_selfplay,
    make_distributed_train_step,
)
from twixt_for_open_spiel_tpu_torch.parallel.mesh import (
    broadcast_params,
    fold_seed as _fold,
    make_env_mesh,
    replicas_differ,
)
from twixt_for_open_spiel_tpu_torch.utils import serialization


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board_size", type=int, default=8)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--chunk_steps", type=int, default=24)
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=1100)
    ap.add_argument("--temp_moves", type=int, default=12,
                    help="opening plies with temperature sampling; greedy after")
    ap.add_argument("--search", default="puct", choices=["puct", "puct_reuse", "gumbel"],
                    help="self-play move generator")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dirichlet_alpha", type=float, default=None,
                    help="root-noise concentration (default 0.3); scale it down with "
                         "the action space (about 10/|legal|, 0.02 at board 24)")
    ap.add_argument("--dirichlet_frac", type=float, default=None,
                    help="root prior noise fraction (default 0.25)")
    ap.add_argument("--value_bootstrap", type=float, default=0.0,
                    help="weight of the truncation-bootstrap value targets on frames "
                         "whose game is unfinished at the chunk's end (0 = outcomes only)")
    ap.add_argument("--train_microbatch", type=int, default=1,
                    help="split the train step into K equal time slices with exact "
                         "gradient accumulation (the memory valve)")
    ap.add_argument("--arena_batch", type=int, default=256)
    ap.add_argument("--arena_sims", type=int, default=64)
    ap.add_argument("--arena_search", default="puct", choices=["puct", "gumbel"],
                    help="gate search: gumbel@16 is the cheap gate of big-board runs")
    ap.add_argument("--gates", default="100,200,300,400,500,600,700,800,900,1000",
                    help="comma-separated iterations at which to arena-gate")
    ap.add_argument("--mesh", type=int, default=0,
                    help="N>0: the distributed learner on a world of N ranks, one a card "
                         "(torchrun --nproc_per_node=N, or one process for N=1); 0 runs "
                         "locally")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --checkpoint_dir "
                         "(params, optimizer state, iteration, best-gate record)")
    ap.add_argument("--log", default=None, help="JSONL metrics file")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU run to validate the loop end to end")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU without --smoke's tiny budget")
    args = ap.parse_args(argv)

    if args.search == "gumbel" and (
            args.dirichlet_alpha is not None or args.dirichlet_frac is not None):
        ap.error("--dirichlet_alpha/--dirichlet_frac have no effect with --search=gumbel "
                 "(Gumbel explores via its own root perturbation); drop the flags or use "
                 "--search=puct")
    if args.dirichlet_frac is None:
        args.dirichlet_frac = 0.25
    if args.smoke:
        args.board_size, args.batch, args.chunk_steps = 5, 32, 8
        args.simulations, args.channels, args.blocks = 8, 16, 1
        args.iterations, args.arena_batch, args.arena_sims = 4, 16, 8
        args.gates = "2,4"
    if args.mesh < 0:
        ap.error(f"--mesh={args.mesh} must be >= 0")
    if args.mesh:
        if args.batch % args.mesh:
            ap.error(f"--batch={args.batch} is no multiple of --mesh={args.mesh}")
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        if world != args.mesh:
            ap.error(f"--mesh={args.mesh} needs a world of {args.mesh} ranks, one a card, "
                     f"and this one has {world} (WORLD_SIZE): run it under torchrun "
                     f"--nproc_per_node={args.mesh}, or as one process with --mesh=1")
    if not (args.smoke or args.cpu) and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --cpu or --smoke to run on the CPU\n")
    return args


def _snapshot(net):
    """A frozen copy of ``net`` on its device, for an opponent that must not
    follow the training."""
    return copy.deepcopy(net).requires_grad_(False)


def run(args) -> dict:
    """The training loop of ``args`` (from :func:`parse_args`), each record
    to stderr and to ``--log`` (rank 0's only, with ``--mesh``).  Returns
    the trained net, the initial and best nets, the best gate record and
    the first iteration run."""
    device = "cpu" if args.smoke or args.cpu else "cuda"
    mesh = None
    if args.mesh:
        initialize_world(device=device)
        mesh = make_env_mesh(device if device == "cpu" else None)
    lead = mesh is None or mesh.rank == 0
    logf = open(args.log, "a") if args.log and lead else None

    def emit(rec):
        if not lead:
            return
        line = json.dumps(rec)
        print(line, file=sys.stderr)
        if logf:
            logf.write(line + "\n")
            logf.flush()

    try:
        return _train(args, emit, device, mesh)
    finally:
        if logf:
            logf.close()


def _train(args, emit, device, mesh) -> dict:
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        device = mesh.device
    n = args.board_size
    gates = sorted(int(g) for g in args.gates.split(",") if g)
    if lead:
        print(f"[train] device={device} n={n} batch={args.batch} chunk={args.chunk_steps} "
              f"sims={args.simulations} net={args.channels}x{args.blocks} "
              f"iters={args.iterations} search={args.search} arena_search={args.arena_search} "
              f"gates={gates} mesh={args.mesh}", file=sys.stderr)
    net = init_params(create_net(n, channels=args.channels, blocks=args.blocks,
                                 device="cpu"), args.seed).to(device)
    init_net = _snapshot(net)
    opt = make_optimizer(net.parameters(), args.lr)

    def stream_seed(seed):  # each rank folds its rank in
        return seed if mesh is None else _fold(seed, mesh.rank)

    gen = torch.Generator(device=device).manual_seed(stream_seed(args.seed + 1))
    if mesh is None:
        def play(state):
            return selfplay_chunk(
                net, state, gen, board_size=n, num_steps=args.chunk_steps,
                num_simulations=args.simulations, temp_moves=args.temp_moves,
                search=args.search, dirichlet_alpha=args.dirichlet_alpha,
                dirichlet_frac=args.dirichlet_frac, value_bootstrap=args.value_bootstrap)

        def learn(sample):
            return train_step(net, opt, sample, microbatch=args.train_microbatch)

        state = bit_reset(n, args.batch, device)
    else:
        dist_play, _ = make_distributed_selfplay(
            call_net, n, args.chunk_steps, args.simulations, mesh, search=args.search,
            temp_moves=args.temp_moves, dirichlet_alpha=args.dirichlet_alpha,
            dirichlet_frac=args.dirichlet_frac, value_bootstrap=args.value_bootstrap)
        dist_learn, _ = make_distributed_train_step(call_net, opt, mesh,
                                                    microbatch=args.train_microbatch)

        def play(state):
            return dist_play(net, state, gen)

        def learn(sample):
            return dist_learn(net, sample)

        state = sharded_bit_reset(n, args.batch, mesh)

    def gate(candidate, it):
        t0 = time.perf_counter()
        tally = arena_match(candidate, init_net, gen, board_size=n, batch=args.arena_batch,
                            num_simulations=args.arena_sims, search=args.arena_search,
                            device=device)
        emit({"kind": "gate_vs_init", "iteration": it,
              **{k: float(tally[k]) for k in ("a_score", "a_wins", "b_wins", "draws", "games")},
              "secs": round(time.perf_counter() - t0, 1)})
        return tally["a_score"]

    best_score, best_net, best_it = -1.0, _snapshot(net), 0
    start_it = 1
    meta_path = best_dir = None
    if args.checkpoint_dir:
        meta_path = os.path.join(args.checkpoint_dir, "best_meta.json")
        best_dir = os.path.join(args.checkpoint_dir, "best")
    restored = None
    if args.resume and args.checkpoint_dir and lead:
        restored = serialization.restore_training(args.checkpoint_dir, device)
    if restored is not None:
        params, opt_state, last_it = restored
        net.load_state_dict(params)
        opt.load_state_dict(opt_state)
        start_it = last_it + 1
        rb = serialization.restore_training(best_dir, device)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if rb is not None:
                best_score, best_it = meta["a_score"], meta["iteration"]
                best_net.load_state_dict(rb[0])
            else:
                # a recorded score without restorable params would pair it
                # with the wrong (latest) params: let the next gate decide
                emit({"kind": "warn", "msg": "best_meta.json present but best/ restore "
                      "failed; resetting best record"})
        elif rb is not None:
            # a best/ written before best_meta.json existed: measure it again,
            # so a weaker later gate cannot overwrite the true best
            best_net.load_state_dict(rb[0])
            best_it = rb[2]
            emit({"kind": "warn", "msg": "best_meta.json missing; re-gating restored "
                  "best/ params"})
            best_score = gate(best_net, best_it)
            with open(meta_path, "w") as f:  # repair the layout
                json.dump({"a_score": best_score, "iteration": best_it}, f)
        emit({"kind": "resume", "from_iteration": last_it, "best_score": best_score,
              "best_iteration": best_it})
    if mesh is not None:
        # rank 0 alone reads the checkpoint; every rank takes its first
        # iteration, parameters and optimizer state (at a fresh start too)
        start_it = int(mesh.broadcast(torch.tensor([start_it], device=device))[0])
        broadcast_params(net, mesh, opt)
    if start_it > 1:
        # the stream restarts from the checkpointed iteration's fold, with
        # fresh env states: a recovery path, not a bitwise continuation
        gen.manual_seed(stream_seed(_fold(args.seed + 1, start_it)))

    t_start = time.perf_counter()
    for it in range(start_it, args.iterations + 1):
        t0 = time.perf_counter()
        state, sample = play(state)
        metrics = learn(sample)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        if it == start_it and mesh is not None and mesh.size > 1:
            differ = replicas_differ(net, mesh)
            if lead:
                print(f"[mesh] after iteration {it}: the {mesh.size} ranks' tensors that differ "
                      f"from rank 0's, by rank: {differ}", file=sys.stderr)
            if any(differ):
                raise RuntimeError(f"the ranks' parameters diverged at iteration {it}: {differ}")
        if it <= 3 or it % 10 == 0:
            emit({"kind": "train", "iteration": it, "loss": round(loss, 4),
                  "policy_loss": round(float(metrics["policy_loss"]), 4),
                  "value_loss": round(float(metrics["value_loss"]), 4),
                  "train_frames": int(metrics["train_frames"]),
                  "target_entropy": round(float(metrics["target_entropy"]), 3),
                  "secs": round(dt, 2),
                  "moves_per_s": round(args.batch * args.chunk_steps / dt)})
        if it in gates and lead:
            score = gate(net, it)
            if score > best_score:
                best_score, best_net, best_it = score, _snapshot(net), it
                if args.checkpoint_dir:
                    serialization.save_training(best_dir, net, opt, it)
                    with open(meta_path, "w") as f:
                        json.dump({"a_score": best_score, "iteration": best_it}, f)
            if args.checkpoint_dir:
                serialization.save_training(args.checkpoint_dir, net, opt, it)

    if lead:
        # the final gate: the best net against uniform random moves (B's net
        # is A's; random_b replaces B's moves)
        emit({"kind": "best", "iteration": best_it, "a_score": best_score})
        t0 = time.perf_counter()
        tally = arena_match(best_net, best_net, gen, board_size=n, batch=args.arena_batch,
                            num_simulations=args.arena_sims, random_b=True,
                            search=args.arena_search, device=device)
        emit({"kind": "gate_vs_random", "iteration": best_it,
              **{k: float(tally[k]) for k in ("a_score", "a_wins", "b_wins", "draws", "games")},
              "secs": round(time.perf_counter() - t0, 1)})
        emit({"kind": "done", "total_secs": round(time.perf_counter() - t_start, 1)})
    return {"net": net, "init_net": init_net, "best_net": best_net, "best_score": best_score,
            "best_iteration": best_it, "start_iteration": start_it}


def main(argv=None) -> int:
    run(parse_args(argv))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
