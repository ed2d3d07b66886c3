"""AlphaZero-style self-play training over every rank (BASELINE config 5;
``twixt_for_open_spiel_tpu/examples/selfplay_train.py``, ported).

Runs the sharded self-play -> data-parallel learner loop of ``parallel/``:
the env batch split over the ranks, one rank a card, the gradients
averaged by an all-reduce, checkpoints through ``utils/serialization``
(written by rank 0, which alone prints).

One process (a world of one)::

    python -m twixt_for_open_spiel_tpu_torch.examples.selfplay_train \\
        --board_size=12 --batch=256 --chunk_steps=16 --simulations=64 \\
        --iterations=10 --checkpoint_dir=/tmp/twixt_az

N cards: one process a card, under torchrun (one host or many)::

    torchrun --nproc_per_node=4 -m twixt_for_open_spiel_tpu_torch.examples.selfplay_train ...

or the same command on every process with the cluster spec::

    python -m twixt_for_open_spiel_tpu_torch.examples.selfplay_train \\
        --coordinator=10.0.0.1:8476 --num_processes=8 --process_id=$RANK ...

``--batch`` is the GLOBAL env batch; each rank steps its ``batch / N``
envs.  ``--cpu`` runs the ranks on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net, init_params
from twixt_for_open_spiel_tpu_torch.models.selfplay import make_optimizer
from twixt_for_open_spiel_tpu_torch.parallel import (
    broadcast_params,
    initialize_world,
    make_distributed_selfplay,
    make_distributed_train_step,
    make_env_mesh,
    rank_generator,
    sharded_bit_reset,
)
from twixt_for_open_spiel_tpu_torch.utils import serialization


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--chunk_steps", type=int, default=16)
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--temp_moves", type=int, default=10 ** 9,
                    help="opening plies with temperature sampling (puct search)")
    ap.add_argument("--search", choices=("puct", "puct_reuse", "gumbel"), default="puct",
                    help="root search: AlphaZero PUCT+Dirichlet or Gumbel sequential halving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (runs without torchrun)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU (gloo)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --cpu to run on the CPU\n")

    device = "cpu" if args.cpu else "cuda"
    rank, world = initialize_world(args.coordinator, args.num_processes, args.process_id,
                                   device=device)
    mesh = make_env_mesh(device if args.cpu else None)
    is_lead = rank == 0
    if args.batch % world:
        ap.error(f"--batch={args.batch} is no multiple of the {world} ranks")

    n = args.board_size
    if is_lead:
        print(f"mesh: {world} ranks, {args.batch // world} envs each, on "
              f"{mesh.device.type} ({dist.get_backend()})")

    net = init_params(create_net(n, channels=args.channels, blocks=args.blocks, device="cpu"),
                      args.seed).to(mesh.device)
    opt = make_optimizer(net.parameters(), args.lr)

    selfplay, _ = make_distributed_selfplay(
        call_net, n, num_steps=args.chunk_steps, num_simulations=args.simulations, mesh=mesh,
        search=args.search, temp_moves=args.temp_moves)
    trainer, _ = make_distributed_train_step(call_net, opt, mesh)

    restored = None
    if args.checkpoint_dir and is_lead:
        restored = serialization.restore_training(args.checkpoint_dir, mesh.device)
    start_iter = 0
    if restored is not None:
        params, opt_state, start_iter = restored
        net.load_state_dict(params)
        opt.load_state_dict(opt_state)
        print(f"restored checkpoint at iteration {start_iter}")
    # rank 0 alone reads the checkpoint; every rank takes its iteration,
    # parameters and optimizer state
    start_iter = int(mesh.broadcast(torch.tensor([start_iter], device=mesh.device))[0])
    broadcast_params(net, mesh, opt)

    state = sharded_bit_reset(n, args.batch, mesh)
    gen = rank_generator(args.seed + 1, mesh)
    for it in range(start_iter, args.iterations):
        t0 = time.perf_counter()
        state, sample = selfplay(net, state, gen)
        metrics = trainer(net, sample)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        frames = args.batch * args.chunk_steps
        if is_lead:
            print(f"iter {it}: loss={loss:.4f} "
                  f"policy={float(metrics['policy_loss']):.4f} "
                  f"value={float(metrics['value_loss']):.4f} "
                  f"train_frames={int(metrics['train_frames'])} "
                  f"({frames / dt:,.0f} mcts-env-steps/s)", flush=True)
        if args.checkpoint_dir and is_lead:
            serialization.save_training(args.checkpoint_dir, net, opt, it + 1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
