"""Config-5 scaling study over the simulation budget and the env batch
(``scripts/bench_search_scaling.py``, ported).

    python3 -m twixt_for_open_spiel_tpu_torch.bench_search_scaling [--configs=512:64,1024:64]
    python3 -m twixt_for_open_spiel_tpu_torch.bench_search_scaling --quick   # tiny, the CPU

On the card, board 12 and the 64x4 net (bf16), the JAX script's configs
(batch:simulations): the simulations axis 512:64, 512:128, 512:256,
512:512 and the batch axis 1024:64, 2048:64, 4096:64 (``--configs`` takes a
subset).  For each: a fresh net and optimizer, two warm-up iterations
(``selfplay_chunk``, then ``train_step`` on its frames), then ``--reps``
self-play chunks alone (a) and ``--reps`` full iterations (b), on the host
clock with the card synchronised at the end of each.  Prints moves/s,
simulations/s, the full iteration, µs a simulation, the analytic bytes of
the search tree (:func:`tree_bytes`) and the card's peak memory
(``torch.cuda.max_memory_allocated``, reset for each config).  ``--quick``
runs the JAX script's CPU configs (board 5, chunk 4, a 16x1 net).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.models.mcts import _AMASK_MAX_NODES
from twixt_for_open_spiel_tpu_torch.models.network import create_net
from twixt_for_open_spiel_tpu_torch.models.selfplay import make_optimizer, selfplay_chunk, train_step
from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset
from twixt_for_open_spiel_tpu_torch.ops.state import padded_size

CONFIGS = [(512, 64), (512, 128), (512, 256), (512, 512), (1024, 64), (2048, 64), (4096, 64)]
QUICK = {"board_size": 5, "chunk": 4, "channels": 16, "blocks": 1,
         "configs": [(16, 4), (16, 8), (32, 4)]}


def tree_bytes(board_size: int, batch: int, sims: int) -> int:
    """Bytes of the ``models/mcts.py`` ``Tree`` that ``_init_tree``
    allocates for one search at these statics (``nodes = sims + 1``): the
    per-node stats (int32 visits, float32 value sums, edge priors and
    terminal values, int64 parents and actions, bool terminal and linked
    flags), the float32 ``[B, nodes, A]`` priors, the int64 ``[B, A]`` root
    children, the node states (int32 ``[nodes, 16, P, B]`` planes, int16
    ``[nodes, n, n, B]`` component ids, int32 ``[nodes, 5, B]`` scalars) and
    the ancestor masks with their depths: bool ``[B, nodes, nodes]`` and
    int32 ``[B, nodes]`` when the "auto" backup takes them (nodes <=
    ``_AMASK_MAX_NODES``), else ``[B, 1, 1]`` and ``[B, 1]`` placeholders."""
    n, a, nodes = board_size, board_size * board_size, sims + 1
    p = padded_size(n)
    per_node = 4 + 4 + 8 + 8 + 4 + 1 + 4 + 1  # visit .. linked
    mask_nodes = nodes if nodes <= _AMASK_MAX_NODES else 1
    return (
        batch * nodes * per_node
        + batch * nodes * a * 4              # uprior f32
        + batch * a * 8                      # root_child i64
        + batch * mask_nodes * mask_nodes    # amask bool
        + batch * mask_nodes * 4             # depth i32
        + nodes * 16 * p * batch * 4         # planes i32
        + nodes * n * n * batch * 2          # compid i16
        + nodes * 5 * batch * 4              # scalars i32
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--board_size", type=int, default=12)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true", help="tiny configs on the CPU")
    ap.add_argument("--configs", default=None,
                    help="subset as batch:sims pairs, e.g. 512:64,1024:64")
    args = ap.parse_args(argv)
    if args.quick:
        for k, v in QUICK.items():
            setattr(args, k, v)
    else:
        if not torch.cuda.is_available():
            ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
        args.configs = ([tuple(int(v) for v in c.split(":")) for c in args.configs.split(",") if c]
                        if args.configs else CONFIGS)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device("cpu" if args.quick else "cuda")
    n, chunk = args.board_size, args.chunk
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[scaling] device={device} ({where}) n={n} chunk={chunk} "
          f"net={args.channels}x{args.blocks}", file=sys.stderr)
    for batch, sims in args.configs:
        net = create_net(n, args.channels, args.blocks, device=device)
        opt = make_optimizer(net.parameters(), 1e-3)
        gen = torch.Generator(device=device).manual_seed(1)
        state = bit_reset(n, batch, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        def sp(state):
            return selfplay_chunk(net, state, gen, board_size=n, num_steps=chunk,
                                  num_simulations=sims)

        t_c0 = time.perf_counter()
        for _ in range(2):  # warm-up, the trained net playing the next chunk
            state, sample = sp(state)
            metrics = train_step(net, opt, sample)
        float(metrics["loss"])
        warm_s = time.perf_counter() - t_c0

        t0 = time.perf_counter()  # (a) self-play alone
        for _ in range(args.reps):
            state, sample = sp(state)
        float(sample.weight.sum())  # waits for the card
        dt_sp = (time.perf_counter() - t0) / args.reps

        t0 = time.perf_counter()  # (b) the full self-play -> train iteration
        for _ in range(args.reps):
            state, sample = sp(state)
            metrics = train_step(net, opt, sample)
        float(metrics["loss"])
        dt_full = (time.perf_counter() - t0) / args.reps

        moves = batch * chunk
        mem = (f" peak_memory={torch.cuda.max_memory_allocated(device) / 2**30} GiB"
               if device.type == "cuda" else "")
        print(f"[scaling n={n} batch={batch} sims={sims} chunk={chunk}] selfplay {dt_sp * 1e3} ms "
              f"-> {moves / dt_sp} moves/s, {moves * sims / dt_sp} sims/s | full iter "
              f"{dt_full * 1e3} ms -> {moves / dt_full} moves/s | per-sim "
              f"{dt_sp / (chunk * sims) * 1e6} us | tree {tree_bytes(n, batch, sims) / 2**30} "
              f"GiB{mem} (frames {moves}; warm-up {warm_s} s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
