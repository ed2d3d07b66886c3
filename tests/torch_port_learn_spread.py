"""The distributed learn check's recipe, trained by JAX and by the port over
several self-play seeds, on the CPU: how far the check's outcome moves with
the random stream alone, in the reference and in the port.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/torch_port_learn_spread.py --seeds=0-16

The recipe is ``tests/test_sharding.py::test_dist_training_improves_gate``'s
(board 5, batch 32, chunk 8, 8 simulations, a 16x1 bf16 net, AdamW 1e-3, 24
iterations), trained locally: JAX from ``PRNGKey(0)``'s weights with the
self-play key ``PRNGKey(seed)`` split each iteration, the port from
``create_net``'s seed-0 weights with a generator seeded by ``seed``.  Each
trained net then plays its initial net in the check's 32-game arena (seed
123) and in 256 games (seed 7).  One JSON line a run, in the order the runs
end; ``--workers`` processes at once (about 50 s a run on one CPU core).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import functools
import json
import multiprocessing

RECIPE = {"board_size": 5, "batch": 32, "chunk_steps": 8, "simulations": 8, "channels": 16,
          "blocks": 1, "lr": 1e-3, "iterations": 24}
ARENAS = ((32, 123), (256, 7))  # (games, arena seed)


def jax_run(seed: int) -> dict:
    import jax

    from twixt_for_open_spiel_tpu.models import arena_match
    from twixt_for_open_spiel_tpu.models.network import create_net, init_params
    from twixt_for_open_spiel_tpu.models.selfplay import make_optimizer, selfplay_chunk, train_step
    from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset

    c = RECIPE
    n = c["board_size"]
    net = create_net(n, channels=c["channels"], blocks=c["blocks"])
    params0 = init_params(net, jax.random.PRNGKey(0))
    opt = make_optimizer(c["lr"])
    play = jax.jit(functools.partial(selfplay_chunk, net_apply=net.apply, board_size=n,
                                     num_steps=c["chunk_steps"],
                                     num_simulations=c["simulations"]))
    train = jax.jit(functools.partial(train_step, net_apply=net.apply, optimizer=opt))
    params, opt_state, state = params0, opt.init(params0), bit_reset(n, c["batch"])
    key = jax.random.PRNGKey(seed)
    for _ in range(c["iterations"]):
        key, k = jax.random.split(key)
        state, sample = play(params, state, k)
        params, opt_state, metrics = train(params, opt_state, sample)
    scores = {f"a_score_{games}": float(arena_match(
        params, params0, jax.random.PRNGKey(arena_seed), net_apply=net.apply, board_size=n,
        batch=games, num_simulations=c["simulations"])["a_score"])
        for games, arena_seed in ARENAS}
    return {"side": "jax", "seed": seed, "loss": float(metrics["loss"]), **scores}


def torch_run(seed: int) -> dict:
    import torch

    from twixt_for_open_spiel_tpu_torch.models.arena import arena_match
    from twixt_for_open_spiel_tpu_torch.models.network import create_net
    from twixt_for_open_spiel_tpu_torch.models.selfplay import (
        make_optimizer,
        selfplay_chunk,
        train_step,
    )
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset

    torch.set_num_threads(1)
    c = RECIPE
    n = c["board_size"]
    net = create_net(n, c["channels"], c["blocks"], device="cpu")
    init = copy.deepcopy(net).requires_grad_(False)
    opt = make_optimizer(net.parameters(), c["lr"])
    gen = torch.Generator().manual_seed(seed)
    state = bit_reset(n, c["batch"], "cpu")
    for _ in range(c["iterations"]):
        state, sample = selfplay_chunk(net, state, gen, board_size=n,
                                       num_steps=c["chunk_steps"],
                                       num_simulations=c["simulations"])
        metrics = train_step(net, opt, sample)
    scores = {f"a_score_{games}": float(arena_match(
        net, init, torch.Generator().manual_seed(arena_seed), board_size=n, batch=games,
        num_simulations=c["simulations"], device="cpu")["a_score"])
        for games, arena_seed in ARENAS}
    return {"side": "torch", "seed": seed, "loss": float(metrics["loss"]), **scores}


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", default="0-7", help="e.g. 0-16 or 1,5,9")
    ap.add_argument("--sides", default="jax,torch")
    ap.add_argument("--workers", type=int, default=4, help="processes at once")
    args = ap.parse_args(argv)
    runs = {"jax": jax_run, "torch": torch_run}
    jobs = [(runs[side], seed) for side in args.sides.split(",") for seed in _seeds(args.seeds)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
        for done in concurrent.futures.as_completed([pool.submit(fn, s) for fn, s in jobs]):
            print(json.dumps(done.result()), flush=True)


if __name__ == "__main__":
    main()
