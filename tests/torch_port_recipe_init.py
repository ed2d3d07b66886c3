"""The port's training driver from another initial net: JAX's draw, so that
the port's per-iteration records can be read beside JAX's JSONLs with the
initial net held equal.

    # on the CPU, with the JAX package: JAX's PRNGKey(seed) draw of the
    # recipe's net, in the port's layout
    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tests/torch_port_recipe_init.py \\
        --write_jax_init=jax_init_b12.npz --board_size=12
    # on the card, torch only: the driver with that initial net
    PYTHONPATH=. python3 tests/torch_port_recipe_init.py --init=jax_init_b12.npz \\
        --board_size=12 --chunk_steps=32 --simulations=64 --temp_moves=16 \\
        --iterations=10 --gates= --log=from_jax_init.jsonl

Every other argument goes to ``twixt_for_open_spiel_tpu_torch.train_arena_gate``
as it is; only the driver's ``init_params`` is replaced, for this process,
by a load of the ``.npz`` (a diagnostic: the driver itself has no such
flag, as the JAX script has none).  JAX's draw depends on ``--seed`` and
the width flags (``--board_size``, ``--channels``, ``--blocks``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def write_jax_init(path: str, argv: list) -> None:
    import jax
    import jax.numpy as jnp

    from twixt_for_open_spiel_tpu.models import network as jnet
    from twixt_for_open_spiel_tpu_torch.models import convert
    from twixt_for_open_spiel_tpu_torch.train_arena_gate import parse_args

    args = parse_args(argv + ["--cpu"])
    n = args.board_size
    net = jnet.create_net(n, args.channels, args.blocks)
    obs = jnp.zeros((1, 12, n, n - 2), jnp.float32)
    tree = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(args.seed), obs))
    state = convert.params_from_flax(tree)
    np.savez(path, **{k: v.numpy() for k, v in state.items()})
    print(f"wrote {path}: {len(state)} leaves, "
          f"{sum(v.numel() for v in state.values())} parameters", file=sys.stderr)


def run_from(path: str, argv: list) -> None:
    from twixt_for_open_spiel_tpu_torch import train_arena_gate as driver

    loaded = {k: torch.from_numpy(v) for k, v in np.load(path).items()}

    def init_params(net, seed=0):
        del seed
        net.load_state_dict(loaded)
        return net

    driver.init_params = init_params
    sys.exit(driver.main(argv))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--write_jax_init", help="write JAX's initial net here (.npz)")
    group.add_argument("--init", help="run the driver from this initial net (.npz)")
    args, rest = ap.parse_known_args()
    if args.write_jax_init:
        write_jax_init(args.write_jax_init, rest)
    else:
        run_from(args.init, rest)


if __name__ == "__main__":
    main()
