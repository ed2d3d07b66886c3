"""The JAX anchor of the port: digests of JAX rollouts, pinned in a fixture.

``tests/fixtures/torch_port_rollout_digests.json`` holds, for two
configurations of the rollout benchmark, the sha256 digest
(``twixt_for_open_spiel_tpu_torch.ops.bitboard.state_digest``) of the final
state of the JAX ``bit_random_rollout`` from ``bit_reset``, with its
``episodes`` and ``results``.  ``chip_smoke.py``, which cannot import jax,
holds the CUDA kernel to these numbers on the card.

This file recomputes the JAX side and checks the port's plain version
against JAX at a small size, so the digest function itself is pinned.
Regenerate the fixture with ``python tests/test_torch_digests.py``.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_rollout_digests.json"
CASES = [(8, 4096, 1000, 0), (24, 4096, 300, 0)]


def jax_rollout_record(n, batch, steps, seed):
    final, stats = jbit.bit_random_rollout(seed, n, steps, jbit.bit_reset(n, batch))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(final)]
    return {
        "board_size": n,
        "batch": batch,
        "num_steps": steps,
        "seed": seed,
        "digest": tbit.state_digest(tbit.bitstate_from_numpy(leaves)),
        "episodes": int(stats["episodes"]),
        "results": [int(r) for r in np.asarray(stats["results"])],
    }


@pytest.mark.parametrize("case", CASES, ids=lambda c: "n{}_b{}_t{}_s{}".format(*c))
def test_fixture_matches_jax(case):
    stored = {
        (c["board_size"], c["batch"], c["num_steps"], c["seed"]): c
        for c in json.loads(FIXTURE.read_text())["cases"]
    }
    assert stored[case] == jax_rollout_record(*case)


def test_port_digest_matches_jax_small():
    n, batch, steps, seed = 5, 128, 40, 2
    want = jax_rollout_record(n, batch, steps, seed)
    final, stats = tbit.bit_random_rollout(seed, n, steps, tbit.bit_reset(n, batch))
    assert tbit.state_digest(final) == want["digest"]
    assert int(stats["episodes"]) == want["episodes"] > 0
    assert stats["results"].tolist() == want["results"]


def test_digest_sees_every_leaf():
    bs = tbit.bit_reset(5, 4)
    base = tbit.state_digest(bs)
    for i in range(tbit.NUM_LEAVES):
        leaves = [x.clone() for x in tbit.bitstate_leaves(bs)]
        leaves[i].view(-1)[-1] += 1
        assert tbit.state_digest(tbit.bitstate_from_leaves(leaves)) != base, i


if __name__ == "__main__":
    FIXTURE.write_text(
        json.dumps({"cases": [jax_rollout_record(*c) for c in CASES]}, indent=1)
        + "\n"
    )
    print(FIXTURE.read_text())
