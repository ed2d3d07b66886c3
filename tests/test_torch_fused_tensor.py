"""The canonical-engine fused rollout: on CPU tensors the wrapper's plain
version equals the JAX Pallas kernel (``scripts/archive_fused_tensor_rollout.py``,
run in interpret mode) bit for bit; on anything else it launches the CUDA
kernel or raises, and never falls back.

``tests/fixtures/torch_port_tensor_rollout_digests.json`` pins the JAX
kernel's final-state digest, actions digest and result histogram at a few
sizes; ``chip_smoke.py``, which cannot import jax, holds the CUDA kernel to
them on the card.  Regenerate the fixture with
``PYTHONPATH=. python tests/test_torch_fused_tensor.py``.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
from archive_fused_tensor_rollout import fused_random_rollout as jax_fused  # noqa: E402
from archive_fused_tensor_rollout import rollout_stats as jax_stats  # noqa: E402

from twixt_for_open_spiel_tpu.ops import rollout as jroll  # noqa: E402
from twixt_for_open_spiel_tpu_torch.ops import fused_tensor_rollout as ftr  # noqa: E402
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo  # noqa: E402
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll  # noqa: E402
from twixt_for_open_spiel_tpu_torch.ops import state as tstate  # noqa: E402

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_tensor_rollout_digests.json"
# (board_size, batch, num_steps, seed, tile): several programs per batch,
# a tile below the default, and the full-width board
FIXTURE_CASES = [
    (5, 512, 60, 3, 256),
    (8, 256, 120, 0, 128),
    (12, 256, 60, 7, 256),
    (24, 256, 24, 1, 256),
]


def record(n, batch, steps, seed, tile, final, actions, results):
    stats = ftr.rollout_stats(torch.from_numpy(np.array(results)))
    return {
        "board_size": n, "batch": batch, "num_steps": steps, "seed": seed,
        "tile": tile,
        "digest": tstate.state_digest([np.asarray(x) for x in final]),
        "actions_digest": tstate.state_digest([np.asarray(actions)]),
        "episodes": int(stats["episodes"]),
        "results": stats["results"].tolist(),
    }


def jax_record(n, batch, steps, seed, tile):
    out = jax_fused(seed, n, steps, jroll.batch_reset(n, batch), tile=tile, interpret=True)
    return record(n, batch, steps, seed, tile, *out)


def stored_cases():
    return {
        (c["board_size"], c["batch"], c["num_steps"], c["seed"], c["tile"]): c
        for c in json.loads(FIXTURE.read_text())["cases"]
    }


def assert_same_rollout(jax_out, port_out):
    (jf, ja, jr), (tf, ta, tr) = jax_out, port_out
    assert tf._fields == jf._fields
    for name, a, b in zip(jf._fields, jf, tf):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert ta.dtype == tr.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize(
    "n,b,tile,steps", [(5, 16, 8, 40), (8, 8, 8, 30), (24, 8, 8, 4)]
)
def test_plain_matches_jax_kernel(n, b, tile, steps):
    want = jax_fused(7, n, steps, jroll.batch_reset(n, b), tile=tile, interpret=True)
    got = ftr.fused_random_rollout(7, n, steps, troll.batch_reset(n, b, "cpu"), tile=tile)
    assert_same_rollout(want, got)


@pytest.mark.parametrize("case", FIXTURE_CASES, ids=lambda c: "n{}_b{}_k{}_s{}_t{}".format(*c))
def test_fixture_matches_jax(case):
    assert stored_cases()[case] == jax_record(*case)


@pytest.mark.parametrize("case", FIXTURE_CASES, ids=lambda c: "n{}_b{}_k{}_s{}_t{}".format(*c))
def test_plain_matches_fixture(case):
    n, batch, steps, seed, tile = case
    out = ftr.fused_random_rollout(
        seed, n, steps, troll.batch_reset(n, batch, "cpu"), tile=tile
    )
    assert record(*case, *out) == stored_cases()[case]


@pytest.mark.parametrize("n,b,tile,steps", [(5, 16, 8, 40), (8, 32, 16, 40)])
def test_recorded_actions_replay_through_step_auto_reset(n, b, tile, steps):
    # every recorded action was legal when taken, and the plain batched
    # step reproduces the results and the final state
    state0 = troll.batch_reset(n, b, "cpu")
    final, actions, results = ftr.fused_random_rollout(3, n, steps, state0, tile=tile)
    s = state0
    for k in range(steps):
        mask = tstate.legal_mask_flat(s, s.current_player.clamp(0, 1), n)
        assert mask[actions[k].long(), torch.arange(b)].all(), k
        s, done, result = troll.step_auto_reset(s, actions[k], n)
        assert torch.equal(result, results[k]), k
    for name, a, c in zip(final._fields, final, s):
        assert torch.equal(a, c), name


def test_rollout_stats_match_jax():
    n, b, tile, steps = 5, 16, 8, 60
    _, _, results = ftr.fused_random_rollout(3, n, steps, troll.batch_reset(n, b, "cpu"), tile=tile)
    stats = ftr.rollout_stats(results)
    want = jax_stats(results.numpy())
    assert int(stats["episodes"]) == int(want["episodes"]) > 0
    assert stats["results"].tolist() == np.asarray(want["results"]).tolist()
    assert stats["results"][geo.RESULT_OPEN] == 0
    assert int(stats["results"].sum()) == int(stats["episodes"])


def test_deterministic_and_sensitive_to_seed_and_tile():
    n, b, steps = 5, 16, 20
    s = troll.batch_reset(n, b, "cpu")
    a1 = ftr.fused_random_rollout(11, n, steps, s, tile=8)[1]
    a2 = ftr.fused_random_rollout(11, n, steps, s, tile=8)[1]
    a3 = ftr.fused_random_rollout(12, n, steps, s, tile=8)[1]
    a4 = ftr.fused_random_rollout(11, n, steps, s, tile=16)[1]
    assert torch.equal(a1, a2)
    assert not torch.equal(a1, a3)
    # tile keys the stream: the first tile's envs agree, the second's differ
    assert torch.equal(a1[:, :8], a4[:, :8])
    assert not torch.equal(a1[:, 8:], a4[:, 8:])


def test_batch_must_be_a_multiple_of_tile():
    s = troll.batch_reset(5, 24, "cpu")
    with pytest.raises(ValueError, match="multiple of tile 16"):
        ftr.fused_random_rollout(0, 5, 4, s, tile=16)
    with pytest.raises(ValueError, match="multiple of tile"):
        ftr.fused_random_rollout(0, 5, 4, s)  # the default tile, 256


def test_wrapper_leaves_input_untouched_and_counts_no_cpu_launch():
    before = ftr.fused_random_rollout.launches
    s = troll.batch_reset(5, 16, "cpu")
    copy = [x.clone() for x in s]
    ftr.fused_random_rollout(1, 5, 30, s, tile=8)
    assert ftr.fused_random_rollout.launches == before == 0
    for a, b in zip(copy, s):
        assert torch.equal(a, b)


def test_no_fallback_off_cpu():
    s = troll.batch_reset(5, 8, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ftr._launch(0, 5, 4, s, 8)
    meta = tstate.State(*[x.to("meta") for x in s])
    with pytest.raises(ValueError, match="no kernel"):
        ftr.fused_random_rollout(0, 5, 4, meta, tile=8)
    assert ftr.fused_random_rollout.launches == 0


def test_state_checks():
    s = troll.batch_reset(5, 8, "cpu")
    assert ftr._check_state(s, 5, 8) == 8
    with pytest.raises(ValueError, match="color: want shape"):
        ftr._check_state(s, 6, 8)
    with pytest.raises(ValueError, match="compid"):
        ftr._check_state(s._replace(compid=s.compid.to(torch.int32)), 5, 8)
    with pytest.raises(ValueError, match="outside"):
        ftr._check_state(s, 25, 8)
    with pytest.raises(ValueError, match="1-D trailing env batch"):
        ftr._check_state(tstate.reset(5, "cpu"), 5, 8)


def test_int32_working_copy_round_trips():
    # the kernel's int32 layout converts back to the canonical dtypes
    n = 8
    s, _ = troll.random_rollout(torch.Generator().manual_seed(2), n, 12, troll.batch_reset(n, 8, "cpu"))
    back = ftr._from_int32(ftr._cells(s), ftr._scalars(s))
    for name, a, b in zip(s._fields, s, back):
        assert a.dtype == b.dtype and torch.equal(a, b), name


if __name__ == "__main__":
    FIXTURE.write_text(
        json.dumps({"cases": [jax_record(*c) for c in FIXTURE_CASES]}, indent=1) + "\n"
    )
    print(FIXTURE.read_text())
