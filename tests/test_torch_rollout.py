"""Batched lockstep envs on the port's canonical engine: the invariants of
``tests/test_rollout.py`` with a ``torch.Generator`` in place of a
``jax.random`` key, and the deterministic parts held equal to JAX.

The two random streams cannot be bit-matched, so the sampler is pinned by
legality and by a chi-square test of uniformity on one position.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import rollout as jroll
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import fused_tensor_rollout as ftr
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import rollout as troll
from twixt_for_open_spiel_tpu_torch.ops import state as tstate
from twixt_for_open_spiel_tpu_torch.ops import store_skeleton as sk

torch.set_num_threads(1)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_batch_reset_shapes_and_matches_jax():
    s = troll.batch_reset(5, 16, "cpu")
    assert s.color.shape == (11, 11, 16)
    assert s.legal.shape == (2, 11, 11, 16)
    assert s.current_player.shape == (16,)
    assert troll.batch_size(s) == 16
    want = jax.jit(jroll.batch_reset, static_argnums=(0, 1))(5, 16)
    for name, a, b in zip(s._fields, want, s):
        assert np.asarray(a).dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    one = troll.env_slice(s, 3)
    for a, b in zip(one, tstate.reset(5, "cpu")):
        assert torch.equal(a, b)


def test_sampled_actions_always_legal():
    n, b = 5, 32
    s = troll.batch_reset(n, b, "cpu")
    g = gen(0)
    for i in range(30):
        actions = troll.sample_legal_action(s, g, n)
        assert actions.dtype == torch.int32
        mask = tstate.legal_mask_flat(s, s.current_player.clamp(0, 1), n)
        assert mask[actions.long(), torch.arange(b)].all(), i
        s, done, result = troll.step_auto_reset(s, actions, n)
        # auto-reset: no env is ever left terminal
        assert (s.result == geo.RESULT_OPEN).all()
        assert torch.equal(done, result != geo.RESULT_OPEN)


def test_step_auto_reset_matches_jax():
    n, b = 5, 64
    final, _ = troll.random_rollout(gen(1), n, 9, troll.batch_reset(n, b, "cpu"))
    actions = troll.sample_legal_action(final, gen(2), n)
    want = jax.jit(jroll.step_auto_reset, static_argnums=2)(
        jroll.State(*[np.asarray(x) for x in final]), actions.numpy(), n
    )
    got = troll.step_auto_reset(final, actions, n)
    assert got[1].any()  # some envs end and are reset
    for name, a, c in zip(final._fields, want[0], got[0]):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_random_rollout_completes_episodes():
    n, b, steps = 5, 64, 64
    final, stats = troll.random_rollout(gen(7), n, steps, troll.batch_reset(n, b, "cpu"))
    episodes = int(stats["episodes"])
    results = stats["results"].tolist()
    assert episodes > 0
    assert results[geo.RESULT_OPEN] == 0
    assert sum(results[1:]) == episodes
    assert final.color.shape == (11, 11, b)
    assert (final.result == geo.RESULT_OPEN).all()


def test_rollout_deterministic_under_seed():
    n, b, steps = 5, 16, 32
    s = troll.batch_reset(n, b, "cpu")
    f1, st1 = troll.random_rollout(gen(3), n, steps, s)
    f2, st2 = troll.random_rollout(gen(3), n, steps, s)
    assert int(st1["episodes"]) == int(st2["episodes"])
    for a, c in zip(f1, f2):
        assert torch.equal(a, c)
    f3, _ = troll.random_rollout(gen(4), n, steps, s)
    assert not torch.equal(f1.color, f3.color)


def test_sample_legal_action_uniform_chi_square():
    # red's 15 legal cells of the 5x5 opening, drawn once in each of 6000
    # envs: chi-square with 14 degrees of freedom below its 0.999 quantile
    n, b = 5, 6000
    s = troll.batch_reset(n, b, "cpu")
    acts = troll.sample_legal_action(s, gen(11), n).numpy()
    legal = np.nonzero(tstate.legal_mask_flat(s, 0, n)[:, 0].numpy())[0]
    assert len(legal) == 15 and set(acts.tolist()) <= set(legal.tolist())
    counts = np.bincount(acts, minlength=n * n)[legal]
    expected = b / len(legal)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 36.12, (chi2, counts)


def test_bitboard_round_trip_of_rollout_states():
    # mid-game canonical states survive from_state / to_state
    n = 8
    s, _ = troll.random_rollout(gen(5), n, 20, troll.batch_reset(n, 16, "cpu"))
    back = tbit.to_state(tbit.from_state(s), n)
    for name, a, c in zip(s._fields, s, back):
        assert a.dtype == c.dtype, name
        assert torch.equal(a, c), name


@pytest.mark.parametrize(
    "fn",
    [tstate.reset, troll.batch_reset, tbit.bit_reset, tbit.bitstate_from_numpy,
     sk.store_skeleton],
    ids=lambda f: f.__name__,
)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_fused_rollout_follows_its_input_device():
    # no device argument: the kernel's wrapper runs where the state lies
    params = inspect.signature(ftr.fused_random_rollout).parameters
    assert "device" not in params and params["tile"].default == 256
