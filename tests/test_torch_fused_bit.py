"""The fused rollout wrapper: on CPU tensors its plain version equals the JAX
Pallas kernel (run in interpret mode) bit for bit; on anything else it
launches the CUDA kernel or raises, and never falls back.

The kernel itself runs only on the card; ``chip_smoke.py`` holds it to this
plain version there.
"""

import jax
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu.ops.fused_bit_rollout import (
    fused_bit_rollout as jax_fused,
)
from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr

torch.set_num_threads(1)

_reset_j = jax.jit(jbit.bit_reset, static_argnums=(0, 1))


def assert_same(jax_out, port_out):
    (jf, js), (tf, ts) = jax_out[:2], port_out[:2]
    jl = [np.asarray(x).astype(np.int64) for x in jax.tree_util.tree_leaves(jf)]
    tl = [x.numpy().astype(np.int64) for x in tbit.bitstate_leaves(tf)]
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
    assert int(ts["episodes"]) == int(js["episodes"])
    np.testing.assert_array_equal(ts["results"].numpy(), np.asarray(js["results"]))


@pytest.mark.parametrize(
    "n,b,tile,steps,seed",
    [(5, 256, 128, 60, 3), (8, 256, 256, 50, 11), (12, 128, 128, 40, 7)],
)
def test_wrapper_matches_jax_kernel(n, b, tile, steps, seed):
    want = jax_fused(seed, n, steps, _reset_j(n, b), tile=tile, interpret=True)
    got = fbr.fused_bit_rollout(seed, n, steps, tbit.bit_reset(n, b, "cpu"))
    assert_same(want, got)
    assert int(got[1]["episodes"]) > 0 or n >= 12


@pytest.mark.parametrize("n,b,steps,seed", [(5, 512, 45, 5), (8, 200, 40, 13)])
def test_wrapper_multi_tile_and_ragged_batch(n, b, steps, seed):
    # 512 envs span four 128-env TPU tiles; 200 is no multiple of 128: the
    # noise must follow the global env index either way
    want = jbit.bit_random_rollout(seed, n, steps, _reset_j(n, b))
    got = fbr.fused_bit_rollout(seed, n, steps, tbit.bit_reset(n, b, "cpu"))
    assert_same(want, got)
    assert int(got[1]["episodes"]) > 0


def test_emit_obs_matches_jax_kernel_and_xla_wire():
    n, b, tile, steps, seed = 5, 256, 128, 30, 9
    jk = jax_fused(
        seed, n, steps, _reset_j(n, b), tile=tile, interpret=True, emit_obs=True
    )
    got = fbr.fused_bit_rollout(
        seed, n, steps, tbit.bit_reset(n, b, "cpu"), emit_obs=True
    )
    assert_same(jk, got)
    assert int(got[1]["episodes"]) > 0  # the stream crosses auto-resets
    obs = got[2]
    p = n + 6
    assert obs.shape == (steps, 12, p, b) and obs.dtype == torch.int32
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jk[2]).astype(np.int64))
    # the XLA emission: batch-leading [T, B, 12*P]
    _, _, wire = jbit.bit_rollout_emit_obs(seed, n, steps, _reset_j(n, b), packed=True)
    ref = np.asarray(wire).reshape(steps, b, 12, p).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(obs.numpy(), ref.astype(np.int64))
    # the port's own emitter gives the same wire
    _, _, twire = tbit.bit_rollout_emit_obs(
        seed, n, steps, tbit.bit_reset(n, b, "cpu"), packed=True
    )
    np.testing.assert_array_equal(twire.numpy(), np.asarray(wire).astype(np.int64))


def test_wrapper_leaves_input_untouched_and_counts_no_cpu_launch():
    before = fbr.fused_bit_rollout.launches
    bs = tbit.bit_reset(5, 64, "cpu")
    copy = [x.clone() for x in tbit.bitstate_leaves(bs)]
    fbr.fused_bit_rollout(1, 5, 20, bs)
    assert fbr.fused_bit_rollout.launches == before == 0
    for a, b in zip(copy, tbit.bitstate_leaves(bs)):
        assert torch.equal(a, b)


def test_no_fallback_off_cpu():
    bs = tbit.bit_reset(5, 8, "cpu")
    # the kernel entry takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensors"):
        fbr._launch(0, 5, 4, bs, False)
    # a device with no kernel raises instead of running the plain version
    meta = tbit.bitstate_from_leaves(x.to("meta") for x in tbit.bitstate_leaves(bs))
    with pytest.raises(ValueError, match="no kernel"):
        fbr.fused_bit_rollout(0, 5, 4, meta)
    assert fbr.fused_bit_rollout.launches == 0


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(_cuda, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _cuda.load("broken")
    assert not (tmp_path / "_build" / "libbroken.so").exists()


def test_state_checks():
    bs = tbit.bit_reset(5, 8, "cpu")
    fbr._check_state(bs, 5)
    with pytest.raises(ValueError, match="planes must be"):
        fbr._check_state(bs, 6)
    bad = bs._replace(compid=bs.compid.to(torch.int32))
    with pytest.raises(ValueError, match="leaf 16"):
        fbr._check_state(bad, 5)
    with pytest.raises(ValueError, match="outside"):
        fbr._check_state(bs, 25)
