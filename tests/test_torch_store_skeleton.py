"""The store-stream probe: its plain version equals the JAX DMA skeleton
(``scripts/repro_mosaic_dma_tile.py::build_skeleton``, run in TPU interpret
mode on the CPU), and off the CPU the wrapper launches the CUDA kernel or
raises.  ``chip_smoke.py`` holds the kernel to the plain version on the
card."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
from repro_mosaic_dma_tile import build_skeleton  # noqa: E402

from twixt_for_open_spiel_tpu_torch.ops import store_skeleton as sk  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "rows,steps,subl,lanes,grid", [(6, 4, 2, 128, 2), (5, 3, 1, 128, 3), (36, 2, 8, 128, 1)]
)
def test_plain_matches_jax_skeleton(rows, steps, subl, lanes, grid):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(build_skeleton(rows, steps, subl, lanes, grid))())
    got = sk.store_skeleton(rows, steps, subl, lanes, grid, device="cpu")
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_plain_values():
    out = sk.store_skeleton_reference(3, 2, 2, 4, 3, device="cpu")
    assert out.shape == (6, 6, 4)
    for k in range(2):
        for j in range(3):
            assert (out[k * 3 + j] == k + j).all()


def test_no_fallback_off_cpu_and_bad_shapes():
    with pytest.raises(ValueError, match="CUDA device"):
        sk._launch(4, 2, 1, 128, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="no kernel"):
        sk.store_skeleton(4, 2, 1, 128, 1, device="meta")
    with pytest.raises(ValueError, match="bad shape"):
        sk.store_skeleton(0, 2, 1, 128, 1, device="cpu")
    assert sk.store_skeleton.launches == 0
