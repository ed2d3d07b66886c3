"""The store-stream probe: its plain version equals the JAX DMA skeleton
(``scripts/repro_mosaic_dma_tile.py::build_skeleton``, run in TPU interpret
mode on the CPU), and off the CPU the wrapper launches the CUDA kernel or
raises.  ``chip_smoke.py`` holds the kernel to the plain version on the
card."""

import os
import pathlib
import re
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

SOURCE = pathlib.Path(sk.__file__).resolve().parent.parent / "csrc" / "store_skeleton.cu"


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


def test_kernel_refuses_rows_of_no_whole_16_byte_vectors():
    # checked before any CUDA call: 6 words a program's row
    with pytest.raises(ValueError, match="no multiple of 4"):
        sk._launch(4, 2, 1, 6, 1, torch.device("cuda"))
    assert sk.store_skeleton.launches == 0


# --- a model of the CUDA kernel's persistent chunk walk (tests only) ---------


def kernel_constants() -> dict:
    """THREADS, SLOTS, SLOT_BYTES and BLOCKS_PER_SM as the kernel source sets
    them."""
    text = SOURCE.read_text()
    return {
        name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
        for name in ("THREADS", "SLOTS", "SLOT_BYTES", "BLOCKS_PER_SM")
    }


def chunk_walk(rows, steps, subl, lanes, grid, sms):
    """The kernel's schedule on a card with ``sms`` SMs, word by word: the
    flat output's words stored by each (block, thread, vector), the values
    written, and each block's ring of slots.  Returns (times each word is
    stored, the words' values, the chunks' byte sizes)."""
    k = kernel_constants()
    slot_words = k["SLOT_BYTES"] // 4
    width = grid * subl * lanes
    total = steps * rows * width
    chunks = -(-total // slot_words)
    blocks = max(1, min(chunks, k["BLOCKS_PER_SM"] * sms))
    stored = np.zeros(total, np.int64)
    values = np.full(total, -1, np.int64)
    sizes = []
    for b in range(blocks):
        in_flight = []  # the chunks whose copies may still read their slots
        for t, c in enumerate(range(b, chunks, blocks)):
            # acquire: wait_group.read SLOTS - 1 leaves the SLOTS - 1 newest
            in_flight = in_flight[-(k["SLOTS"] - 1):] if k["SLOTS"] > 1 else []
            assert all(u % k["SLOTS"] != t % k["SLOTS"] for u in in_flight)
            w0 = c * slot_words
            words = min(slot_words, total - w0)
            assert words % 4 == 0 and (w0 * 4) % 16 == 0
            row0, col0 = divmod(w0, width)
            k0, j0 = divmod(row0, rows)
            for tid in range(k["THREADS"]):
                v = np.arange(tid, words // 4, k["THREADS"])
                j = j0 + (col0 + 4 * v) // width
                dk = j // rows
                for i in range(4):
                    stored[w0 + 4 * v + i] += 1
                    values[w0 + 4 * v + i] = k0 + dk + (j - dk * rows)
            sizes.append(words * 4)
            in_flight.append(t)
    return stored, values, sizes


def test_kernel_constants_fit_its_ring():
    k = kernel_constants()
    assert 2 <= k["SLOTS"] <= 4 and 16384 <= k["SLOT_BYTES"] <= 32768
    assert k["SLOT_BYTES"] % (16 * k["THREADS"]) == 0  # whole 16-byte vectors a thread
    assert k["SLOTS"] * k["SLOT_BYTES"] * k["BLOCKS_PER_SM"] <= 227 * 1024


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize(
    "rows,steps,subl,lanes,grid",
    [
        (5, 3, 1, 128, 3),    # a row narrower than a slot (384 words)
        (6, 4, 2, 128, 32),   # a row wider than a slot (8192 words)
        (7, 3, 1, 4, 1),      # grid 1, 4-word rows, a ragged last chunk
        (36, 2, 8, 128, 1),   # grid 1, a row of 1024 words
        (9, 5, 3, 124, 11),   # 4092-word rows, ragged everywhere
    ],
)
def test_chunk_walk_stores_every_word_once_with_its_value(rows, steps, subl, lanes, grid, sms):
    stored, values, sizes = chunk_walk(rows, steps, subl, lanes, grid, sms)
    assert (stored == 1).all()
    want = sk.store_skeleton_reference(rows, steps, subl, lanes, grid, device="cpu")
    np.testing.assert_array_equal(values, want.numpy().reshape(-1))
    slot = kernel_constants()["SLOT_BYTES"]
    assert all(size % 16 == 0 and 0 < size <= slot for size in sizes)
    assert sum(sizes) == want.numel() * 4
