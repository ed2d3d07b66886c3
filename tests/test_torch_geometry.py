"""The port's geometry tables and action codecs equal the JAX package's, and
the port never imports jax."""

import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import geometry as jgeo
from twixt_for_open_spiel_tpu.ops import state as jstate
from twixt_for_open_spiel_tpu_torch.ops import geometry as tgeo
from twixt_for_open_spiel_tpu_torch.ops import state as tstate

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parents[1] / "twixt_for_open_spiel_tpu_torch"
SIZES = list(range(5, 25))


def test_tables_equal():
    np.testing.assert_array_equal(tgeo.OFFSETS, jgeo.OFFSETS)
    np.testing.assert_array_equal(tgeo.CROSSERS, jgeo.CROSSERS)
    for name in (
        "RED", "BLUE", "COLOR_RED", "COLOR_BLUE", "COLOR_EMPTY",
        "COLOR_OFFBOARD", "RESULT_OPEN", "RESULT_RED_WIN", "RESULT_BLUE_WIN",
        "RESULT_DRAW", "MIN_BOARD_SIZE", "MAX_BOARD_SIZE", "NUM_PLANES",
        "TERMINAL_PLAYER_ID", "PAD", "NUM_DIRS",
    ):
        assert getattr(tgeo, name) == getattr(jgeo, name), name
    for player in (0, 1):
        for border in (0, 1):
            assert tgeo.flag_bit(player, border) == jgeo.flag_bit(player, border)


@pytest.mark.parametrize("n", SIZES)
def test_board_masks_equal(n):
    want = jgeo.board_masks(n)
    got = tgeo.board_masks(n)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tstate.padded_size(n) == jstate.padded_size(n)


@pytest.mark.parametrize("n", SIZES)
def test_action_codecs_equal(n):
    actions = np.arange(n * n, dtype=np.int32)
    ta = torch.from_numpy(actions)
    ja = jnp.asarray(actions)
    np.testing.assert_array_equal(
        tstate.swap_rotate_action(ta, n).numpy(),
        np.asarray(jstate.swap_rotate_action(ja, n)),
    )
    tx, ty = tstate.action_to_xy(ta, n)
    jx, jy = jstate.action_to_xy(ja, n)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        tstate.xy_to_action(tx, ty, n).numpy(),
        np.asarray(jstate.xy_to_action(jx, jy, n)),
    )
    # the Python-int path, including move_one's -1 sentinel
    for a in (-1, 0, n * n - 1):
        assert tstate.swap_rotate_action(a, n) == int(jstate.swap_rotate_action(a, n))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_source_imports_no_jax():
    # the package and the script that drives it on the card
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) >= 12
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "twixt_for_open_spiel_tpu"), (
                f"{path.relative_to(PORT.parent)} imports {mod}"
            )


def test_importing_port_loads_no_jax():
    # every module of the port, found on disk so a new one is never missed;
    # importing them loads and builds no kernel
    modules = sorted(
        "twixt_for_open_spiel_tpu_torch.ops." + path.stem
        for path in (PORT / "ops").glob("*.py") if path.stem != "__init__"
    )
    assert len(modules) >= 10
    code = (
        "import importlib, sys\n"
        "import twixt_for_open_spiel_tpu_torch as tw\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert {'State', 'reset', 'step', 'returns', 'is_terminal',\n"
        "        'observation', 'geometry'} <= set(dir(tw))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'twixt_for_open_spiel_tpu')]\n"
        "assert not bad, bad\n"
        "from twixt_for_open_spiel_tpu_torch.ops import _cuda\n"
        "assert _cuda.load.cache_info().currsize == 0\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
