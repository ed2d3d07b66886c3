"""The port's native host runtime (``twixt_for_open_spiel_tpu_torch/native``)
on the CPU.  The C build is required: a failed build fails these tests.

The C sources are byte-for-byte the JAX package's; the C renderer equals
the port's and the JAX package's Python renderers; the C engine passes the
checks of ``tests/test_native_engine.py`` (the oracle's trajectories, the
reference's scenarios, C games replayed through the oracle); and concurrent
builders each load a whole library (each compiles to its own temporary
name, then renames it into place)."""

import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from twixt_for_open_spiel_tpu.game.render import render_py as jax_render_py
from twixt_for_open_spiel_tpu_torch import native
from twixt_for_open_spiel_tpu_torch.game import load_game
from twixt_for_open_spiel_tpu_torch.game.render import render, render_native, render_py
from twixt_for_open_spiel_tpu_torch.native.engine import (
    NativeEngine,
    load_engine,
    random_game,
    random_games,
)

from oracle import DRAW, OPEN, OracleGame

ROOT = Path(__file__).resolve().parent.parent
JAX_NATIVE = ROOT / "twixt_for_open_spiel_tpu" / "native"


@pytest.fixture(scope="module", autouse=True)
def built():
    for stem in ("render", "engine"):
        assert native.load_lib(stem) is not None, native.build_errors.get(stem)
    assert load_engine() is not None and native.load() is not None


@pytest.mark.parametrize("stem", ["render", "engine"])
def test_sources_are_the_jax_packages(stem):
    assert (native.SRC / f"{stem}.c").read_bytes() == (JAX_NATIVE / f"{stem}.c").read_bytes()
    # built into the package's _build directory, never beside the sources
    assert Path(native.load_lib(stem)._name).parent == native.BUILD
    assert not list(native.SRC.glob("*.so"))


def oracle_snapshot(o: OracleGame):
    """Flat (color, links, blocked, flags) arrays in the C engine's layout
    (``tests/test_native_engine.py::oracle_snapshot``)."""
    n = o.n
    color = np.full(n * n, 3, np.int8)
    links, blocked, flags = (np.zeros(n * n, np.uint8) for _ in range(3))
    for (x, y), c in o.color.items():
        color[x * n + y] = c
    for (x, y), ds in o.links.items():
        for d in ds:
            links[x * n + y] |= 1 << d
    for (x, y), ds in o.blocked.items():
        for d in ds:
            blocked[x * n + y] |= 1 << d
    for (x, y), fs in o.flags.items():
        for p, b in fs:
            flags[x * n + y] |= 1 << (p * 2 + b)
    return color, links, blocked, flags


def random_state(n, moves, seed):
    rng = random.Random(seed)
    s = load_game(f"twixt(board_size={n})", device="cpu").new_initial_state()
    for _ in range(moves):
        if s.is_terminal():
            break
        s.apply_action(rng.choice(s.legal_actions()))
    return s.tensor_state


@pytest.mark.parametrize("n", [5, 8, 10, 12, 24])
def test_c_renderer_matches_python(n):
    for seed in range(3):
        s = random_state(n, moves=2 * n, seed=seed)
        color, links = s.color.numpy(), s.links.numpy()
        for ansi in (True, False):
            args = (n, bool(s.swapped), int(s.result), ansi)
            want = render_py(color, links, *args)
            assert jax_render_py(color, links, *args) == want
            assert render_native(color, links, *args) == want
            assert render(s.color, s.links, *args) == want  # tensors in


def test_c_renderer_trailers():
    g = load_game("twixt", device="cpu")
    st = g.new_initial_state()
    st.apply_action(19)
    st.apply_action(19)  # swap
    s = st.tensor_state
    a = render_py(s.color, s.links, 8, True, 0, True)
    assert a == render_native(s.color, s.links, 8, True, 0, True) and a.endswith("[swapped]")
    for result, tag in [(1, "[x has won]"), (2, "[o has won]"), (3, "[draw]")]:
        a = render_py(s.color, s.links, 8, False, result, True)
        assert a == render_native(s.color, s.links, 8, False, result, True)
        assert a.endswith(tag)


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_random_trajectories_match_oracle(n):
    for seed in range(4):
        rng = random.Random(1000 * n + seed)
        eng = NativeEngine(n)
        ora = OracleGame(n)
        while not ora.is_terminal():
            la_o = ora.legal_actions()
            assert la_o == eng.legal_actions()
            a = rng.choice(la_o)
            if ora.move_counter == 1 and rng.random() < 0.5:
                swap_a = ora.move_one[0] * n + ora.move_one[1]
                if swap_a in la_o:
                    a = swap_a
            ora.apply(a)
            eng.apply(a)
            assert (eng.current, eng.move_counter, eng.result, eng.swapped) == \
                (ora.current, ora.move_counter, ora.result, ora.swapped)
        assert eng.is_terminal()
        assert eng.returns() == ora.returns()
        for got, want in zip(eng.snapshot(), oracle_snapshot(ora)):
            np.testing.assert_array_equal(got, want)


def test_swap_scenario():
    eng = NativeEngine(8)
    eng.apply(19)
    assert 19 in eng.legal_actions()
    eng.apply(19)
    assert eng.swapped
    la = eng.legal_actions()
    assert 19 in la and 29 not in la


def test_draw_scenario():
    eng = NativeEngine(5)
    i = 0
    while not eng.is_terminal():
        la = eng.legal_actions()
        eng.apply(la[min(i % 2, len(la) - 1)])
        i += 1
    assert eng.result == DRAW
    assert eng.returns() == [0.0, 0.0]


def test_win_line():
    eng = NativeEngine(8)
    for a in [21, 38, 15, 11, 27, 17, 42, 45, 48]:
        eng.apply(a)
    assert eng.is_terminal()
    assert eng.returns() == [1.0, -1.0]


def test_illegal_action_rejected():
    eng = NativeEngine(8)
    with pytest.raises(ValueError, match="Not a legal action: 0"):
        eng.apply(0)  # corner, never legal


@pytest.mark.parametrize("n", [5, 8, 24])
def test_c_random_games_replay_through_oracle(n):
    for seed in (7, 8):
        actions, result = random_game(n, seed)
        ora = OracleGame(n)
        for a in actions:
            assert a in ora.legal_actions()
            ora.apply(a)
        assert ora.is_terminal()
        assert ora.result == result


def test_random_games_batch_counts():
    total, results = random_games(5, 3, 50)
    assert results[OPEN] == 0
    assert sum(results) == 50
    assert total >= 50


_RACER = """
import sys, time
from pathlib import Path
import twixt_for_open_spiel_tpu_torch.native as nat
from twixt_for_open_spiel_tpu_torch.native import engine
nat.BUILD = Path(sys.argv[1])
go = Path(sys.argv[2])
Path(sys.argv[3]).touch()  # at the start line
while not go.exists():
    time.sleep(0.001)
assert engine.load_engine() is not None, nat.build_errors
assert nat.load() is not None, nat.build_errors
assert engine.random_games(5, 3, 10)[0] >= 10
print("loaded")
"""


def test_concurrent_builds_both_load(tmp_path):
    """Three processes build the same sources into one fresh directory at
    once: both load, and no temporary file is left behind."""
    build, go = tmp_path / "_build", tmp_path / "go"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    ready = [tmp_path / f"ready{i}" for i in range(3)]
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(build), str(go), str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in ready]
    deadline = time.monotonic() + 60
    while not all(r.exists() for r in ready) and time.monotonic() < deadline:
        time.sleep(0.01)
    go.touch()
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0 and out.strip() == "loaded", err
    assert all(r.exists() for r in ready)
    assert sorted(p.name for p in build.iterdir()) == ["_engine_c.so", "_render_c.so"]
