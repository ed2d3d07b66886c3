"""The port's host utilities and example programs on the CPU: history and
tree round trips (``utils/serialization.py``), the profiling helpers on
``torch.profiler`` (``utils/profiling.py``), and the three example runners
with ``--cpu``; without it and without a card they exit non-zero."""

import os
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from twixt_for_open_spiel_tpu.ops.bitboard import bit_reset as jax_bit_reset
from twixt_for_open_spiel_tpu_torch.game import load_game
from twixt_for_open_spiel_tpu_torch.models import create_net
from twixt_for_open_spiel_tpu_torch.ops import bitboard
from twixt_for_open_spiel_tpu_torch.utils import profiling, serialization

ROOT = Path(__file__).resolve().parent.parent


def test_history_replay_roundtrip():
    game = load_game("twixt", device="cpu")
    s = game.new_initial_state()
    for a in [14, 13, 33, 6, 26]:
        s.apply_action(a)
    data = serialization.serialize_state(s)
    assert data == "14\n13\n33\n6\n26"
    s2 = serialization.deserialize_state(game, data)
    assert s2.history == s.history
    assert s2.to_string() == s.to_string()
    assert np.array_equal(s2.observation_tensor(0), s.observation_tensor(0))


def test_pytree_snapshot_roundtrip(tmp_path):
    # a BitState mid-game, a net's state_dict, and JAX's BitState as numpy
    bs = bitboard.bit_random_rollout(0, 8, 9, bitboard.bit_reset(8, 4, "cpu"))[0]
    net = create_net(5, channels=8, blocks=1, device="cpu").state_dict()
    jax_bs = jax.tree_util.tree_map(np.asarray, jax_bit_reset(5, 2))
    tree = {"bits": bs, "net": net, "jax": tuple(jax.tree_util.tree_leaves(jax_bs)), "n": 8}
    path = str(tmp_path / "tree")
    serialization.save_pytree(path, tree)
    back = serialization.load_pytree(path, tree)
    assert type(back["bits"]) is bitboard.BitState and type(back["net"]) is OrderedDict
    assert list(back["net"]) == list(net)
    assert back["n"] == 8
    for got, want in zip(tree_leaves(back), tree_leaves(tree)):
        assert isinstance(got, np.ndarray)
        want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="do not match"):
        serialization.load_pytree(path, {"bits": bs})
    assert sorted(os.listdir(tmp_path)) == ["tree"]


def test_throughput_counts_steps():
    t = profiling.Throughput().start()
    x = torch.ones(64)
    for _ in range(5):
        x = x * 2
        t.add(10)
    assert t.steps == 50
    assert 0 < t.rate(sync=(x, [x])) < float("inf")
    assert t.rate() > 0


def test_trace_writes_a_file_naming_the_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("twixt_span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and "twixt_span" in files[0].read_text()
    with profiling.trace(None):  # off: nothing written, the body runs
        pass


def test_example_runner(capsys):
    from twixt_for_open_spiel_tpu_torch.examples import example

    example.main(["--game", "twixt(board_size=5)", "--seed", "1", "--cpu"])
    out = capsys.readouterr().out
    assert out.startswith("Loaded game: twixt(board_size=5)\n")
    assert "Utility for player 0" in out


def test_mcts_example_runner(capsys):
    from twixt_for_open_spiel_tpu_torch.examples import mcts_example

    mcts_example.main(["--game", "twixt(board_size=5)", "--player1", "mcts",
                       "--player2", "random", "--max_simulations", "2",
                       "--rollout_count", "1", "--seed", "3", "--verbose", "true", "--cpu"])
    out = capsys.readouterr().out
    assert "Returns:" in out and "(q=" in out


def test_arena_example_runner(capsys, tmp_path):
    from twixt_for_open_spiel_tpu_torch.examples import arena

    net = create_net(5, channels=16, blocks=1, device="cpu")
    opt = torch.optim.AdamW(net.parameters())
    serialization.save_training(str(tmp_path / "a"), net, opt, 3)
    arena.main(["--board_size=5", "--batch=4", "--simulations=4", "--channels=16",
                "--blocks=1", "--temp_moves=2", "--random_b", "--cpu",
                f"--ckpt_a={tmp_path / 'a'}"])
    captured = capsys.readouterr()
    assert "over 4 games" in captured.out and "A score" in captured.out
    assert "side a: restored" in captured.err and "@ iteration 3" in captured.err


@pytest.mark.parametrize("module", ["example", "mcts_example", "arena"])
def test_examples_need_the_card_without_cpu(module):
    # CUDA_VISIBLE_DEVICES="" hides any card from the program
    proc = subprocess.run(
        [sys.executable, "-m", f"twixt_for_open_spiel_tpu_torch.examples.{module}"],
        cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device; pass --cpu" in proc.stderr and proc.stdout == ""
