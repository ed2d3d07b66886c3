"""The port's measuring and evaluation programs beside ``bench``
(``scripts/bench_{fused_bit,bitboard,selfplay,search_scaling}.py`` and
``scripts/arena_{checkpoints,gate_agreement}.py``, ported), on the CPU.

``tree_bytes`` equals the bytes of the tree ``_init_tree`` allocates; the
``--quick`` forms print their rows (frames = batch x chunk), the scaling
line over spawned gloo ranks, and the JAX scripts' JSON lines with tallies
that add up, reading training checkpoints of the port; a missing
checkpoint ends a program non-zero; without a card and without ``--quick``
every program exits 1.
"""

import json
import os
import re

import pytest
import torch

from twixt_for_open_spiel_tpu_torch import arena_checkpoints as xarena
from twixt_for_open_spiel_tpu_torch import arena_gate_agreement as agree
from twixt_for_open_spiel_tpu_torch import bench_bit_step, bench_bitboard, bench_fused_bit
from twixt_for_open_spiel_tpu_torch import bench_search_scaling as scaling
from twixt_for_open_spiel_tpu_torch import bench_selfplay
from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.models.network import create_net, init_params
from twixt_for_open_spiel_tpu_torch.models.selfplay import make_optimizer
from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset
from twixt_for_open_spiel_tpu_torch.utils import serialization, timing

torch.set_num_threads(1)

# the keys of the JAX scripts' JSON lines (scripts/arena_checkpoints.py:68-75,
# scripts/arena_gate_agreement.py:87-95)
XARENA_KEYS = {"kind", "a", "b", "sims", "a_score", "a_wins", "b_wins", "draws", "games", "secs"}
AGREE_KEYS = {"board", "gate", "search", "sims", "a_score", "a_wins", "b_wins", "draws",
              "games", "secs"}


def json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def check_tally(rec):
    assert rec["a_wins"] + rec["b_wins"] + rec["draws"] == rec["games"]
    assert rec["a_score"] == (rec["a_wins"] + 0.5 * rec["draws"]) / rec["games"]


@pytest.mark.parametrize("n,batch,sims", [(5, 16, 4), (5, 16, 8), (8, 8, 200)])
def test_tree_bytes_is_the_allocation(n, batch, sims):
    nodes, a = sims + 1, n * n
    use_amask = mcts._resolve_backup("auto", nodes)
    assert use_amask == (nodes <= 160)
    tree = mcts._init_tree(bit_reset(n, batch, "cpu"), batch, nodes, a, torch.zeros(batch),
                           torch.zeros(batch, a), use_amask)
    assert tree.amask.shape == ((batch, nodes, nodes) if use_amask else (batch, 1, 1))
    assert scaling.tree_bytes(n, batch, sims) == sum(t.nbytes for t in tree)


def selfplay_rows(err):
    return re.findall(r"\[selfplay n=12 batch=(\d+) chunk=(\d+) .*\(frames (\d+)\)", err)


def test_selfplay_quick_prints_its_row(capsys):
    assert bench_selfplay.main(["--quick"]) == 0
    ((batch, chunk, frames),) = selfplay_rows(capsys.readouterr().err)
    assert (int(batch), int(chunk)) == (32, 4) and int(frames) == 32 * 4


def test_selfplay_ranks_print_the_scaling_line(capsys):
    assert bench_selfplay.main(["--ranks=2"]) == 0
    err = capsys.readouterr().err
    ((batch, chunk, frames),) = selfplay_rows(err)
    assert int(frames) == int(batch) * int(chunk) == 32 * 4
    assert "ranks=2" in err
    (line,) = [x for x in err.splitlines() if x.startswith("[scaling]")]
    assert "1-rank" in line and "2-rank" in line and "does NOT measure real scaling" in line


def test_search_scaling_quick_prints_its_rows(capsys):
    assert scaling.main(["--quick"]) == 0
    rows = re.findall(r"\[scaling n=5 batch=(\d+) sims=(\d+) chunk=(\d+)\].*\(frames (\d+);",
                      capsys.readouterr().err)
    assert [(int(b), int(s)) for b, s, _, _ in rows] == scaling.QUICK["configs"]
    assert all(int(f) == int(b) * int(c) for b, _, c, f in rows)


@pytest.fixture(scope="module")
def quick_checkpoints(tmp_path_factory):
    """Two port training checkpoints of ``--quick``'s net (board 5, 16 x 1):
    a run's directory and its ``best/``."""
    run = tmp_path_factory.mktemp("run")
    for path, seed in ((run, 3), (run / "best", 4)):
        net = init_params(create_net(5, channels=16, blocks=1, device="cpu"), seed)
        serialization.save_training(str(path), net, make_optimizer(net.parameters()), seed)
    return str(run), str(run / "best")


def test_arena_checkpoints_quick(quick_checkpoints, capsys):
    a, b = quick_checkpoints
    assert xarena.main(["--quick", f"--a={a}", f"--b={b}"]) == 0
    out = capsys.readouterr()
    assert f"A@3 ({a}) vs B@4 ({b})" in out.err
    (rec,) = json_lines(out.out)
    assert set(rec) == XARENA_KEYS
    assert (rec["kind"], rec["a"], rec["b"], rec["sims"], rec["games"]) == (
        "cross_arena", a, b, 4, 16.0)
    check_tally(rec)


def test_arena_gate_agreement_quick(quick_checkpoints, capsys):
    run, _ = quick_checkpoints
    assert agree.main(["--quick", f"--ckpt={run}"]) == 0
    out = capsys.readouterr()
    assert "best_iteration=4" in out.err
    lines = json_lines(out.out)
    assert [(r["search"], r["sims"], r["gate"]) for r in lines] == [
        ("gumbel", 4, "vs_init"), ("gumbel", 4, "vs_random"),
        ("puct", 4, "vs_init"), ("puct", 4, "vs_random")]
    for rec in lines:
        assert set(rec) == AGREE_KEYS and (rec["board"], rec["games"]) == (5, 8.0)
        check_tally(rec)


def test_missing_checkpoint_is_refused(quick_checkpoints, tmp_path):
    _, best = quick_checkpoints
    with pytest.raises(SystemExit, match="no checkpoint"):
        xarena.main(["--quick", f"--a={best}", f"--b={tmp_path}"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        agree.main(["--quick", f"--ckpt={tmp_path}"])  # no best/ inside


@pytest.mark.parametrize("module", [bench_fused_bit, bench_bitboard])
def test_rollout_benches_quick(module, capsys):
    assert module.main(["--quick"]) == 0
    out = capsys.readouterr()
    if module is bench_fused_bit:
        assert "state_equal=True" in out.out and "episodes plain=" in out.out
    else:
        assert len(out.out.splitlines()) == 5 and "K1 0, K3 0" in out.err


def test_fused_bit_refuses_tiles(capsys):
    with pytest.raises(SystemExit) as exc:
        bench_fused_bit.parse_args(["--quick", "512"])
    assert exc.value.code == 2
    assert "K1 takes no tile" in capsys.readouterr().err


def test_bit_step_bench_quick(capsys):
    """Both S1a forms through this build's wrapper (the plain version on the
    CPU) equal the plain version on the recorded inputs."""
    assert bench_bit_step.main(["--quick"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all("plain version True" in x for x in lines)


def test_bit_step_bench_others_and_timers(tmp_path, capsys):
    """``--other`` takes only a directory that holds the package's S1a
    source; a worker's timers are ``utils/timing.py``'s, loaded by path."""
    with pytest.raises(SystemExit) as exit_:
        bench_bit_step.parse_args(["--quick", f"--other={tmp_path}"])
    assert exit_.value.code == 2 and "no twixt_for_open_spiel_tpu_torch/csrc/bit_step.cu" in \
        capsys.readouterr().err
    args = bench_bit_step.parse_args(["--quick", "--other=.", "--other=."])
    assert args.other == [".", "."]
    timer = bench_bit_step.timing()
    assert timer.__file__ == str(bench_bit_step.PKG / "utils" / "timing.py")
    assert timer.CLOCK_HZ == timing.CLOCK_HZ
    assert all(callable(getattr(timer, name)) for name in ("device_ms", "back_to_back_ms"))


@pytest.mark.parametrize("module,argv", [
    (bench_fused_bit, []), (bench_bitboard, []), (bench_selfplay, []), (scaling, []),
    (bench_bit_step, ["--other=."]),
    (xarena, ["--a=x", "--b=y"]), (agree, ["--ckpt=x", "--board_size=8"])])
def test_no_card_without_quick_exits_1(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.parse_args(argv)
    assert exc.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_agreement_needs_a_board_size(capsys):
    with pytest.raises(SystemExit) as exc:
        agree.parse_args(["--ckpt=x"])
    assert exc.value.code == 2
    assert "--board_size is required" in capsys.readouterr().err
