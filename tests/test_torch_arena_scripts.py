"""The port's arena entry points, ``arena_gumbel_vs_puct`` and
``arena_reuse_vs_cold`` (``scripts/arena_gumbel_vs_puct.py`` and
``scripts/arena_reuse_vs_cold.py``, ported), on the CPU with ``--quick``.

Each prints the JAX script's JSON line (its keys, a tally whose counts add
up), reads a training checkpoint of the port, and without a card and
without ``--quick`` exits 1.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from twixt_for_open_spiel_tpu_torch import arena_gumbel_vs_puct as gvp
from twixt_for_open_spiel_tpu_torch import arena_reuse_vs_cold as rvc
from twixt_for_open_spiel_tpu_torch.models.network import create_net, init_params
from twixt_for_open_spiel_tpu_torch.models.selfplay import make_optimizer
from twixt_for_open_spiel_tpu_torch.utils import serialization

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX scripts' JSON lines: arena_match_asym's tally and the
# run's fields (scripts/arena_gumbel_vs_puct.py:94-102), and
# scripts/arena_reuse_vs_cold.py:76-85
GVP_KEYS = {"a_wins", "b_wins", "draws", "games", "moves", "a_score", "kind", "board_size",
            "sims_gumbel", "max_considered", "sims_puct", "secs"}
RVC_KEYS = {"kind", "sims", "a_score", "a_wins", "b_wins", "draws", "games", "secs"}


def json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def check_tally(rec):
    assert rec["a_wins"] + rec["b_wins"] + rec["draws"] == rec["games"]
    assert rec["a_score"] == (rec["a_wins"] + 0.5 * rec["draws"]) / rec["games"]


@pytest.fixture(scope="module")
def quick_checkpoint(tmp_path_factory):
    """A port training checkpoint of ``--quick``'s net (board 5, 16 x 1)."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    net = init_params(create_net(5, channels=16, blocks=1, device="cpu"), 9)
    serialization.save_training(str(ckpt), net, make_optimizer(net.parameters()), 7)
    return str(ckpt)


@pytest.mark.parametrize("module,keys", [("arena_gumbel_vs_puct", GVP_KEYS),
                                         ("arena_reuse_vs_cold", RVC_KEYS)])
def test_quick_prints_the_jax_line(module, keys):
    proc = subprocess.run(
        [sys.executable, "-m", f"twixt_for_open_spiel_tpu_torch.{module}", "--quick"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = json_lines(proc.stdout)
    assert len(lines) == 1 and set(lines[0]) == keys
    check_tally(lines[0])


def test_gumbel_vs_puct_reads_a_port_checkpoint(quick_checkpoint, capsys):
    assert gvp.main(["--quick", f"--ckpt={quick_checkpoint}", "--max_considered=4"]) == 0
    out = capsys.readouterr()
    assert f"restored {quick_checkpoint} @ iter 7" in out.err
    (rec,) = json_lines(out.out)
    assert (rec["kind"], rec["board_size"], rec["sims_gumbel"], rec["sims_puct"],
            rec["max_considered"], rec["games"]) == ("gumbel_vs_puct", 5, 4, 8, 4, 16.0)
    check_tally(rec)


def test_reuse_vs_cold_reads_a_port_checkpoint(quick_checkpoint, capsys):
    assert rvc.main(["--quick", f"--checkpoint={quick_checkpoint}"]) == 0
    out = capsys.readouterr()
    assert "n=5 batch=8 checkpoint_iter=7" in out.err
    (rec,) = json_lines(out.out)
    assert (rec["kind"], rec["sims"], rec["games"]) == ("reuse_vs_cold", 4, 8.0)
    check_tally(rec)


@pytest.mark.parametrize("module,argv", [(gvp, []), (rvc, ["--checkpoint=ckpt"])])
def test_no_card_without_quick_exits_1(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.parse_args(argv)
    assert exc.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_reuse_vs_cold_needs_a_checkpoint(capsys):
    with pytest.raises(SystemExit) as exc:
        rvc.parse_args([])
    assert exc.value.code == 2
    assert "--checkpoint is required" in capsys.readouterr().err


def test_missing_checkpoint_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        gvp.main(["--quick", f"--ckpt={tmp_path}"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        rvc.main(["--quick", f"--checkpoint={tmp_path}"])
