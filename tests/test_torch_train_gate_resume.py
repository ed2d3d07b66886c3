"""The port's training driver (``twixt_for_open_spiel_tpu_torch/
train_arena_gate.py``) and its checkpoints (``utils/serialization.py``), on
the CPU: the port of ``tests/test_train_gate_resume.py``.

The driver runs in this process (``parse_args`` then ``run``) at a tiny
budget with ``--cpu``; one test runs the module as a program.  Pinned:

  * a fresh run writes the latest and best checkpoints and best_meta.json,
    and its records come in the JAX script's order;
  * ``--resume`` continues from the checkpointed iteration and restores the
    best-gate record;
  * a checkpoint directory without best_meta.json re-gates its best;
  * the gates' initial net is a copy that training leaves unchanged;
  * ``--smoke`` runs to its ``done`` record;
  * ``--search=gumbel`` and ``--search=puct_reuse`` reach self-play and
    ``--arena_search=gumbel`` every gate, and such a run resumes;
  * the flag checks: no card, ``--mesh`` in a world of another size or with
    a batch it does not divide, an unknown search, the Dirichlet flags with
    Gumbel.

The distributed runs (``--mesh=2`` as two gloo ranks) are pinned in
``tests/test_torch_dist_driver.py``.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from twixt_for_open_spiel_tpu_torch import train_arena_gate as tg
from twixt_for_open_spiel_tpu_torch.models.network import create_net, init_params
from twixt_for_open_spiel_tpu_torch.utils import serialization

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = [
    "--cpu", "--board_size=5", "--batch=4", "--chunk_steps=4", "--simulations=2",
    "--channels=8", "--blocks=1", "--temp_moves=2", "--arena_batch=4", "--arena_sims=2",
    "--seed=3",
]


def run_gate(ckpt, log, extra):
    out = tg.run(tg.parse_args([*ARGS, f"--checkpoint_dir={ckpt}", f"--log={log}", *extra]))
    with open(log) as f:
        return out, [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """Two iterations gated at both, then a resume to four gated at 3 and 4."""
    root = tmp_path_factory.mktemp("gate")
    first = run_gate(root / "ckpt", root / "a.jsonl", ["--iterations=2", "--gates=1,2"])
    snapshot = root / "after_first"
    shutil.copytree(root / "ckpt", snapshot)
    second = run_gate(root / "ckpt", root / "b.jsonl",
                      ["--iterations=4", "--gates=3,4", "--resume"])
    return {"root": root, "first": first, "second": second, "snapshot": snapshot}


def kinds_in_order(recs):
    order = []
    for r in recs:
        if not order or order[-1] != r["kind"]:
            order.append(r["kind"])
    return order


def test_fresh_run_writes_latest_best_and_meta(fresh):
    out, recs = fresh["first"]
    assert kinds_in_order(recs) == ["train", "gate_vs_init", "train", "gate_vs_init", "best",
                                    "gate_vs_random", "done"]
    train = [r for r in recs if r["kind"] == "train"]
    assert [r["iteration"] for r in train] == [1, 2]
    assert set(train[0]) == {"kind", "iteration", "loss", "policy_loss", "value_loss",
                             "train_frames", "target_entropy", "secs", "moves_per_s"}
    ckpt = fresh["snapshot"]
    with open(ckpt / "best_meta.json") as f:
        meta = json.load(f)
    assert meta["iteration"] in (1, 2)
    best = next(r for r in recs if r["kind"] == "best")
    assert (best["iteration"], best["a_score"]) == (meta["iteration"], meta["a_score"])
    params, opt_state, it = serialization.restore_training(str(ckpt), "cpu")
    assert it == 2
    for name, t in out["net"].state_dict().items():
        assert torch.equal(params[name], t), name
    assert opt_state["state"] and opt_state["param_groups"][0]["weight_decay"] == 1e-4
    _, _, best_it = serialization.restore_training(str(ckpt / "best"), "cpu")
    assert best_it == meta["iteration"]


def test_resume_restores_best_record(fresh):
    with open(fresh["snapshot"] / "best_meta.json") as f:
        meta = json.load(f)
    out, recs = fresh["second"]
    resume = next(r for r in recs if r["kind"] == "resume")
    assert resume["from_iteration"] == 2
    assert resume["best_iteration"] == meta["iteration"]
    assert resume["best_score"] == pytest.approx(meta["a_score"])
    its = [r["iteration"] for r in recs if r["kind"] == "train"]
    assert its and min(its) == 3  # a continuation, not a restart
    assert [r["iteration"] for r in recs if r["kind"] == "gate_vs_init"] == [3, 4]
    assert out["start_iteration"] == 3
    assert kinds_in_order(recs)[0] == "resume" and recs[-1]["kind"] == "done"


def test_resume_pre_meta_checkpoint_regates_best(fresh, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(fresh["snapshot"], ckpt)
    os.remove(ckpt / "best_meta.json")  # the layout of older runs
    _, recs = run_gate(ckpt, tmp_path / "c.jsonl", ["--iterations=3", "--gates=3", "--resume"])
    warn = [r for r in recs if r["kind"] == "warn"]
    assert warn and "re-gating" in warn[0]["msg"]
    assert kinds_in_order(recs)[:3] == ["warn", "gate_vs_init", "resume"]
    resume = next(r for r in recs if r["kind"] == "resume")
    assert resume["best_score"] >= 0.0  # measured again, not reset to -1
    assert os.path.exists(ckpt / "best_meta.json")


def test_resume_reseeds_from_seed_and_iteration(fresh, tmp_path):
    """Two resumes from one checkpoint play the same games: the generator
    restarts from (seed, first iteration), not from wherever it was."""
    runs = []
    for name in ("x", "y"):
        shutil.copytree(fresh["snapshot"], tmp_path / name)
        _, recs = run_gate(tmp_path / name, tmp_path / f"{name}.jsonl",
                           ["--iterations=3", "--gates=3", "--resume"])
        runs.append([{k: v for k, v in r.items() if k not in ("secs", "moves_per_s",
                                                                 "total_secs")} for r in recs])
    assert runs[0] == runs[1]
    assert tg._fold(4, 3) != tg._fold(4, 4) != tg._fold(5, 3)


def test_init_net_unchanged_after_training(fresh):
    out, _ = fresh["first"]
    want = init_params(create_net(5, channels=8, blocks=1, device="cpu"), 3).state_dict()
    init = out["init_net"].state_dict()
    for name, t in want.items():
        assert torch.equal(init[name], t), name
    trained = out["net"].state_dict()
    assert any(not torch.equal(trained[k], want[k]) for k in want)
    ptrs = {p.data_ptr() for p in out["net"].parameters()}
    for opponent in (out["init_net"], out["best_net"]):
        assert not ptrs & {p.data_ptr() for p in opponent.parameters()}


def test_smoke_run_ends_with_done(tmp_path):
    log = tmp_path / "smoke.jsonl"
    out = tg.run(tg.parse_args(["--smoke", f"--log={log}"]))
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert recs[-1]["kind"] == "done"
    assert [r["iteration"] for r in recs if r["kind"] == "gate_vs_init"] == [2, 4]
    assert out["net"].board_size == 5 and out["net"].channels == 16


def spy_searches(monkeypatch):
    """Records the ``search`` of every self-play chunk and arena match the
    driver runs."""
    seen = {"selfplay": [], "arena": []}
    real_chunk, real_match = tg.selfplay_chunk, tg.arena_match

    def chunk(*args, **kw):
        seen["selfplay"].append(kw["search"])
        return real_chunk(*args, **kw)

    def match(*args, **kw):
        seen["arena"].append(kw["search"])
        return real_match(*args, **kw)

    monkeypatch.setattr(tg, "selfplay_chunk", chunk)
    monkeypatch.setattr(tg, "arena_match", match)
    return seen


@pytest.mark.parametrize("search,arena_search", [
    ("gumbel", "puct"), ("puct_reuse", "puct"), ("puct", "gumbel")])
def test_search_arms_run(search, arena_search, monkeypatch, tmp_path):
    seen = spy_searches(monkeypatch)
    out, recs = run_gate(tmp_path / "ckpt", tmp_path / "a.jsonl",
                         ["--iterations=2", "--gates=2", f"--search={search}",
                          f"--arena_search={arena_search}"])
    assert kinds_in_order(recs) == ["train", "gate_vs_init", "best", "gate_vs_random", "done"]
    assert seen == {"selfplay": [search] * 2, "arena": [arena_search] * 2}
    assert all(0.0 <= r["a_score"] <= 1.0 for r in recs if r["kind"].startswith("gate"))
    assert serialization.restore_training(str(tmp_path / "ckpt"), "cpu")[2] == 2


def test_reuse_with_gumbel_gates_resumes(monkeypatch, tmp_path):
    """``--search=puct_reuse --arena_search=gumbel``: a run, then ``--resume``
    with the same searches, restoring the best record."""
    seen = spy_searches(monkeypatch)
    flags = ["--search=puct_reuse", "--arena_search=gumbel"]
    _, first = run_gate(tmp_path / "ckpt", tmp_path / "a.jsonl",
                        ["--iterations=2", "--gates=1,2", *flags])
    out, recs = run_gate(tmp_path / "ckpt", tmp_path / "b.jsonl",
                         ["--iterations=3", "--gates=3", "--resume", *flags])
    best = next(r for r in first if r["kind"] == "best")
    resume = next(r for r in recs if r["kind"] == "resume")
    assert (resume["from_iteration"], resume["best_iteration"]) == (2, best["iteration"])
    assert resume["best_score"] == pytest.approx(best["a_score"])
    assert out["start_iteration"] == 3 and recs[-1]["kind"] == "done"
    assert seen["selfplay"] == ["puct_reuse"] * 3 and set(seen["arena"]) == {"gumbel"}
    assert len(seen["arena"]) == 5  # two gates and vs-random, then one gate and vs-random


@pytest.mark.parametrize("flags,code,message", [
    (["--mesh=2"], 2, "WORLD_SIZE"),
    (["--mesh=3"], 2, "no multiple of --mesh=3"),
    (["--mesh=-1"], 2, "must be >= 0"),
    (["--search=beam"], 2, "invalid choice"),
    (["--search=gumbel", "--dirichlet_alpha=0.02"], 2, "no effect with"),
    (["--search=gumbel", "--dirichlet_frac=0.25"], 2, "no effect with"),
    ([], 1, "no CUDA device"),
])
def test_flag_checks(flags, code, message, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tg.parse_args(["--iterations=1", *flags])
    assert exc.value.code == code
    assert message in capsys.readouterr().err


def test_flag_defaults():
    args = tg.parse_args(["--cpu"])
    assert (args.dirichlet_alpha, args.dirichlet_frac, args.search, args.mesh) == (
        None, 0.25, "puct", 0)
    assert tg.parse_args(["--cpu", "--dirichlet_frac=0.5"]).dirichlet_frac == 0.5
    smoke = tg.parse_args(["--smoke"])
    assert (smoke.board_size, smoke.batch, smoke.chunk_steps, smoke.simulations,
            smoke.channels, smoke.blocks, smoke.iterations, smoke.arena_batch,
            smoke.arena_sims, smoke.gates) == (5, 32, 8, 8, 16, 1, 4, 16, 8, "2,4")


def test_program_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "twixt_for_open_spiel_tpu_torch.train_arena_gate",
         "--iterations=1"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-500:]
    assert "no CUDA device" in proc.stderr


def test_restore_training_needs_the_marker(tmp_path):
    assert serialization.restore_training(str(tmp_path), "cpu") is None
    net = create_net(5, channels=8, blocks=1, device="cpu")
    opt = torch.optim.AdamW(net.parameters())
    serialization.save_training(str(tmp_path / "c"), net, opt, 7)
    assert sorted(os.listdir(tmp_path / "c")) == ["iteration.txt", "opt_state", "params"]
    params, opt_state, it = serialization.restore_training(str(tmp_path / "c"), "cpu")
    assert it == 7 and params.keys() == net.state_dict().keys()
    assert opt_state["param_groups"] == opt.state_dict()["param_groups"]
    os.remove(tmp_path / "c" / "iteration.txt")
    assert serialization.restore_training(str(tmp_path / "c"), "cpu") is None
