"""The port's distributed front doors on the CPU, as two gloo ranks spawned
by ``parallel.spawn_ranks``: the training driver with ``--mesh=2``
(``train_arena_gate.py``) and ``examples/selfplay_train.py``.

Every rank gets the same flags, as under torchrun, and its stderr (the
driver's records) or stdout (the example's lines) goes to a file of its
own.  Pinned:

  * ``--smoke --mesh=2``: rank 0 writes the records, in the JAX script's
    order, the log and the checkpoints; rank 1 writes nothing;
  * ``--resume`` with ``--mesh=2``: rank 0 reads the checkpoint and
    restores the best record, and both ranks start at the next iteration
    with rank 0's parameters; a resumed run that trains (a small ``--cpu``
    budget) leaves the ranks' parameters bitwise equal, and the driver's
    own check after the first iteration of each run finds them so;
  * the example: two iterations over two ranks, printed by rank 0 only,
    with its checkpoint.

Each job is spawned once a session (``cases.shared_result``), bounded by
``SPAWN_TIMEOUT``.
"""

import json
import os
import pathlib

import pytest
import torch

from tests import torch_port_cases as cases
from twixt_for_open_spiel_tpu_torch.parallel import spawn_ranks
from twixt_for_open_spiel_tpu_torch.utils import serialization

torch.set_num_threads(1)

SPAWN_TIMEOUT = 60.0
SMALL = ["--cpu", "--board_size=5", "--batch=8", "--chunk_steps=4", "--simulations=2",
         "--channels=8", "--blocks=1", "--temp_moves=2", "--arena_batch=4", "--arena_sims=2",
         "--seed=3", "--mesh=2"]


def kinds_in_order(recs):
    order = []
    for r in recs:
        if not order or order[-1] != r["kind"]:
            order.append(r["kind"])
    return order


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    """``--smoke --mesh=2``, then its ``--resume``; a small ``--cpu`` run to
    iteration 2, then its ``--resume`` to iteration 3."""
    root = tmp_path_factory.getbasetemp()

    def compute():
        out = root / "torch_dist_driver"
        out.mkdir(exist_ok=True)
        smoke = ["--smoke", "--mesh=2", f"--checkpoint_dir={out}/smoke",
                 f"--log={out}/smoke.jsonl"]
        small = [*SMALL, f"--checkpoint_dir={out}/small", f"--log={out}/small.jsonl"]
        runs = [smoke, [*smoke, "--resume"], [*small, "--iterations=2", "--gates=1,2"],
                [*small, "--iterations=3", "--gates=3", "--resume"]]
        ranks = spawn_ranks(cases.dist_rank, 2, (
            "cpu", [("driver", "driver", {"runs": runs, "stderr_dir": str(out)})]),
            timeout=SPAWN_TIMEOUT)
        return {"dir": str(out), "ranks": [r["driver"] for r in ranks]}

    return cases.shared_result(tmp_path_factory, "torch_dist_driver", compute)


def test_smoke_mesh2_records_in_order(driver):
    recs = records(os.path.join(driver["dir"], "smoke.jsonl"))
    first = recs[:recs.index(next(r for r in recs if r["kind"] == "resume"))]
    assert kinds_in_order(first) == ["train", "gate_vs_init", "train", "gate_vs_init", "best",
                                     "gate_vs_random", "done"]
    assert [r["iteration"] for r in first if r["kind"] == "train"] == [1, 2, 3]
    assert [r["iteration"] for r in first if r["kind"] == "gate_vs_init"] == [2, 4]
    # the metrics are the global batch's: 32 envs x 8 plies
    assert all(0 <= r["train_frames"] <= 256 for r in first if r["kind"] == "train")


def test_only_rank0_writes(driver):
    err0, err1 = (pathlib.Path(driver["dir"], f"stderr{r}.txt").read_text() for r in (0, 1))
    assert '"kind": "train"' in err0 and "[train] device=cpu" in err0
    assert err1 == ""
    logged = [json.loads(line) for line in err0.splitlines() if line.startswith("{")]
    assert logged == (records(os.path.join(driver["dir"], "smoke.jsonl"))
                      + records(os.path.join(driver["dir"], "small.jsonl")))
    assert sorted(os.listdir(os.path.join(driver["dir"], "smoke"))) == [
        "best", "best_meta.json", "iteration.txt", "opt_state", "params"]


def test_resume_mesh2_restores_and_broadcasts(driver):
    recs = records(os.path.join(driver["dir"], "smoke.jsonl"))
    best = next(r for r in recs if r["kind"] == "best")
    resume = next(r for r in recs if r["kind"] == "resume")
    after = recs[recs.index(resume):]
    assert kinds_in_order(after) == ["resume", "best", "gate_vs_random", "done"]
    assert (resume["from_iteration"], resume["best_iteration"]) == (4, best["iteration"])
    assert resume["best_score"] == pytest.approx(best["a_score"])
    (r0, r1) = driver["ranks"]
    assert r0[1]["start_iteration"] == r1[1]["start_iteration"] == 5
    params, _, it = serialization.restore_training(os.path.join(driver["dir"], "smoke"), "cpu")
    assert it == 4
    for name, p in params.items():
        assert torch.equal(r0[1]["net"][name], p) and torch.equal(r1[1]["net"][name], p), name


def test_resumed_mesh2_training_keeps_ranks_equal(driver):
    (r0, r1) = driver["ranks"]
    assert r0[3]["start_iteration"] == r1[3]["start_iteration"] == 3
    assert any(not torch.equal(r0[2]["net"][k], r0[3]["net"][k]) for k in r0[2]["net"])
    for k in r0[3]["net"]:
        assert torch.equal(r0[3]["net"][k], r1[3]["net"][k]), k
    # the driver's own check after the first iteration of each run
    err0 = pathlib.Path(driver["dir"], "stderr0.txt").read_text()
    for it in (1, 3):
        assert (f"[mesh] after iteration {it}: the 2 ranks' tensors that differ from rank 0's, "
                f"by rank: [0, 0]") in err0
    recs = records(os.path.join(driver["dir"], "small.jsonl"))
    assert [r["iteration"] for r in recs if r["kind"] == "train"] == [1, 2, 3]
    assert [r["iteration"] for r in recs if r["kind"] == "gate_vs_init"] == [1, 2, 3]


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()

    def compute():
        out = root / "torch_dist_example"
        out.mkdir(exist_ok=True)
        argv = ["--cpu", "--board_size=5", "--batch=8", "--chunk_steps=4", "--simulations=2",
                "--iterations=2", "--channels=8", "--blocks=1",
                f"--checkpoint_dir={out}/ckpt"]
        ranks = spawn_ranks(cases.dist_rank, 2, (
            "cpu", [("example", "example", {"argv": argv, "stdout_dir": str(out)})]),
            timeout=SPAWN_TIMEOUT)
        return {"dir": str(out), "codes": [r["example"] for r in ranks]}

    return cases.shared_result(tmp_path_factory, "torch_dist_example", compute)


def test_example_two_ranks_two_iterations(example):
    assert example["codes"] == [0, 0]
    out0, out1 = (pathlib.Path(example["dir"], f"stdout{r}.txt").read_text() for r in (0, 1))
    assert out0.startswith("mesh: 2 ranks, 4 envs each, on cpu (gloo)")
    assert [line.split(":")[0] for line in out0.splitlines()[1:]] == ["iter 0", "iter 1"]
    assert out1 == ""
    assert serialization.restore_training(os.path.join(example["dir"], "ckpt"), "cpu")[2] == 2
