"""``multicard_smoke.py`` (the distributed learner over several cards, one
NCCL rank a card) and the pieces it checks, on the CPU with gloo ranks at
small sizes.

Pinned:
  * without two cards the program exits 1 naming the count, before it
    builds or spawns anything, and prints no ``ok`` line; its code names
    no gloo group and no CPU flag, so that no phase falls back to them;
  * ``tests/torch_port_cases.dist_rank``: ``device="cuda"`` joins over
    NCCL with ``cuda:<rank>`` current and the mesh on it, ``"cuda:<k>"``
    shares card k over a gloo group (``initialize_distributed``,
    ``init_process_group`` and ``set_device`` recorded, not run);
  * the bus bandwidth of phase (c), 2 (N-1)/N bytes / t, and the links
    read from ``nvidia-smi topo -m``;
  * ``parallel.param_checksums`` moves with any one flipped bit of any
    tensor, and ``parallel.replicas_differ`` over two gloo ranks finds
    one flipped bit on one rank and nothing on equal ranks.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import multicard_smoke
from tests import torch_port_cases as cases
from twixt_for_open_spiel_tpu_torch import parallel

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT = 60.0


def test_no_card_exits_1_naming_the_count():
    proc = subprocess.run([sys.executable, "multicard_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1, proc.stderr
    assert "needs at least 2 CUDA cards" in proc.stderr and "has 0" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_one_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multicard_smoke._cuda, "build", lambda *a: pytest.fail("built"))
    assert multicard_smoke.main() == 1
    out = capsys.readouterr()
    assert "has 1" in out.err and '"ok"' not in out.out


def code_strings(path) -> set:
    """Every string constant of a module's code, its docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body
            and isinstance(node.body[0], ast.Expr)}
    return {node.value for node in ast.walk(tree) if isinstance(node, ast.Constant)
            and isinstance(node.value, str) and id(node) not in docs}


def test_no_phase_falls_back():
    strings = code_strings(ROOT / "multicard_smoke.py")
    assert not any(word in s for s in strings for word in ("gloo", "--cpu", "--quick",
                                                          "--smoke", "--ranks"))
    assert "cuda" in strings  # the spawned ranks' device: one card a rank, NCCL


class FakeGroup:
    """``init_process_group`` and ``set_device`` recorded, not run."""

    def __init__(self, monkeypatch):
        self.calls, self.devices = [], []
        monkeypatch.setattr(dist, "is_initialized", lambda: bool(self.calls))
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: self.calls.append((backend, kw)))
        monkeypatch.setattr(dist, "get_rank", lambda group=None: self.calls[-1][1]["rank"])
        monkeypatch.setattr(dist, "get_world_size",
                            lambda group=None: self.calls[-1][1]["world_size"])
        monkeypatch.setattr(torch.cuda, "set_device", self.devices.append)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.devices[-1])


@pytest.mark.parametrize("device,backend,card,set_to", [
    ("cuda", "nccl", 2, [2]), ("cuda:0", "gloo", 0, [])])
def test_dist_rank_places_the_rank(device, backend, card, set_to, monkeypatch):
    fake = FakeGroup(monkeypatch)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setitem(cases.DIST_CASES, "mesh", lambda mesh: mesh)
    mesh = cases.dist_rank(2, 4, "file:///rdzv", device, [("mesh", "mesh", {})])["mesh"]
    (got, kw), = fake.calls
    assert (got, kw["init_method"], kw["world_size"], kw["rank"]) == (
        backend, "file:///rdzv", 4, 2)
    assert kw["timeout"] == parallel.launch.GROUP_TIMEOUT
    assert fake.devices == set_to
    assert (mesh.rank, mesh.size, mesh.device) == (2, 4, torch.device("cuda", card))


@pytest.mark.parametrize("nbytes,ms,world,want", [
    (7_380_036, 0.1, 4, 110.70054), (7_380_036, 0.1, 2, 73.80036), (1e9, 1000.0, 8, 1.75)])
def test_bus_bandwidth(nbytes, ms, world, want):
    assert multicard_smoke.bus_gbps(nbytes, ms, world) == pytest.approx(want)


TOPO = ("\t\x1b[4mGPU0\tGPU1\tGPU2\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID\x1b[0m\n"
        "GPU0\t X \tNV18\tPIX\t0-47\t0\t\tN/A\n"
        "GPU1\tNV18\t X \tSYS\t0-47\t0\t\tN/A\n"
        "GPU2\tPIX\tSYS\t X \t48-95\t1\t\tN/A\n\n"
        "Legend:\n\n  X    = Self\n  NV#  = Connection traversing a bonded set of # NVLinks\n")


def test_topology_links():
    assert multicard_smoke.topo_links(TOPO, 3) == {
        (0, 1): "NV18", (0, 2): "PIX", (1, 0): "NV18", (1, 2): "SYS", (2, 0): "PIX",
        (2, 1): "SYS"}


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(-2, 3, 5, dtype=torch.bfloat16))
        self.register_buffer("b", torch.tensor([1.5, -0.0, 7.0]))


def test_checksums_move_with_any_flipped_bit():
    net = Net()
    base = parallel.param_checksums(net)
    for name, t in net.state_dict().items():
        raw = t.view(-1).view(torch.uint8)
        for i in range(raw.numel()):
            for bit in range(8):
                raw[i] ^= 1 << bit
                moved = parallel.param_checksums(net) != base
                raw[i] ^= 1 << bit
                assert moved.tolist() == [k == name for k in net.state_dict()], (name, i, bit)
    assert torch.equal(parallel.param_checksums(net), base)


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    jobs = [("equal", "replicas", {}), ("flip1", "replicas", {"flip_rank": 1})]
    return cases.shared_result(tmp_path_factory, "torch_multicard_replicas", lambda: (
        parallel.spawn_ranks(cases.dist_rank, 2, ("cpu", jobs), timeout=SPAWN_TIMEOUT)))


def test_replicas_differ_finds_one_flipped_bit(replicas):
    for rank in replicas:
        assert rank["equal"] == [0, 0]
        assert rank["flip1"] == [0, 1]
