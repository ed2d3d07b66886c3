"""The port's distributed learner (``twixt_for_open_spiel_tpu_torch/parallel``)
against the JAX package's (``twixt_for_open_spiel_tpu/parallel``), on the CPU.

The port runs as two and four gloo ranks spawned by
``parallel.spawn_ranks`` (``tests/torch_port_cases.dist_rank``); JAX runs
in this process on ``jax.devices()[:N]`` of the conftest's 8-device CPU
mesh.  Rank r holds columns ``[r*B/N, (r+1)*B/N)``, the shard of JAX's
mesh position r, so each rank is compared with JAX's
``addressable_shards`` data of that device.  Each world is spawned once a
session and shared by its cases (``cases.shared_result``), every spawn
bounded by ``SPAWN_TIMEOUT``.

Pinned:
  * ``hosts_major_order`` equals JAX's on mocked pods;
  * ``initialize_distributed``: the no-op in a world of one, torchrun's
    variables, the coordinator forms, the backend by device, idempotence;
  * the sharded bitboard rollout, both arms, bit-equal to JAX's
    ``make_sharded_bit_rollout`` rank by rank, with the reduced stats; the
    ranks' streams differ; ``tests/fixtures/torch_port_sharded_rollout.json``
    (the card's headline row, from JAX) recomputed;
  * the sharded canonical rollout's invariants (``tests/test_sharding.py``);
  * the distributed train step (microbatch 1 and 3, half the envs'
    weights zeroed) against the port's local ``train_step`` and JAX's
    2-device step, float32: parameters rtol 2e-5 / atol 1e-6 and metrics
    rtol 2e-5 (JAX's own pin); the ranks' parameters bitwise equal, also
    after three ``ClippedAdamW`` steps (against the local steps to
    ``tests/test_torch_train.py``'s AdamW tolerance, rtol 2e-4 / atol 1e-5);
  * ``broadcast_params`` leaves every rank with rank 0's parameters and
    optimizer state;
  * the deterministic chunk through ``make_distributed_selfplay`` equals
    the local chunk's columns and ``torch_port_selfplay.json``;
  * ``dryrun_multichip(2)``: the loss falls;
  * the learn check's initial net (``chip_smoke.py`` phase 26 (d)),
    ``tests/fixtures/torch_port_learn_init.npz``, equals JAX's
    ``init_params(PRNGKey(0))`` leaf for leaf and, loaded into the port's
    net, computes JAX's forward.

Regenerate the fixtures with ``XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_parallel.py`` (the
conftest's 8 CPU devices).
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from tests import torch_port_cases as cases
from twixt_for_open_spiel_tpu import parallel as jpar
from twixt_for_open_spiel_tpu.models import network as jnet
from twixt_for_open_spiel_tpu.models import selfplay as jsp
from twixt_for_open_spiel_tpu_torch import parallel
from twixt_for_open_spiel_tpu_torch.models import convert
from twixt_for_open_spiel_tpu_torch.models import selfplay as tsp
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.parallel import launch

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_sharded_rollout.json"
SPAWN_TIMEOUT = 60.0
# board: (global batch, steps, seed) of the sharded bitboard rollouts
BIT_CASES = {5: (16, 32, 7), 8: (16, 40, 11)}
ROLLOUT = {"board_size": 5, "batch": 16, "num_steps": 48, "seed": 5}
# the card's headline row (chip_smoke.py phase 26), pinned from JAX
FIXTURE_CASE = {"board_size": 8, "batch": 4096, "num_steps": 1000, "seed": 0}
TRAIN = cases.TRAIN
N = cases.CHUNK["board_size"]
TOL = {"rtol": 2e-5, "atol": 1e-6}
METRICS = ("loss", "policy_loss", "value_loss", "train_frames")


def spawn(world, jobs):
    return parallel.spawn_ranks(cases.dist_rank, world, ("cpu", jobs), timeout=SPAWN_TIMEOUT)


# --- the inputs of the train pins ---------------------------------------------

def seeded_flax():
    return convert.params_to_flax(
        cases.random_state_dict(N, TRAIN["channels"], TRAIN["blocks"], TRAIN["param_seed"]))


@functools.lru_cache(maxsize=None)
def train_sample():
    """The deterministic chunk with the bootstrap, the weights of its first
    half of envs zeroed: rank 0 of 2 holds no finished frame."""
    s = cases.deterministic_chunk("cpu", TRAIN["value_bootstrap"])[1]
    w = s.weight.clone()
    w[:, : w.shape[1] // 2] = 0.0
    assert float(w.sum()) > 0
    return s._replace(weight=w)


def train_jobs():
    common = dict(flax_params=seeded_flax(), sample=train_sample(),
                  channels=TRAIN["channels"], blocks=TRAIN["blocks"])
    jobs = [(f"sgd{k}", "train", dict(common, optimizer="sgd", lr=0.1, microbatch=k, steps=1))
            for k in (1, 3)]
    jobs.append(("adamw", "train", dict(common, optimizer="adamw", lr=TRAIN["lr"],
                                       microbatch=1, steps=TRAIN["steps"])))
    return jobs


def bit_jobs():
    return [(f"bit{n}_{fused}", "bit_rollout",
             dict(board_size=n, batch=b, num_steps=t, seed=s, fused=fused))
            for n, (b, t, s) in BIT_CASES.items() for fused in (True, False)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jobs = bit_jobs() + [("rollout", "rollout", ROLLOUT), ("broadcast", "broadcast", {})]
    jobs += train_jobs()
    jobs += [(f"chunk{vb}", "chunk", {"value_bootstrap": vb}) for vb in (0.0, 0.5)]
    return cases.shared_result(tmp_path_factory, "torch_parallel_world2",
                               lambda: spawn(2, jobs))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    jobs = bit_jobs() + [("rollout", "rollout", ROLLOUT)] + train_jobs()[:2]
    return cases.shared_result(tmp_path_factory, "torch_parallel_world4",
                               lambda: spawn(4, jobs))


@pytest.fixture(scope="module")
def worlds(world2, world4):
    return {2: world2, 4: world4}


# --- the mesh and the launch ----------------------------------------------------

class Dev:
    def __init__(self, pid, did):
        self.process_index, self.id = pid, did


LAYOUTS = {
    "interleaved_4x4": [(d % 4, d) for d in range(16)],
    "reversed_2x4": [(1 - d // 4, 7 - d) for d in range(8)],
    "uneven_hosts": [(2, 5), (0, 3), (1, 9), (0, 1), (2, 0), (1, 2)],
    "one_host": [(0, d) for d in (3, 1, 2, 0)],
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hosts_major_order_matches_jax(layout):
    devs = [Dev(p, d) for p, d in LAYOUTS[layout]]
    got = parallel.hosts_major_order(devs)
    assert got == jpar.hosts_major_order(devs)
    assert [(d.process_index, d.id) for d in got] == sorted(LAYOUTS[layout])


@pytest.mark.parametrize("rank,size,batch,want", [
    (0, 2, 16, (0, 8)), (1, 2, 16, (8, 16)), (3, 4, 4096, (3072, 4096)), (0, 1, 5, (0, 5))])
def test_env_mesh_columns(rank, size, batch, want):
    mesh = parallel.EnvMesh(rank, size, torch.device("cpu"))
    cols = mesh.columns(batch)
    assert (cols.start, cols.stop) == want


def test_env_mesh_raises_when_the_ranks_do_not_divide_the_batch():
    mesh = parallel.EnvMesh(0, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="do not divide"):
        mesh.columns(10)
    with pytest.raises(ValueError, match="do not divide"):
        parallel.sharded_bit_reset(5, 10, mesh)
    with pytest.raises(ValueError, match="do not divide"):
        parallel.sharded_batch_reset(5, 6, mesh)


def test_world_of_one_without_a_group():
    """No group: a mesh of one whose collectives are the identity, as JAX's
    mesh over one device."""
    assert not dist.is_initialized()
    mesh = parallel.make_env_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))
    roll, _ = parallel.make_sharded_bit_rollout(5, 12, mesh)
    final, stats = roll(3, parallel.sharded_bit_reset(5, 8, mesh))
    want, wstats = tbit.bit_random_rollout(3, 5, 12, tbit.bit_reset(5, 8, "cpu"))
    assert tbit.state_digest(final) == tbit.state_digest(want)
    assert int(stats["episodes"]) == int(wstats["episodes"])
    assert stats["results"].tolist() == wstats["results"].tolist()


def test_shard_env_pytree_cuts_columns():
    mesh = parallel.EnvMesh(1, 2, torch.device("cpu"))
    sample = train_sample()
    shard = parallel.shard_env_pytree(sample, mesh)
    for a, b in zip(shard, sample):
        assert torch.equal(a, b[:, 4:8])
    bs = tbit.bit_random_rollout(2, 5, 9, tbit.bit_reset(5, 8, "cpu"))[0]
    shard = tbit.bitstate_leaves(parallel.shard_env_pytree(bs, mesh))
    for a, b in zip(shard, tbit.bitstate_leaves(bs)):
        assert torch.equal(a, b[..., 4:8]) and a.is_contiguous()


@pytest.mark.parametrize("seed,rank", [(0, 1), (7, 3), (0xFFFFFFF0, 2), (123456789, 7)])
def test_rank_seed_is_jax_u32_sum(seed, rank):
    want = jnp.asarray(seed, jnp.uint32) + jnp.uint32(rank) * jnp.uint32(0x01000193)
    assert parallel.envsharding.rank_seed(seed, rank) == int(want)


def test_initialize_distributed_is_a_noop_in_a_world_of_one(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed(device="cpu") == (0, 1)
    assert not dist.is_initialized()


class FakeGroup:
    """``init_process_group`` recorded, not run."""

    def __init__(self, monkeypatch):
        self.calls, self.devices = [], []
        monkeypatch.setattr(dist, "is_initialized", lambda: bool(self.calls))
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: self.calls.append((backend, kw)))
        monkeypatch.setattr(dist, "get_rank", lambda: self.calls[-1][1]["rank"])
        monkeypatch.setattr(dist, "get_world_size", lambda: self.calls[-1][1]["world_size"])
        monkeypatch.setattr(torch.cuda, "set_device", self.devices.append)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.parametrize("device,backend,local", [("cpu", "gloo", []), ("cuda", "nccl", [3])])
def test_initialize_distributed_reads_torchrun(device, backend, local, monkeypatch):
    fake = FakeGroup(monkeypatch)
    for var, value in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "8476"),
                       ("WORLD_SIZE", "8"), ("RANK", "7"), ("LOCAL_RANK", "3")):
        monkeypatch.setenv(var, value)
    assert parallel.initialize_distributed(device=device) == (7, 8)
    (got_backend, kw), = fake.calls
    assert got_backend == backend and fake.devices == local
    assert kw == {"init_method": "env://", "world_size": 8, "rank": 7,
                  "timeout": launch.GROUP_TIMEOUT}
    assert launch.GROUP_TIMEOUT.total_seconds() >= 3600


@pytest.mark.parametrize("address,url", [
    ("10.0.0.1:8476", "tcp://10.0.0.1:8476"), ("file:///shared/rdzv", "file:///shared/rdzv")])
def test_initialize_distributed_takes_the_coordinator_flags(address, url, monkeypatch):
    fake = FakeGroup(monkeypatch)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed(address, 4, 2, device="cuda") == (2, 4)
    (backend, kw), = fake.calls
    assert (backend, kw["init_method"], fake.devices) == ("nccl", url, [2])


def test_initialize_distributed_is_idempotent(monkeypatch):
    fake = FakeGroup(monkeypatch)
    assert parallel.initialize_distributed("localhost:1", 2, 1, device="cpu") == (1, 2)
    assert parallel.initialize_distributed("localhost:2", 3, 0, device="cpu") == (1, 2)
    assert parallel.initialize_world(device="cpu") == (1, 2)
    assert len(fake.calls) == 1


# --- the sharded rollouts ---------------------------------------------------------

def jax_shards(final, mesh) -> list:
    """Each mesh position's shard of a JAX BitState, as a port BitState."""
    out = []
    for d in mesh.devices.flat:
        leaves = [np.asarray({s.device: s for s in leaf.addressable_shards}[d].data)
                  for leaf in jax.tree_util.tree_leaves(final)]
        out.append(tbit.bitstate_from_numpy(leaves, "cpu"))
    return out


@functools.lru_cache(maxsize=None)
def jax_bit_rollout(world, n, batch, steps, seed):
    if jax.device_count() < world:
        raise RuntimeError(f"{world} JAX devices needed, {jax.device_count()} present")
    mesh = jpar.make_env_mesh(jax.devices()[:world])
    roll, _ = jpar.make_sharded_bit_rollout(n, steps, mesh)
    final, stats = roll(seed, jpar.sharded_bit_reset(n, batch, mesh))
    return (jax_shards(final, mesh), int(stats["episodes"]),
            [int(r) for r in np.asarray(stats["results"])])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n", list(BIT_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bit_rollout_matches_jax(worlds, world, n, fused):
    shards, episodes, results = jax_bit_rollout(world, n, *BIT_CASES[n])
    assert episodes > 0
    for rank, want in enumerate(shards):
        got = worlds[world][rank][f"bit{n}_{fused}"]
        assert got["launches"] == 0  # CPU tensors run the plain version
        assert (got["episodes"], got["results"]) == (episodes, results)
        for i, (a, b) in enumerate(zip(got["leaves"], tbit.bitstate_leaves(want))):
            assert torch.equal(a, b), f"rank {rank} leaf {i}"


@pytest.mark.parametrize("n", list(BIT_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bit_rollout_rank_streams_differ(worlds, world, n):
    """The ranks' seeds differ, so their shards (reset alike) do too; the
    reduced stats are the sum of the ranks' own (each rank's shard is the
    plain rollout of its seed)."""
    ranks = worlds[world]
    b, t, seed = BIT_CASES[n]
    reds = {r[f"bit{n}_True"]["leaves"][0].numpy().tobytes() for r in ranks}
    assert len(reds) == world
    per = [tbit.bit_random_rollout(parallel.envsharding.rank_seed(seed, r), n, t,
                                   tbit.bit_reset(n, b // world, "cpu"))[1] for r in range(world)]
    assert ranks[0][f"bit{n}_True"]["episodes"] == sum(int(s["episodes"]) for s in per)
    assert ranks[0][f"bit{n}_True"]["results"] == sum(s["results"] for s in per).tolist()


def fixture_record(world) -> dict:
    c = FIXTURE_CASE
    shards, episodes, results = jax_bit_rollout(world, c["board_size"], c["batch"],
                                                c["num_steps"], c["seed"])
    return {**c, "world_size": world, "digests": [tbit.state_digest(s) for s in shards],
            "episodes": episodes, "results": results}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fixture_matches_jax(world):
    stored = {c["world_size"]: c for c in json.loads(FIXTURE.read_text())["cases"]}
    assert stored[world] == fixture_record(world)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_canonical_rollout_invariants(worlds, world):
    """``tests/test_sharding.py``'s invariants: episodes happen, none ends
    open, the results sum to the episodes (reduced over the ranks), every
    env is live again after its auto-reset, the state keeps its shard."""
    ranks = worlds[world]
    n, b = ROLLOUT["board_size"], ROLLOUT["batch"]
    for r in ranks:
        got = r["rollout"]
        assert got["color_shape"] == (n + 6, n + 6, b // world)
        assert got["all_open"]
        assert got["episodes"] > 0
        assert got["results"][geo.RESULT_OPEN] == 0
        assert sum(got["results"]) == got["episodes"]
        assert (got["episodes"], got["results"]) == (ranks[0]["rollout"]["episodes"],
                                                     ranks[0]["rollout"]["results"])
    boards = {r["rollout"]["color"].numpy().tobytes() for r in ranks}
    assert len(boards) == world  # the ranks' generators differ


# --- the learner ------------------------------------------------------------------

def local_sgd_step():
    net = cases.train_net(seeded_flax(), N, TRAIN["channels"], TRAIN["blocks"], "cpu")
    metrics = tsp.train_step(net, torch.optim.SGD(net.parameters(), 0.1), train_sample())
    return {k: v.clone() for k, v in net.state_dict().items()}, metrics


@functools.lru_cache(maxsize=None)
def jax_dist_step(microbatch):
    mesh = jpar.make_env_mesh(jax.devices()[:2])
    net = jnet.create_net(N, TRAIN["channels"], TRAIN["blocks"], dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, seeded_flax())
    s = train_sample()
    sample = jsp.Sample(jnp.asarray(s.obs.numpy().view(np.uint32)),
                        *(jnp.asarray(x.numpy()) for x in s[1:]))
    opt = optax.sgd(0.1)
    trainer, _ = jpar.make_distributed_train_step(net.apply, opt, mesh, microbatch=microbatch)
    p, _, m = trainer(params, opt.init(params), sample)
    return (convert.params_from_flax(jax.tree_util.tree_map(np.asarray, p)),
            {k: float(v) for k, v in m.items()})


def assert_params_close(got: dict, want: dict, what: str, **tol):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **tol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("microbatch", [1, 3])
@pytest.mark.parametrize("world", [2, 4])
def test_dist_train_step_matches_local(worlds, world, microbatch):
    want, m_loc = local_sgd_step()
    got = worlds[world][0][f"sgd{microbatch}"]
    assert_params_close(got["params"], want, f"microbatch={microbatch}", **TOL)
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][0][k], float(m_loc[k]), rtol=2e-5, err_msg=k)


@pytest.mark.parametrize("microbatch", [1, 3])
def test_dist_train_step_matches_jax(world2, microbatch):
    want, m_jax = jax_dist_step(microbatch)
    got = world2[0][f"sgd{microbatch}"]
    assert_params_close(got["params"], want, f"microbatch={microbatch}", **TOL)
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][0][k], m_jax[k], rtol=2e-5, err_msg=k)
    # the global finished-frame count, though rank 0's shard has none
    assert got["metrics"][0]["train_frames"] == float(train_sample().weight.sum()) > 0


@pytest.mark.parametrize("job", ["sgd1", "sgd3", "adamw"])
def test_dist_train_ranks_bitwise_equal(world2, job):
    a, b = (r[job] for r in world2)
    assert a["metrics"] == b["metrics"]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name


def test_dist_adamw_steps_match_local(world2):
    net = cases.train_net(seeded_flax(), N, TRAIN["channels"], TRAIN["blocks"], "cpu")
    opt = tsp.make_optimizer(net.parameters(), TRAIN["lr"])
    got = world2[0]["adamw"]
    for k in range(TRAIN["steps"]):
        m = tsp.train_step(net, opt, train_sample())
        for key in METRICS:
            np.testing.assert_allclose(got["metrics"][k][key], float(m[key]), rtol=1e-5,
                                       err_msg=f"step {k} {key}")
    assert_params_close(got["params"], net.state_dict(), "adamw", rtol=2e-4, atol=1e-5)


def test_broadcast_params_makes_rank_zeros(world2):
    a, b = (r["broadcast"] for r in world2)
    assert a.keys() == b.keys() and any(k.startswith("opt.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    want = cases.random_state_dict(5, 8, 1, seed=10)
    assert not torch.equal(a["stem.weight"], want["stem.weight"])  # rank 0 stepped
    assert float(a["opt.0.step"]) == 1.0


@pytest.mark.parametrize("value_bootstrap", [0.0, 0.5])
def test_dist_chunk_matches_local_columns_and_fixture(world2, value_bootstrap):
    parts = [r[f"chunk{value_bootstrap}"] for r in world2]
    final = tbit.bitstate_from_leaves(cases.concat_ranks([p["final"] for p in parts]))
    sample = tsp.Sample(*cases.concat_ranks([p["sample"] for p in parts], 1))
    lfinal, lsample = cases.deterministic_chunk("cpu", value_bootstrap)
    for a, b in zip(sample, lsample):
        assert torch.equal(a, b)
    assert tbit.state_digest(final) == tbit.state_digest(lfinal)
    rec = json.loads((FIXTURE.parent / "torch_port_selfplay.json").read_text())
    want = rec["chunks"][str(value_bootstrap)]
    got = cases.sample_record(final, sample)
    assert got == {k: v for k, v in want.items() if k != "aux"}


def test_initialize_world_makes_a_group_of_one():
    """With no group asked for, ``initialize_world`` makes a real world of
    one (gloo on the CPU, no rendezvous): its collectives run, and a second
    call keeps it."""
    got, = parallel.spawn_ranks(cases.world_of_one_rank, 1, timeout=SPAWN_TIMEOUT)
    assert got == {"world": (0, 1), "backend": "gloo", "again": (0, 1), "sum": [3.0, 4.0],
                   "mesh": (0, 1)}


def test_dryrun_multichip_loss_falls():
    losses = parallel.dryrun_multichip(2, device="cpu", timeout=SPAWN_TIMEOUT)
    assert len(losses) == 6 and losses[3:] != losses[:3]


# --- the learn check's initial net ------------------------------------------------

def jax_learn_init() -> dict:
    """JAX's initial parameters of the learn check, by ``/``-joined path."""
    c = cases.LEARN
    net = jnet.create_net(c["board_size"], channels=c["channels"], blocks=c["blocks"])
    params = jnet.init_params(net, jax.random.PRNGKey(c["param_seed"]))
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def test_learn_init_fixture_matches_jax():
    want = jax_learn_init()
    with np.load(cases.LEARN_INIT) as got:
        assert sorted(got.files) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype == np.float32 and np.array_equal(got[k], w), k


def test_learn_init_loads_as_jax_forward():
    """The fixture in the port's float32 net computes JAX's forward within
    ``tests/test_torch_network.py``'s 1e-5 of the scale."""
    c = cases.LEARN
    n = c["board_size"]
    net = cases.train_net(cases.learn_init_flax(), n, c["channels"], c["blocks"], "cpu")
    obs = cases.random_obs(8, n, seed=9)
    jax_net = jnet.create_net(n, channels=c["channels"], blocks=c["blocks"], dtype=jnp.float32)
    tree = jax.tree_util.tree_map(jnp.asarray, cases.learn_init_flax())
    want = [np.asarray(x) for x in jax_net.apply(tree, jnp.asarray(obs))]
    with torch.no_grad():
        got = [x.numpy() for x in net(torch.from_numpy(obs))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


if __name__ == "__main__":
    np.savez_compressed(cases.LEARN_INIT, **jax_learn_init())
    FIXTURE.write_text(json.dumps({"cases": [fixture_record(w) for w in (2, 4)]}, indent=1)
                       + "\n")
    print(FIXTURE.read_text())
