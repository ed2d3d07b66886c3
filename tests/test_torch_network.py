"""The port's net (``models/network.py``) and its flax converter
(``models/convert.py``) against the JAX ``AZNet``, on the CPU.

Tolerances, against flax ``AZNet.apply`` on the same converted parameters
and the same observations (``scale`` = max(1, max |flax output|)):

  * float32 compute: |port - flax| <= 1e-5 * scale;
  * bfloat16 compute: logits |port - flax| <= 2**-5 * scale (four bf16
    ulps of the largest logit), value <= 2**-4 (it leaves an f32 LayerNorm
    of 256 bf16 features).

Also the repair of ``bit_rollout_emit_obs``: its unpacked arm, the bf16
observations a learner feeds the net, equals JAX's bit for bit.

``tests/fixtures/torch_port_net.json`` holds a small net's JAX float32
outputs for seeded parameters and observations (``tests/torch_port_cases``);
``chip_smoke.py`` holds the port on the card to it.  Regenerate it with
``PYTHONPATH=. python tests/test_torch_network.py``.
"""

import functools
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_port_cases as cases
from twixt_for_open_spiel_tpu.models import network as jnet
from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu_torch.models import convert
from twixt_for_open_spiel_tpu_torch.models import network as tnet
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_net.json"
# the anchor: (board, channels, blocks, param seed, batch, obs seed)
ANCHOR = (5, 8, 1, 3, 16, 4)
TOL = {"f32": (1e-5, 1e-5), "bf16": (2.0**-5, 2.0**-4)}  # (logits, value)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def flax_outputs(flax_params, obs, n, channels, blocks, jdtype=jnp.float32):
    net = jnet.create_net(n, channels, blocks, dtype=jdtype)
    logits, value = net.apply(flax_params, jnp.asarray(obs))
    return np.asarray(logits), np.asarray(value)


def port_outputs(state, obs, n, channels, blocks, dtype=torch.float32):
    net = tnet.AZNet(n, channels, blocks, dtype)
    net.load_state_dict(state)
    with torch.no_grad():
        logits, value = net(torch.from_numpy(obs))
    assert logits.dtype == value.dtype == torch.float32
    return logits.numpy(), value.numpy()


def assert_close(got, want, rel, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} * {scale}"


def anchor_record():
    n, ch, blocks, pseed, batch, oseed = ANCHOR
    tree = convert.params_to_flax(cases.random_state_dict(n, ch, blocks, pseed))
    logits, value = flax_outputs(tree, cases.random_obs(batch, n, oseed), n, ch, blocks)
    return {
        "board_size": n, "channels": ch, "blocks": blocks, "param_seed": pseed,
        "batch": batch, "obs_seed": oseed,
        "tolerance": "|port - jax| <= 1e-5 * max(1, max |jax|), float32",
        "logits": logits.tolist(), "value": value.tolist(),
    }


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("n,channels,blocks", [(5, 8, 1), (8, 16, 2)])
def test_net_matches_flax(n, channels, blocks, kind):
    tdt, jdt = DTYPES[kind]
    state = cases.random_state_dict(n, channels, blocks, seed=n)
    obs = cases.random_obs(12, n, seed=n + 1)
    want = flax_outputs(convert.params_to_flax(state), obs, n, channels, blocks, jdt)
    got = port_outputs(state, obs, n, channels, blocks, tdt)
    rel_logits, rel_value = TOL[kind]
    assert_close(got[0], want[0], rel_logits, f"{kind} logits")
    assert_close(got[1], want[1], rel_value, f"{kind} value")
    assert np.abs(want[1]).max() > 0.1  # the value head is not trivial


@functools.lru_cache(maxsize=None)
def flax_init(n, ch, blocks):
    # jnet.init_params under jit: the same parameters, half the set-up
    net = jnet.create_net(n, ch, blocks, dtype=jnp.float32)
    obs = jnp.zeros((1, 12, n, n - 2), jnp.float32)
    return jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), obs))


def test_flax_init_carries_over():
    # flax's own initial parameters, converted: the zero-init value head
    # gives exactly 0 on both sides
    n, ch, blocks = 5, 8, 2
    tree = flax_init(n, ch, blocks)
    obs = cases.random_obs(6, n, seed=9)
    want = flax_outputs(tree, obs, n, ch, blocks)
    got = port_outputs(convert.params_from_flax(tree), obs, n, ch, blocks)
    assert_close(got[0], want[0], 1e-5, "logits")
    assert np.all(got[1] == 0) and np.all(want[1] == 0)


def test_converter_round_trips_every_leaf():
    n, ch, blocks = 5, 8, 2
    tree = flax_init(n, ch, blocks)
    back = convert.params_to_flax(convert.params_from_flax(tree))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want) == 20 + 8 * blocks
    for path, leaf in want:
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    # and the torch side round-trips through a module
    port = convert.load_flax_params(tnet.AZNet(n, ch, blocks), tree)
    again = convert.params_from_flax(convert.params_to_flax(port.state_dict()))
    for k, v in port.state_dict().items():
        assert torch.equal(again[k], v), k


def test_converter_fails_loudly():
    n, ch, blocks = 5, 8, 1
    tree = convert.params_to_flax(cases.random_state_dict(n, ch, blocks, seed=0))
    missing = convert.params_to_flax(cases.random_state_dict(n, ch, blocks, seed=0))
    del missing["params"]["Dense_1"]["bias"]
    with pytest.raises(KeyError, match=r"missing \[\('params', 'Dense_1', 'bias'\)\]"):
        convert.params_from_flax(missing)
    extra = convert.params_to_flax(cases.random_state_dict(n, ch, blocks, seed=0))
    extra["params"]["LayerNorm_9"] = {"scale": np.ones(8, np.float32)}
    with pytest.raises(KeyError, match="extra"):
        convert.params_from_flax(extra)
    with pytest.raises(KeyError, match="missing"):
        convert.params_to_flax({"stem.weight": torch.zeros(1)})
    # a tree of another board size does not load
    with pytest.raises(RuntimeError, match="size mismatch"):
        convert.load_flax_params(tnet.AZNet(n + 1, ch, blocks), tree)


def test_layouts_against_flax_leaves():
    n, ch, blocks = 6, 8, 1
    state = cases.random_state_dict(n, ch, blocks, seed=2)
    tree = convert.params_to_flax(state)["params"]
    # HWIO <-> OIHW, [in, out] <-> [out, in], scale <-> weight
    np.testing.assert_array_equal(
        tree["ResBlock_0"]["Conv_1"]["kernel"][1, 2, 3, 4],
        state["blocks.0.conv1.weight"][4, 3, 1, 2].numpy())
    np.testing.assert_array_equal(tree["Dense_0"]["kernel"].T, state["policy_out.weight"].numpy())
    np.testing.assert_array_equal(tree["LayerNorm_3"]["scale"], state["value_hidden_norm.weight"].numpy())
    assert tree["Dense_2"]["kernel"].shape == (256, 1)


def test_fixture_matches_jax():
    stored, want = json.loads(FIXTURE.read_text()), anchor_record()
    for key in ("logits", "value"):
        np.testing.assert_allclose(stored.pop(key), want.pop(key), rtol=0, atol=1e-6)
    assert stored == want


def test_port_matches_fixture():
    rec = json.loads(FIXTURE.read_text())
    n, ch, blocks = rec["board_size"], rec["channels"], rec["blocks"]
    state = cases.random_state_dict(n, ch, blocks, rec["param_seed"])
    obs = cases.random_obs(rec["batch"], n, rec["obs_seed"])
    logits, value = port_outputs(state, obs, n, ch, blocks)
    assert_close(logits, np.array(rec["logits"], np.float32), 1e-5, "logits")
    assert_close(value, np.array(rec["value"], np.float32), 1e-5, "value")


def test_create_net_defaults():
    sig = inspect.signature(tnet.create_net).parameters
    assert sig["device"].default == "cuda"
    assert (sig["channels"].default, sig["blocks"].default) == (128, 6)
    assert sig["dtype"].default is torch.bfloat16
    net = tnet.create_net(5, 8, 1, device="cpu")
    assert all(p.dtype == torch.float32 for p in net.parameters())
    again = tnet.create_net(5, 8, 1, device="cpu")
    for (k, a), b in zip(net.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k  # seeded: the same weights every time
    with torch.no_grad():
        logits, value = net(torch.from_numpy(cases.random_obs(4, 5, seed=0)))
    assert logits.shape == (4, 25) and logits.dtype == torch.float32
    assert torch.all(value == 0)  # the zero-init value head


def test_masked_policy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((64, 144))).astype(np.float32)
    legal = rng.random((64, 144)) < 0.7
    want = np.asarray(jnet.masked_policy(jnp.asarray(logits), jnp.asarray(legal)))
    got = tnet.masked_policy(torch.from_numpy(logits), torch.from_numpy(legal)).numpy()
    assert np.all(got[~legal] == 0)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n,batch,steps,seed", [(5, 64, 30, 3), (24, 8, 6, 1)])
def test_emit_obs_unpacked_matches_jax(n, batch, steps, seed):
    jf, js, jobs = jbit.bit_rollout_emit_obs(seed, n, steps, jbit.bit_reset(n, batch))
    tf, ts, tobs = tbit.bit_rollout_emit_obs(seed, n, steps, tbit.bit_reset(n, batch, "cpu"))
    assert tobs.dtype == torch.bfloat16 and jobs.dtype == jnp.bfloat16
    assert tobs.shape == jobs.shape == (steps, batch, 12, n, n - 2)
    np.testing.assert_array_equal(tobs.float().numpy(), np.asarray(jobs, np.float32))
    assert int(ts["episodes"]) == int(js["episodes"])
    assert int(ts["episodes"]) > 0 or n == 24
    jl = [np.asarray(x).astype(np.int64) for x in jax.tree_util.tree_leaves(jf)]
    for i, (a, b) in enumerate(zip(tbit.bitstate_leaves(tf), jl)):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), b, err_msg=f"leaf {i}")
    assert "packed" in inspect.signature(tbit.bit_rollout_emit_obs).parameters
    assert inspect.signature(tbit.bit_rollout_emit_obs).parameters["packed"].default is False


if __name__ == "__main__":
    FIXTURE.write_text(json.dumps(anchor_record()) + "\n")
    print(f"wrote {FIXTURE}")
