"""The port's learner (``models/selfplay.py`` ``loss_fn``,
``accumulate_grads``, ``train_step``, ``make_optimizer``) and the optimizer
state converter (``models/convert.py``) against JAX and optax, on the CPU.

One float32 net with seeded parameters (``tests/torch_port_cases``) goes
to both sides through ``convert.params_to_flax``; the sample is the port's
deterministic chunk, which ``tests/test_torch_selfplay.py`` holds equal to
JAX's.  Tolerances, float32 on both sides: the loss metrics to rtol 1e-6
(1e-5 inside the train steps); each gradient leaf within 1e-5 of its
largest magnitude (measured: 1.3e-6 at most); parameters after each AdamW
step to rtol 2e-4 with atol 1e-5, the tolerance of JAX's own microbatch
pin (measured: 7.6e-6 at most, on value_hidden.weight after three unclipped
steps, where Adam divides near-zero gradients by their own size).

``tests/fixtures/torch_port_train.json`` holds a summary of the JAX record
(``cases.summarize``: each leaf's norm and a seeded projection);
``chip_smoke.py`` holds the card to it.  Regenerate it with
``PYTHONPATH=. python tests/test_torch_train.py``.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_port_cases as cases
from twixt_for_open_spiel_tpu.models import network as jnet
from twixt_for_open_spiel_tpu.models import selfplay as jsp
from twixt_for_open_spiel_tpu_torch.models import convert
from twixt_for_open_spiel_tpu_torch.models import selfplay as tsp
from twixt_for_open_spiel_tpu_torch.models.network import AZNet, call_net, create_net

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_port_train.json"
CFG = cases.TRAIN
N = cases.CHUNK["board_size"]
LEAVES = list(AZNet(N, CFG["channels"], CFG["blocks"]).state_dict())
METRICS = ("loss", "policy_loss", "value_loss", "train_frames", "target_entropy")
PARAM_TOL = {"rtol": 2e-4, "atol": 1e-5}


@functools.lru_cache(maxsize=None)
def port_sample():
    return cases.deterministic_chunk("cpu", CFG["value_bootstrap"])[1]


def jax_sample():
    s = port_sample()
    return jsp.Sample(jnp.asarray(s.obs.numpy().view(np.uint32)),
                      *(jnp.asarray(x.numpy()) for x in s[1:]))


def seeded_state():
    return cases.random_state_dict(N, CFG["channels"], CFG["blocks"], CFG["param_seed"])


def port_net():
    net = create_net(N, CFG["channels"], CFG["blocks"], dtype=torch.float32, device="cpu")
    net.load_state_dict(seeded_state())
    return net


JNET = jnet.create_net(N, CFG["channels"], CFG["blocks"], dtype=jnp.float32)


def jax_params():
    return jax.tree_util.tree_map(jnp.asarray, convert.params_to_flax(seeded_state()))


def as_torch_layout(tree) -> dict:
    return convert.params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def jax_run():
    """JAX's loss metrics and gradients on the sample, and three
    ``train_step``s under each clip (parameters in the port's layout)."""
    sample, params = jax_sample(), jax_params()
    grads, metrics = jax.grad(jsp.loss_fn, has_aux=True)(params, JNET.apply, sample)
    run = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": as_torch_layout(grads), "steps": {}}
    for name, clip in CFG["clips"].items():
        opt = jsp.make_optimizer(CFG["lr"], clip_norm=clip)
        p, st, steps = params, opt.init(params), []
        for _ in range(CFG["steps"]):
            p, st, m = jsp.train_step(p, st, sample, net_apply=JNET.apply, optimizer=opt)
            steps.append({"metrics": {k: float(v) for k, v in m.items()},
                          "params": as_torch_layout(p)})
        run["steps"][name] = steps
    return run


def jax_record():
    run = jax_run()
    return {
        "board_size": N, **CFG, "chunk": cases.CHUNK,
        "metrics": run["metrics"],
        "grads": cases.summarize(run["grads"]),
        "steps": {name: [{"metrics": s["metrics"], "params": cases.summarize(s["params"])}
                         for s in steps] for name, steps in run["steps"].items()},
    }


@functools.lru_cache(maxsize=None)
def port_grads():
    net = port_net()
    loss, metrics = tsp.loss_fn(net, call_net, port_sample())
    loss.backward()
    return metrics, {name: p.grad for name, p in net.named_parameters()}


def test_fixture_matches_jax():
    rec, stored = jax_record(), json.loads(FIXTURE.read_text())
    assert {k: v for k, v in stored.items() if k not in ("metrics", "grads", "steps")} == {
        k: v for k, v in rec.items() if k not in ("metrics", "grads", "steps")}
    np.testing.assert_allclose([stored["metrics"][k] for k in METRICS],
                               [rec["metrics"][k] for k in METRICS], rtol=1e-6)
    assert cases.summary_err(rec["grads"], stored["grads"]) <= 1e-6
    for name in CFG["clips"]:
        for got, want in zip(rec["steps"][name], stored["steps"][name]):
            assert cases.summary_err(got["params"], want["params"]) <= 1e-6


def test_loss_metrics_match_jax():
    metrics, _ = port_grads()
    want = jax_run()["metrics"]
    assert set(metrics) == set(METRICS)
    for k in METRICS:
        assert not metrics[k].requires_grad
        np.testing.assert_allclose(float(metrics[k]), want[k], rtol=1e-6, err_msg=k)
    w = port_sample().weight
    assert float(metrics["train_frames"]) == float(w.sum())
    assert 0 < float(w.sum()) < w.numel()


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_matches_jax(leaf):
    got = port_grads()[1][leaf].numpy()
    want = jax_run()["grads"][leaf].numpy()
    assert np.abs(want).max() > 0, "the leaf should get gradient"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def global_norm(grads) -> float:
    return float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))


@pytest.mark.parametrize("clip", list(CFG["clips"]))
def test_train_steps_match_optax(clip):
    """Three steps on the same sample against JAX's ``train_step``: the
    clip on one side of the gradient's global norm, then the other."""
    net = port_net()
    clip_norm = CFG["clips"][clip]
    opt = tsp.make_optimizer(net.parameters(), CFG["lr"], clip_norm=clip_norm)
    norm = global_norm(port_grads()[1].values())
    assert (norm < clip_norm) == (clip == "below"), norm
    for k, want in enumerate(jax_run()["steps"][clip]):
        metrics = tsp.train_step(net, opt, port_sample())
        for key in METRICS:
            np.testing.assert_allclose(float(metrics[key]), want["metrics"][key], rtol=1e-5,
                                       err_msg=f"step {k} {key}")
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(), **PARAM_TOL,
                                       err_msg=f"step {k} {name}")


def test_opt_state_from_optax_continues_a_jax_run():
    """A JAX step, its optax state carried across, then the port's next
    step equals JAX's next step; and the state carries back."""
    sample, params = jax_sample(), jax_params()
    opt = jsp.make_optimizer(CFG["lr"])
    p1, st1, _ = jsp.train_step(params, opt.init(params), sample, net_apply=JNET.apply,
                                optimizer=opt)
    p2, st2, m2 = jsp.train_step(p1, st1, sample, net_apply=JNET.apply, optimizer=opt)

    net = create_net(N, CFG["channels"], CFG["blocks"], dtype=torch.float32, device="cpu")
    convert.load_flax_params(net, jax.tree_util.tree_map(np.asarray, p1))
    topt = tsp.make_optimizer(net.parameters(), CFG["lr"])
    topt.load_state_dict(convert.opt_state_from_optax(st1, topt, net))
    assert all(float(s["step"]) == 1.0 for s in topt.state.values())
    back = convert.opt_state_to_optax(topt, net, st1)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(st1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(st1)

    metrics = tsp.train_step(net, topt, port_sample())
    np.testing.assert_allclose(float(metrics["loss"]), float(m2["loss"]), rtol=1e-6)
    want = as_torch_layout(p2)
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **PARAM_TOL, err_msg=name)
    back2 = convert.opt_state_to_optax(topt, net, st2)
    for a, b in zip(jax.tree_util.tree_leaves(back2), jax.tree_util.tree_leaves(st2)):
        b = np.asarray(b)  # the moments, each within 1e-5 of its largest magnitude
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("k", [2, 3, 4, 6, 12])
def test_train_microbatch_matches_monolithic(k):
    """K equal time slices with the value term over val_denom / K: the same
    metrics and updated parameters as the monolithic step, to JAX's own
    pin's tolerances."""
    sample = port_sample()
    ref, net = port_net(), port_net()
    m_ref = tsp.train_step(ref, tsp.make_optimizer(ref.parameters(), CFG["lr"]), sample)
    m_k = tsp.train_step(net, tsp.make_optimizer(net.parameters(), CFG["lr"]), sample,
                         microbatch=k)
    for key in METRICS:
        np.testing.assert_allclose(float(m_k[key]), float(m_ref[key]), rtol=1e-5, err_msg=key)
    for (name, a), b in zip(ref.state_dict().items(), net.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **PARAM_TOL, err_msg=name)


def test_microbatch_must_divide_the_chunk():
    net = port_net()
    with pytest.raises(ValueError, match="microbatch 5"):
        tsp.train_step(net, tsp.make_optimizer(net.parameters()), port_sample(), microbatch=5)


def test_make_optimizer_settings():
    net = port_net()
    opt = tsp.make_optimizer(net.parameters())
    (group,) = opt.param_groups
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        2e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert opt.clip_norm == 1.0


if __name__ == "__main__":
    FIXTURE.write_text(json.dumps(jax_record(), indent=1) + "\n")
    print(FIXTURE.read_text()[:1500])
