"""The training path of the board-12 recipe (BASELINE config 5:
``train_arena_gate --board_size=12 --chunk_steps=32 --simulations=64
--temp_moves=16``) against JAX, on the CPU, in the parts the board-5 pins
do not reach: the initial net's draw, the Dirichlet root noise and the
temperature draws at board 12, a board-12 chunk whose games cross the
chunk's boundary, and the bf16 learner step at config-5 width.

1. ``init_params`` against flax's ``net.init`` (board 12, 64x4): each
   kernel leaf's mean, standard deviation and largest |x| beside flax's
   ``PRNGKey(0)`` draw.  Tolerances from the leaf's element count N and its
   LeCun standard deviation s = sqrt(1 / fan_in): means within
   5 s sqrt(2 / N) of each other, standard deviations within 5 s / sqrt(N)
   (the difference of two sample deviations, a normal's fourth moment: the
   truncated one's is smaller), every |x| at most the truncation 2 s /
   0.8796 and the largest above 0.9 of it; biases and LayerNorm biases 0,
   LayerNorm scales 1 and the value head's output kernel 0, exactly.
2. The root prior with noise (``mcts.search_batch``'s, Dirichlet 0.3 at
   frac 0.25 over all 144 actions, then masked to the legal set) against
   JAX's expression of ``models/mcts.py``:641-650 with
   ``jax.random.dirichlet``: 2048 draws on each of four seeded board-12
   roots; per action the means within 5.5 standard errors, the mean
   variance over the legal set within 15 %, the mean entropy within 5
   standard errors.
3. The temperature draw (``arena._categorical`` as self-play and the arena
   call it) against ``jax.random.categorical`` on one board-12 visit
   distribution with illegal actions at -inf: 60,000 draws each, each
   side's chi-square against the distribution below its 5-sigma bound
   df + 5 sqrt(2 df), the two sides' two-sample chi-square below the same
   bound, no illegal draw; and an exponential draw of exactly 0 draws no
   action at -inf.
4. Two board-12 chunks in a row (``cases.CHUNK12``: greedy plies, no root
   noise, a seeded float32 16x1 net) equal to JAX's bit for bit:
   the obs wire, the policy, value and weight targets, the final boards.
5. The bf16 learner step at config-5 width (``cases.BF16_STEP``) against
   JAX's bf16 step, each beside float32 (``cases.BF16_TOLERANCE``): the
   loss metrics within rtol 2e-3 of JAX's (``train_frames`` and
   ``target_entropy``, which the sample alone decides, to 1e-6); the
   float32 gradients within 2e-3 of JAX's, leaf by leaf (relative L2); the
   bf16 gradients' error to JAX's float32 ones within 2x JAX's bf16 error
   plus 2e-3, leaf by leaf, and within 1.25x over all leaves; the AdamW
   update's the same over all leaves, and within 1.5x plus 0.02 on each
   leaf of 2048 elements or more (the first Adam step is about
   lr * sign(g), so a small leaf's error counts sign flips of near-zero
   gradients).  The port's errors are estimated from the record's 32
   seeded projections of each JAX leaf (``cases.rel_errors``; about 12 %
   of an error, one standard deviation), JAX's are exact.

Items 4 and 5 read JAX's records, ``tests/fixtures/torch_port_board12_chunk.json``
and ``torch_port_train_bf16.json``, which JAX takes about 40 s on the CPU
to make; ``chip_smoke.py`` holds the card's bf16 step to the second.
Regenerate them with ``PYTHONPATH=. python tests/test_torch_train_path.py``.
"""

import functools
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_port_cases as cases
from tests.test_torch_selfplay import port_sample, port_state
from twixt_for_open_spiel_tpu.models import network as jnet
from twixt_for_open_spiel_tpu.models import selfplay as jsp
from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu_torch.models import arena as tarena
from twixt_for_open_spiel_tpu_torch.models import convert
from twixt_for_open_spiel_tpu_torch.models import mcts as tmcts
from twixt_for_open_spiel_tpu_torch.models import network as tnet
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CHUNK_FIXTURE = FIXTURES / "torch_port_board12_chunk.json"
BF16_FIXTURE = FIXTURES / "torch_port_train_bf16.json"
N = 12
WIDTH = (64, 4)  # config 5's net
TRUNC = 2.0 / 0.87962566103423978  # flax's truncation, in LeCun deviations


# --- 1. the initial net -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def flax_init() -> dict:
    net = jnet.create_net(N, *WIDTH)
    obs = jnp.zeros((1, 12, N, N - 2), jnp.float32)
    return convert.params_from_flax(jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), obs)))


@functools.lru_cache(maxsize=None)
def port_init() -> dict:
    return tnet.init_params(tnet.AZNet(N, *WIDTH), 0).state_dict()


KERNELS = [k for k, v in tnet.AZNet(N, *WIDTH).state_dict().items()
           if v.ndim > 1 and k != "value_out.weight"]


@pytest.mark.parametrize("leaf", KERNELS)
def test_init_kernel_matches_flax_draw(leaf):
    got, want = port_init()[leaf].double(), flax_init()[leaf].double()
    assert got.shape == want.shape
    count = got.numel()
    s = math.sqrt(1.0 / got[0].numel())  # fan_in: in * kh * kw, or in
    assert abs(float(got.mean() - want.mean())) <= 5 * s * math.sqrt(2.0 / count)
    assert abs(float(got.std() - want.std())) <= 5 * s / math.sqrt(count)
    for x in (got, want):
        top = float(x.abs().max())
        assert 0.9 * TRUNC * s < top <= TRUNC * s * (1 + 1e-6), (top, TRUNC * s)


def test_init_constant_leaves_match_flax():
    got, want = port_init(), flax_init()
    assert set(got) == set(want)
    for leaf in set(got) - set(KERNELS):
        assert torch.equal(got[leaf], want[leaf]), leaf
    assert bool((got["value_out.weight"] == 0).all())
    assert all(bool((got[k] == 1).all()) for k in got if "norm" in k and k.endswith("weight"))


# --- 2. the root prior with Dirichlet noise --------------------------------------

ROOTS, DRAWS, ALPHA, FRAC = 4, 2048, 0.3, 0.25


@functools.lru_cache(maxsize=None)
def noise_case():
    """Four board-12 roots (a seeded random rollout), their legal masks,
    seeded logits, and the roots repeated ``DRAWS`` times each."""
    roots = tbit.bit_random_rollout(3, N, 6, tbit.bit_reset(N, ROOTS, "cpu"))[0]
    legal = tbit.bit_legal_mask_flat(roots, roots.current_player.clamp(0, 1), N).T
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((ROOTS, N * N)).astype(np.float32))
    batch = tbit.bitstate_from_leaves(x.repeat_interleave(DRAWS, -1)
                                      for x in tbit.bitstate_leaves(roots))
    return batch, legal, logits


@functools.lru_cache(maxsize=None)
def port_noised_priors() -> np.ndarray:
    """The prior ``search_batch`` hands its tree, [ROOTS, DRAWS, A]."""
    batch, _, logits = noise_case()
    seen = {}
    real = tmcts._init_tree

    def grab(bs, b, nodes, a_dim, root_value, prior, *args, **kw):
        seen["prior"] = prior.clone()
        return real(bs, b, nodes, a_dim, root_value, prior, *args, **kw)

    rep = logits.repeat_interleave(DRAWS, 0)
    tmcts._init_tree = grab
    try:
        tmcts.search_batch(None, batch, torch.Generator().manual_seed(0),
                           evaluator=lambda p, bs, g: (rep, torch.zeros(rep.shape[0])),
                           board_size=N, num_simulations=1, dirichlet_alpha=ALPHA,
                           dirichlet_frac=FRAC)
    finally:
        tmcts._init_tree = real
    # illegal actions reach the tree as -1
    return seen["prior"].clamp_min(0).double().numpy().reshape(ROOTS, DRAWS, N * N)


@functools.lru_cache(maxsize=None)
def jax_noised_priors() -> np.ndarray:
    """JAX's ``search_batch`` root prior (``models/mcts.py``:641-650)."""
    _, legal, logits = noise_case()
    legal = jnp.asarray(legal.numpy()).repeat(DRAWS, 0)
    logits = jnp.asarray(logits.numpy()).repeat(DRAWS, 0)
    noise = jax.random.dirichlet(jax.random.PRNGKey(5), jnp.full((N * N,), ALPHA),
                                 shape=(ROOTS * DRAWS,))
    prior = jax.nn.softmax(jnp.where(legal, logits, -1e9), axis=-1)
    prior = jnp.where(legal, (1 - FRAC) * prior + FRAC * noise, 0.0)
    prior = prior / jnp.maximum(prior.sum(-1, keepdims=True), 1e-9)
    return np.asarray(prior, np.float64).reshape(ROOTS, DRAWS, N * N)


def entropy(p: np.ndarray) -> np.ndarray:
    return -(p * np.log(np.maximum(p, 1e-30))).sum(-1)


def test_noised_prior_support_and_mass():
    _, legal, _ = noise_case()
    got = port_noised_priors()
    mask = legal.numpy()[:, None, :]
    assert np.all(got[~np.broadcast_to(mask, got.shape)] == 0)
    assert np.all(got[np.broadcast_to(mask, got.shape)] > 0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert len({tuple(x) for x in got[0, :8].round(6)}) == 8  # every draw its own noise


def test_noised_prior_matches_jax_by_distribution():
    _, legal, _ = noise_case()
    got, want = port_noised_priors(), jax_noised_priors()
    for r in range(ROOTS):
        m = legal[r].numpy()
        g, w = got[r][:, m], want[r][:, m]
        se = np.sqrt((g.var(0) + w.var(0)) / DRAWS)
        assert np.all(np.abs(g.mean(0) - w.mean(0)) <= 5.5 * se), r
        assert abs(g.var(0).mean() / w.var(0).mean() - 1) < 0.15, r
        eg, ew = entropy(got[r]), entropy(want[r])
        assert abs(eg.mean() - ew.mean()) <= 5 * np.sqrt((eg.var() + ew.var()) / DRAWS), r


# --- 3. the temperature draw --------------------------------------------------------

SAMPLES = 60_000


@functools.lru_cache(maxsize=None)
def visit_logits():
    """A 64-simulation visit distribution on a seeded board-12 root, as the
    draw sees it: log(max(p, 1e-9)) on the legal set, -inf elsewhere."""
    roots = tbit.bit_random_rollout(9, N, 10, tbit.bit_reset(N, 1, "cpu"))[0]
    legal = tbit.bit_legal_mask_flat(roots, roots.current_player.clamp(0, 1), N).T[0]
    rng = np.random.default_rng(4)
    visits = np.zeros(N * N)
    visited = rng.choice(np.flatnonzero(legal.numpy()), 24, replace=False)
    visits[visited] = rng.multinomial(64 - 24, np.full(24, 1 / 24)) + 1
    probs = torch.from_numpy(visits / visits.sum()).float()
    logits = torch.where(legal, torch.log(probs.clamp_min(1e-9)), -torch.inf)
    return logits, legal


def chi_square(draws: np.ndarray, probs: np.ndarray, support: np.ndarray):
    """Pearson's statistic of the draws on ``support`` against ``probs``,
    the rest of the mass pooled into one cell; returns (stat, df)."""
    count = np.bincount(draws, minlength=probs.size).astype(np.float64)
    expected = probs * draws.size
    obs = np.append(count[support], count[~support].sum())
    exp = np.append(expected[support], expected[~support].sum())
    keep = exp > 0
    return float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()), int(keep.sum()) - 1


def bound(df: int) -> float:
    return df + 5 * math.sqrt(2 * df)


@functools.lru_cache(maxsize=None)
def temperature_draws():
    logits, _ = visit_logits()
    port = tarena._categorical(torch.Generator().manual_seed(2),
                               logits.expand(SAMPLES, -1)).numpy()
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(2), jnp.asarray(logits.numpy()),
                                             shape=(SAMPLES,)))
    return port, want


def test_temperature_draw_matches_jax():
    logits, legal = visit_logits()
    probs = torch.softmax(logits.double(), -1).numpy()
    support = probs > 1e-6
    port, want = temperature_draws()
    for draws in (port, want):
        assert legal.numpy()[draws].all()
        stat, df = chi_square(draws, probs, support)
        assert stat <= bound(df), (stat, df)
    # the two samples against each other, cell by cell on the support
    a = np.bincount(port, minlength=probs.size)[support].astype(np.float64)
    b = np.bincount(want, minlength=probs.size)[support].astype(np.float64)
    stat = float(((a - b) ** 2 / np.maximum(a + b, 1)).sum())
    assert stat <= bound(int(support.sum()) - 1), stat


def test_arena_play_draws_through_categorical():
    logits, legal = visit_logits()
    probs = torch.softmax(logits, -1).expand(SAMPLES, -1)
    drawn = tarena._play(torch.Generator().manual_seed(2), probs,
                         legal.expand(SAMPLES, -1), True).numpy()
    np.testing.assert_array_equal(drawn, temperature_draws()[0])
    greedy = tarena._play(None, probs[:1], legal[None], False)
    assert int(greedy) == int(torch.where(legal, probs[0], -1.0).argmax())


def test_zero_exponential_draws_no_illegal_action(monkeypatch):
    """An exponential draw of exactly 0 at an action at -inf made it NaN,
    which ``argmax`` takes: the draw then played an illegal move."""
    logits, legal = visit_logits()
    monkeypatch.setattr(torch.Tensor, "exponential_", lambda self, *a, **kw: self.zero_())
    drawn = tarena._categorical(torch.Generator(), logits.expand(3, -1))
    assert bool(legal[drawn].all()), drawn


# --- 4. board-12 chunks, deterministic ----------------------------------------------

def jax_chunks_record() -> dict:
    c = cases.CHUNK12
    net = jnet.create_net(N, c["channels"], c["blocks"], dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_to_flax(cases.chunk12_state()))
    bs, _ = jbit.bit_random_rollout(c["rollout_seed"], N, c["rollout_steps"],
                                    jbit.bit_reset(N, c["batch"]))
    rec = {**c, "temp_moves": 0, "dirichlet_frac": 0.0, "chunks": []}
    for k in range(c["chunks"]):
        bs, sample, aux = jsp.selfplay_chunk(
            params, bs, jax.random.PRNGKey(k), net_apply=net.apply, board_size=N,
            num_steps=c["num_steps"], num_simulations=c["num_simulations"], temp_moves=0,
            dirichlet_frac=0.0, debug_trace=True)
        aux = {key: torch.from_numpy(np.array(v)) for key, v in aux.items()}
        rec["chunks"].append(cases.sample_record(port_state(bs), port_sample(sample), aux))
    return rec


@functools.lru_cache(maxsize=None)
def stored_chunks() -> dict:
    return json.loads(CHUNK_FIXTURE.read_text())


def test_board12_chunk_fixture_covers_the_boundary():
    rec = stored_chunks()
    assert {k: v for k, v in rec.items() if k != "chunks"} == {
        **{k: v for k, v in cases.CHUNK12.items() if k != "chunks"},
        "temp_moves": 0, "dirichlet_frac": 0.0}
    assert len(rec["chunks"]) == cases.CHUNK12["chunks"]
    first, second = (np.array(ch["weight"]) for ch in rec["chunks"])
    # games finish in both chunks, and the second holds unfinished frames
    # of games that began in the first
    assert first.sum() > 0 and 0 < second.sum() < second.size


@functools.lru_cache(maxsize=None)
def port_chunks() -> list:
    return [cases.sample_record(*out) for out in cases.board12_chunks("cpu")]


@pytest.mark.parametrize("k", range(cases.CHUNK12["chunks"]))
def test_board12_chunk_matches_jax(k):
    got, want = port_chunks()[k], stored_chunks()["chunks"][k]
    for key in ("obs_sha256", "obs_shape", "policy", "value", "weight", "final_digest"):
        assert got[key] == want[key], key
    assert got["aux"]["player"] == want["aux"]["player"]


# --- 5. the bf16 learner step ---------------------------------------------------------

def jax_step(dtype) -> dict:
    """JAX's metrics, gradients and first AdamW update in ``dtype``
    compute, by leaf in the port's layout."""
    c = cases.BF16_STEP
    net = jnet.create_net(N, c["channels"], c["blocks"], dtype=dtype)
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_to_flax(cases.bf16_step_state()))
    s = cases.bf16_step_sample("cpu")
    sample = jsp.Sample(jnp.asarray(s.obs.numpy().view(np.uint32)),
                        *(jnp.asarray(x.numpy()) for x in s[1:]))
    grads, metrics = jax.jit(lambda p, x: jax.grad(jsp.loss_fn, has_aux=True)(
        p, net.apply, x))(params, sample)
    opt = jsp.make_optimizer(c["lr"])
    updates, _ = opt.update(grads, opt.init(params), params)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": convert.params_from_flax(jax.device_get(grads)),
            # parameters after less before, as the port's update is read
            "update": convert.params_from_flax(jax.device_get(
                jax.tree_util.tree_map(lambda p, u: (p + u) - p, params, updates)))}


def jax_bf16_record() -> dict:
    """JAX's bf16 and float32 steps: the metrics, each leaf's
    :func:`cases.projections`, and JAX's own bf16 error to float32 from the
    whole tensors."""
    k = cases.BF16_STEP["projections"]
    run = {"bf16": jax_step(jnp.bfloat16), "f32": jax_step(jnp.float32)}
    rec = {**cases.BF16_STEP, "tolerance": cases.BF16_TOLERANCE}
    for dtype, step in run.items():
        rec[dtype] = {"metrics": step["metrics"],
                      "grads": cases.projections(step["grads"], k),
                      "update": cases.projections(step["update"], k)}
    rec["jax_bf16_err"] = {part: cases.rel_errors(run["bf16"][part], run["f32"][part])
                           for part in ("grads", "update")}
    return rec


@functools.lru_cache(maxsize=None)
def stored_bf16() -> dict:
    return json.loads(BF16_FIXTURE.read_text())


@functools.lru_cache(maxsize=None)
def port_steps() -> dict:
    return {"bf16": cases.bf16_port_step("cpu", torch.bfloat16),
            "f32": cases.bf16_port_step("cpu", torch.float32)}


def test_bf16_fixture_records_jax_error():
    rec = stored_bf16()
    assert {k: v for k, v in rec.items() if k not in ("bf16", "f32", "jax_bf16_err")} == {
        **cases.BF16_STEP, "tolerance": cases.BF16_TOLERANCE}
    # bf16 is coarse: JAX's own error to float32 is far from trivial
    assert rec["jax_bf16_err"]["grads"]["all"] > 1e-2
    assert rec["jax_bf16_err"]["update"]["all"] > 1e-2


def test_bf16_step_metrics_match_jax():
    for dtype in ("bf16", "f32"):
        assert cases.metric_failures(port_steps()[dtype]["metrics"],
                                     stored_bf16()[dtype]["metrics"]) == [], dtype


def test_f32_step_gradients_match_jax():
    err = cases.rel_errors(port_steps()["f32"]["grads"], stored_bf16()["f32"]["grads"])
    assert max(err.values()) <= 2e-3, max(err.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("part", ["grads", "update"])
def test_bf16_step_error_within_jax(part):
    """The check ``chip_smoke.py`` runs on the card."""
    assert cases.bf16_failures(port_steps()["bf16"], stored_bf16(), part) == []


if __name__ == "__main__":
    CHUNK_FIXTURE.write_text(json.dumps(jax_chunks_record()) + "\n")
    BF16_FIXTURE.write_text(json.dumps(jax_bf16_record(), indent=1) + "\n")
    print(CHUNK_FIXTURE.stat().st_size, BF16_FIXTURE.stat().st_size)
