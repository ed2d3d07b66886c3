"""The port's benchmark, ``twixt_for_open_spiel_tpu_torch.bench`` (the root
``bench.py``, ported), on the CPU with ``--quick``.

One run of the quick bench serves every test: each rollout row's final
state and episodes are bit-equal to JAX's ``bit_random_rollout`` at the
row's shape and the seed of its last launch; the config-4 rows' last
launch, after the state carried from the launch before, equals JAX's
``bit_rollout_emit_obs`` (packed: the port's ``[T,12,P,B]`` wire permuted
to JAX's ``[T,B,12P]``; bf16: its unpacked tensor); the JSON line has
``bench.py``'s keys and metric (read from its source with ``ast``: importing
it would set JAX's cache variables in this process) and ``vs_baseline`` is
``value`` over the C engine's rate on stderr; a row's rate is all its
launches' env-steps over their summed time.  Without a card and without
``--quick`` the program exits 1.
"""

import ast
import contextlib
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu_torch import bench
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def quick():
    """One ``--quick`` run of the program: what ``run`` returned, stdout
    and stderr."""
    out, err, results = io.StringIO(), io.StringIO(), []
    run = bench.run
    bench.run = lambda q: results.append(run(q)) or results[-1]
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert bench.main(["--quick"]) == 0
    finally:
        bench.run = run
    return results[0], out.getvalue(), err.getvalue()


def assert_same_state(jax_bs, port_bs):
    jl = [np.asarray(x).astype(np.int64) for x in jax.tree_util.tree_leaves(jax_bs)]
    tl = [x.numpy().astype(np.int64) for x in tbit.bitstate_leaves(port_bs)]
    assert len(jl) == len(tl) == 22
    for i, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")


@pytest.mark.parametrize("n,batch,reps", bench.QUICK["rollout"])
def test_quick_rollout_row_matches_jax(quick, n, batch, reps):
    row = quick[0]["rows"][(n, batch)]
    steps = bench.QUICK["steps"]
    assert len(row["ms"]) == reps
    # the last launch: seed ``reps`` from the initial state, as bench.py's
    want, stats = jbit.bit_random_rollout(reps, n, steps, jbit.bit_reset(n, batch))
    assert_same_state(want, row["final"])
    assert int(row["stats"]["episodes"]) == int(stats["episodes"])
    np.testing.assert_array_equal(row["stats"]["results"].numpy(), np.asarray(stats["results"]))
    assert (row["k1_launches"], row["k2_launches"]) == (0, 0)  # the CPU: plain


def jax_obs_row(n, batch, chunk, launches, packed):
    """JAX's config-4 row: ``launches`` chained launches with seeds 1..;
    the last launch's state and obs."""
    state = jbit.bit_reset(n, batch)
    for seed in range(1, launches + 1):
        state, stats, obs = jbit.bit_rollout_emit_obs(seed, n, chunk, state, packed=packed)
    return state, np.asarray(obs)


@pytest.mark.parametrize("packed", [True, False])
def test_quick_obs_rows_match_jax(quick, packed):
    (n, batch, chunk, launches, _), = [r for r in bench.QUICK["obs"] if r[4] == packed]
    assert (n, batch, chunk, launches) == (24, 64, 4, 2)
    row = quick[0]["rows"]["packed" if packed else "bf16"]
    want_state, want_obs = jax_obs_row(n, batch, chunk, launches, packed)
    assert_same_state(want_state, row["final"])
    if packed:
        p = n + 6
        assert row["obs"].shape == (chunk, 12, p, batch) and row["obs"].dtype == torch.int32
        got = row["obs"].permute(0, 3, 1, 2).reshape(chunk, batch, 12 * p)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want_obs)
    else:
        assert row["obs"].dtype == torch.bfloat16
        assert tuple(row["obs"].shape) == want_obs.shape == (chunk, batch, 12, n, n - 2)
        np.testing.assert_array_equal(row["obs"].float().numpy(), want_obs.astype(np.float32))
    assert len(row["ms"]) == launches


def jax_bench_record():
    """The keys and the metric string of the JSON line of the root
    ``bench.py``, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            rec = dict(zip((k.value for k in node.keys), node.values))
            return set(rec), ast.literal_eval(rec["metric"])
    raise AssertionError("no JSON record in bench.py")


def test_json_line_matches_bench_py(quick):
    result, stdout, _ = quick
    (line,) = stdout.strip().splitlines()  # exactly one line on stdout
    rec = json.loads(line)
    keys, metric = jax_bench_record()
    assert set(rec) == keys == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == metric == bench.METRIC
    assert rec["unit"] == "env-steps/s"
    assert rec == result["record"]


def test_vs_baseline_is_value_over_the_c_rate(quick):
    result, stdout, stderr = quick
    (c_rate,) = [float(r) for r in re.findall(r"c_rate (\S+) env-steps/s", stderr)]
    assert c_rate == result["c_rate"] > 0
    rec = json.loads(stdout)
    # both rounded as bench.py rounds them: value to 1, vs_baseline to 1e-3
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / c_rate, abs=5e-4 + 0.5 / c_rate)
    headline = result["rows"][bench.HEADLINE]["rate"]
    assert (rec["value"], rec["vs_baseline"]) == (round(headline), round(headline / c_rate, 3))


def test_rows_print_spread_episodes_and_launches(quick):
    _, _, stderr = quick
    rows = [line for line in stderr.splitlines() if "obs=" in line]
    assert len(rows) == len(bench.QUICK["rollout"]) + len(bench.QUICK["obs"])
    for line in rows:
        assert "min-max" in line and "K1 launches 0, K2 launches 0" in line
        assert "episodes" in line and "path=plain" in line
    assert stderr.count("[bench] kernel launches: K1 0, K2 0") == 1
    assert stderr.count(f"[bench] plain n=8 batch=4096 steps={bench.PLAIN_STEPS}") == 1


def test_no_card_without_quick_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_row_rate_is_all_launches_over_their_summed_time(quick):
    rows = quick[0]["rows"]
    steps = bench.QUICK["steps"]
    for n, batch, reps in bench.QUICK["rollout"]:
        ms = rows[(n, batch)]["ms"]
        assert rows[(n, batch)]["rate"] == pytest.approx(batch * steps * reps / sum(ms) * 1e3)
    for n, batch, chunk, launches, packed in bench.QUICK["obs"]:
        row = rows["packed" if packed else "bf16"]
        assert row["rate"] == pytest.approx(batch * chunk * launches / sum(row["ms"]) * 1e3)
