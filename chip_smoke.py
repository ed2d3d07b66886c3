"""Drive the PyTorch port's rollout on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernel from ``twixt_for_open_spiel_tpu_torch/csrc`` with
     nvcc for sm_90a, and print the build time and nvcc's register report;
  3. the kernel is bit-equal to its plain torch version, on the card, in
     every state leaf, ``episodes``, ``results`` and the ``obs`` stream;
  4. the JAX anchor: the kernel's final-state digests equal those of the JAX
     engine stored in ``tests/fixtures/torch_port_rollout_digests.json``;
  5. throughput of the kernel at the benchmark's rollout rows, timed with
     CUDA events after a warm-up, and of the plain version at the headline
     size;
  6. the main path (phases 4 and 5) went through the kernel: its launch
     count rose.

The second-to-last line is a JSON object describing the kernel; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.  It imports no jax.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_rollout_digests.json"
KERNEL_SOURCE = "twixt_for_open_spiel_tpu_torch/csrc/fused_bit_rollout.cu"
REPLACES = "twixt_for_open_spiel_tpu/ops/fused_bit_rollout.py:436"

# (board_size, batch, num_steps, seed, emit_obs): kernel vs plain version
EQUALITY_CASES = [
    (5, 256, 60, 3, False),
    (8, 4096, 256, 0, False),
    (12, 4096, 128, 7, False),
    (24, 4096, 64, 0, False),
    (8, 1000, 100, 13, False),  # ragged: no multiple of the block
    (24, 8192, 16, 5, True),
]
# the rollout rows of bench.py: (board_size, batch) at 1000 steps
RATE_ROWS = [(5, 256), (8, 4096), (12, 4096), (24, 4096)]
HEADLINE = (8, 4096)
RATE_STEPS = 1000
RATE_REPS = 5
OBS_ROW = (24, 8192, 16, 32)  # board, batch, steps per launch, launches


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_abs_diff(a_out, b_out) -> int:
    """Largest |a - b| over every state leaf, the stats and obs (as int64);
    raises on any shape mismatch."""
    pairs = list(zip(tbit.bitstate_leaves(a_out[0]), tbit.bitstate_leaves(b_out[0])))
    pairs += [(a_out[1][k], b_out[1][k]) for k in ("episodes", "results")]
    if len(a_out) == 3:
        pairs.append((a_out[2], b_out[2]))
    err = 0
    for a, b in pairs:
        require(a.shape == b.shape and a.dtype == b.dtype, "output shapes/dtypes")
        err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
    return err


def timed_ms(fn, reps: int) -> list:
    """Milliseconds of each of ``reps`` calls of ``fn``, by CUDA events."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    # phase 1: the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    _cuda.build("fused_bit_rollout")
    print(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.3f} s")
    for line in (_cuda.BUILD / "libfused_bit_rollout.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # phase 3: kernel == plain version, on the card
    max_err = 0
    for n, b, steps, seed, emit in EQUALITY_CASES:
        bs = tbit.bit_reset(n, b, dev)
        got = fbr.fused_bit_rollout(seed, n, steps, bs, emit_obs=emit)
        torch.cuda.synchronize()
        want = fbr.fused_bit_rollout_reference(seed, n, steps, bs, emit_obs=emit)
        err = max_abs_diff(got, want)
        max_err = max(max_err, err)
        episodes = int(got[1]["episodes"])
        print(f"[equal] n={n} batch={b} steps={steps} seed={seed} "
              f"emit_obs={emit}: max_abs_err={err} episodes={episodes}")
        require(err == 0, f"kernel != plain at n={n} batch={b}")
        require(int(got[1]["results"].sum()) == episodes, "results sum to episodes")

    # the main path from here on: count only its launches
    fbr.fused_bit_rollout.launches = 0

    # phase 4: the JAX anchor
    for case in json.loads(FIXTURE.read_text())["cases"]:
        n, b = case["board_size"], case["batch"]
        final, stats = fbr.fused_bit_rollout(
            case["seed"], n, case["num_steps"], tbit.bit_reset(n, b, dev)
        )
        digest = tbit.state_digest(final)
        print(f"[anchor] n={n} batch={b} steps={case['num_steps']} "
              f"digest={digest[:16]} episodes={int(stats['episodes'])}")
        require(digest == case["digest"], f"digest vs JAX at n={n}")
        require(int(stats["episodes"]) == case["episodes"], "episodes vs JAX")
        require(stats["results"].tolist() == case["results"], "results vs JAX")

    # phase 5: throughput, chained launches as a benchmark runs them
    rates = {}
    for n, b in RATE_ROWS:
        state = [tbit.bit_reset(n, b, dev)]

        def run(n=n, state=state):
            state[0] = fbr.fused_bit_rollout(0, n, RATE_STEPS, state[0])[0]

        fbr.fused_bit_rollout(0, n, 10, state[0])  # warm-up
        ms = timed_ms(run, RATE_REPS)
        med = statistics.median(ms)
        rates[(n, b)] = med
        blocks = -(-b // 256)
        print(f"[rate] kernel n={n} batch={b} steps={RATE_STEPS} blocks={blocks}: "
              f"median {med} ms of {ms} -> {b * RATE_STEPS / med * 1e3} env-steps/s")
    n, b, chunk, launches = OBS_ROW
    state = [tbit.bit_reset(n, b, dev)]

    def run_obs():
        for _ in range(launches):
            state[0], _, obs = fbr.fused_bit_rollout(0, n, chunk, state[0], emit_obs=True)
            require(obs.shape == (chunk, 12, n + 6, b), "obs shape")

    fbr.fused_bit_rollout(0, n, chunk, state[0], emit_obs=True)  # warm-up
    (obs_ms,) = timed_ms(run_obs, 1)
    print(f"[rate] kernel emit_obs n={n} batch={b} {launches}x{chunk} steps: "
          f"{obs_ms} ms -> {b * chunk * launches / obs_ms * 1e3} env-steps/s")

    main_launches = fbr.fused_bit_rollout.launches
    require(main_launches > 0, "the main path launched the kernel")

    # the plain version at the headline size, for comparison
    n, b = HEADLINE
    bs = tbit.bit_reset(n, b, dev)
    fbr.fused_bit_rollout_reference(0, n, 10, bs)  # warm-up
    (plain_ms,) = timed_ms(lambda: fbr.fused_bit_rollout_reference(0, n, RATE_STEPS, bs), 1)
    print(f"[rate] plain n={n} batch={b} steps={RATE_STEPS}: {plain_ms} ms -> "
          f"{b * RATE_STEPS / plain_ms * 1e3} env-steps/s")
    require(fbr.fused_bit_rollout.launches == main_launches, "plain run launched nothing")

    # phase 6: the report
    print(json.dumps({"kernels": [{
        "name": "fused_bit_rollout",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": rates[HEADLINE],
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
