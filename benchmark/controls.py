"""The readings that each check's limit is set from, beside the control and
the faults; run by hand on a card, never by a benchmark run.

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 [--seconds 1]

One JSON line a seed.  ``wire``: the reference rollout against the control
that breaks the auto-reset guarantee, from the input states of the last
``checked_launches`` of a chain of ``CHAIN`` launches of the program.
``selfplay``: a short window of the cell (one chunk), then the compared
numbers and the control's search ratio (the reference's search with its
net in fp8).  ``train``: the reference's three steps against the control
(the reference in fp8), and the faults planted in the reference put in the
program's place (half of the batch left out, the mean over the rest), and
the leaves the change's rule leaves out.  A state left
unchanged reads 1 by the change's measure and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CHAIN = 64  # launches of 16 steps: games end and restart in the last ones


def wire_readings(cell, seed: int, device) -> dict:
    from benchmark.harness import inputs
    from benchmark.harness.wire import _diff, mismatches
    from benchmark.reference import engine
    from twixt_for_open_spiel_tpu_torch.ops.bitboard import bit_reset, bitstate_leaves
    from twixt_for_open_spiel_tpu_torch.ops.fused_bit_rollout import fused_bit_rollout

    n, t = cell.config["board_size"], cell.traffic
    state = bit_reset(n, t["batch"], device)
    kept = []
    for i in range(CHAIN):
        out = fused_bit_rollout(inputs.launch_seed(seed, i), n, t["steps"], state, emit_obs=True)
        if i >= CHAIN - t["checked_launches"]:
            kept.append((i, state, out))
        state = out[0]
    program = control = 0
    for i, given, out in kept:
        ref_in = engine.bitstate_from_leaves(bitstate_leaves(given))
        want = engine.rollout(inputs.launch_seed(seed, i), n, t["steps"], ref_in)
        low = engine.rollout(inputs.launch_seed(seed, i), n, t["steps"], ref_in, auto_reset=False)
        program += mismatches(out, want)
        control += _diff(low[3], want[3]) + sum(
            _diff(a, b) for a, b in zip(engine.bitstate_leaves(low[0]),
                                        engine.bitstate_leaves(want[0])))
    return {"wire_mismatch": program, "control_wire_mismatch": control}


def selfplay_readings(cell, seed: int, seconds: float, device) -> dict:
    from benchmark.harness import selfplay

    out = selfplay.play(cell, seed=seed, seconds=seconds, trace=False,
                        start=time.perf_counter(), device=device)
    return selfplay.readings(cell, seed, out["weights"], out["played"], device, control=True)


def train_readings(cell, seed: int, device) -> dict:
    from benchmark.harness import inputs, train

    weights = inputs.weights(cell.config, seed, device)
    want = train.reference_steps(cell, seed, weights, device)
    unit = train.first_gradient(cell, seed, weights, device, "bfloat16")
    out = {"left_out": train.left_out(want["grad"])}
    # the program through the cell's own flow, a short window
    got = train.run(cell, seed=seed, seconds=0.5, trace=False, start=time.perf_counter(),
                    device=device)
    out["program"] = {k: v["value"] for k, v in got["checks"].items()}
    low = train.reference_steps(cell, seed, weights, device, precision="fp8")
    out["control"] = train.gaps(low, want, unit)
    out["control_worst"] = train.gaps(low, want, unit, steady=False)

    def half(batch):
        keep = batch["obs"].shape[0] // 2
        return {k: v[:keep] for k, v in batch.items()}

    out["half_batch"] = train.gaps(
        train.reference_steps(cell, seed, weights, device, keep=half), want, unit)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmark.harness import inputs, spec

    cell = spec.load_cell(args.workload)
    device = inputs.device_of(args.device)
    kind = cell.traffic["kind"]
    for seed in (int(s) for s in args.seeds.split(",")):
        if kind == "wire":
            got = wire_readings(cell, seed, device)
        elif kind == "selfplay":
            got = selfplay_readings(cell, seed, args.seconds, device)
        else:
            got = train_readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
