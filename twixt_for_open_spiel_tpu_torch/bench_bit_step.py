"""Time S1a (``csrc/bit_step.cu``) on the card in its two forms, beside the
S1a of other checkouts of the repository, in turns.

    python3 -m twixt_for_open_spiel_tpu_torch.bench_bit_step [--other=DIR ...]
        [--reps=50] [--runs=5]
    python3 -m twixt_for_open_spiel_tpu_torch.bench_bit_step --quick   # tiny, the CPU

The forms, as ``chip_smoke.py`` phase 13 times them:

  search    the expansion of simulation 32 of a config-5 search (board 12,
            batch 512, 64 simulations, the 128x6 bf16 net of seed 0, the
            ancestor-mask backup, roots 24 random plies in): per-env source
            slots, in place, with the legal mask and, where the build takes
            them, the terminal flags and values;
  one slot  ``step_state``'s form at ``bit_replay``'s shape (board 24, batch
            4096): one source slot into fresh buffers, no mask.

The builds: this package (``this``) and each ``--other=DIR``, a directory
that holds another ``twixt_for_open_spiel_tpu_torch/`` (a ``git archive``
of an earlier commit, or a copy with a change to try), named by DIR's last
part.  Each is timed in a process of its own that imports its own package
and builds its own kernels, in turns (first to last, then back), through
the API they share: ``ops/bit_step.py``'s ``bit_step``,
``bit_step_reference`` and ``one_slot``.  A worker runs each form once on
copies of the inputs and holds it to the plain version, bit for bit (or
exits 1), then times it with ``utils/timing.py``: device ms a launch
(``reps`` launches enqueued behind a spin kernel) and ms a launch back to
back through the build's wrapper (the median of ``runs`` runs of ``reps``).
``chip_smoke.py``'s ``[S1 floor]`` lines time the empty kernel of each
launch shape.  Prints the card's name and power limit and one ``[S1a
bench]`` line a build, form and turn.  ``--quick`` runs the checks of this
build alone, at board 5, on the CPU (plain versions only, no time).  Exits
1 without a CUDA device unless ``--quick``.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# run as a worker, this file imports the package of the build it times
from twixt_for_open_spiel_tpu_torch.models import mcts
from twixt_for_open_spiel_tpu_torch.models.network import call_net, create_net
from twixt_for_open_spiel_tpu_torch.ops import bit_step as tstep
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit

PKG = Path(__file__).resolve().parent
SIMULATION = 32  # the expansion timed, as chip_smoke.py's S1_TIMED_CALL
# (board, batch, simulations, roots' plies) of the search form, and
# (board, batch) of the one-slot form
SEARCH, ONE_SLOT = (12, 512, 64, 24), (24, 4096)
QUICK_SEARCH, QUICK_ONE_SLOT = (5, 13, 4, 4), (5, 13)
QUICK_SIMULATION = 2


def search_inputs(dev, board: int, batch: int, sims: int, plies: int, simulation: int) -> dict:
    """The inputs of the ``simulation``-th expansion of a search_batch (copies)."""
    # the full-width net on the card, a small one for the CPU's check
    width = {} if dev.type == "cuda" else {"channels": 8, "blocks": 1}
    net = create_net(board, device=dev, **width)
    roots = tbit.bit_random_rollout(3, board, plies, tbit.bit_reset(board, batch, dev))[0]
    real, seen, out = mcts.bit_step, [0], {}

    def record(src, src_slot, action, dst, dst_slot, board_size, **kw):
        if seen[0] == simulation:
            out.update(bufs=tuple(x.clone() for x in src), slot=src_slot.clone(),
                       action=action.clone(), dst_slot=dst_slot,
                       outcome=tuple(x.clone() for x in kw["outcome"]) if "outcome" in kw
                       else None)
        seen[0] += 1
        return real(src, src_slot, action, dst, dst_slot, board_size, **kw)

    mcts.bit_step = record
    try:
        mcts.search_batch(net, roots, torch.Generator(device=dev).manual_seed(0),
                          evaluator=mcts.net_evaluator(call_net, board), board_size=board,
                          num_simulations=sims, dirichlet_frac=0.25, backup="amask")
    finally:
        mcts.bit_step = real
    return out


def one_slot_inputs(dev, board: int, batch: int) -> dict:
    """One source slot of roots 60 random plies in (as chip_smoke.py's
    ``s1_roots`` at board 24), and a legal action an env."""
    roots = tbit.bit_random_rollout(3, board, 60, tbit.bit_reset(board, batch, dev))[0]
    noise = tbit.rollout_noise(board, 0, torch.arange(batch, device=dev))
    return {"bufs": tstep.one_slot(roots), "action": tbit.sample_bits(roots, board, noise)}


def timing():
    """This checkout's ``utils/timing.py``, loaded by its path: a worker
    imports another checkout's package, which may not have it."""
    spec = importlib.util.spec_from_file_location("bench_bit_step_timing",
                                                  PKG / "utils" / "timing.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def same(pairs) -> bool:
    """Every pair equal, floats by bit pattern."""
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype.is_floating_point
               else torch.equal(a, b) for a, b in pairs)


def forms(inputs: dict, dev) -> dict:
    """Each form's (kernel call, plain call, outputs to compare) on ``dev``,
    through the imported build's wrapper: the kernel's calls write their
    own copies, the plain version's others."""
    takes_outcome = "outcome" in inspect.signature(tstep.bit_step).parameters
    s, o = inputs["search"], inputs["one slot"]
    n_s, n_o = s["board"], o["board"]
    bufs = [tuple(x.to(dev) for x in s["bufs"]) for _ in range(2)]
    bufs[1] = tuple(x.clone() for x in bufs[1])
    slot, action = s["slot"].to(dev), s["action"].to(dev)
    outs = [tuple(x.to(dev).clone() for x in s["outcome"]) for _ in range(2)] if takes_outcome \
        else [None, None]
    kw = [{"outcome": out} if takes_outcome else {} for out in outs]
    got, want = {}, {}

    def search(i, fn):
        def call():
            out = fn(bufs[i], slot, action, bufs[i], s["dst_slot"], n_s, **kw[i])
            (got if i == 0 else want)["search"] = out
        return call

    src = tuple(x.to(dev) for x in o["bufs"])
    o_action = o["action"].to(dev)
    fresh = [tuple(torch.empty_like(x) for x in src) for _ in range(2)]

    def one(i, fn):
        return lambda: fn(src, None, o_action, fresh[i], 0, n_o, legal=False)

    def compare(name):
        if name == "search":
            pairs = list(zip(bufs[0], bufs[1])) + [(got["search"], want["search"].contiguous())]
            if takes_outcome:
                pairs += list(zip(outs[0], outs[1]))
            return pairs
        return list(zip(fresh[0], fresh[1]))

    return {"search": (search(0, tstep.bit_step), search(1, tstep.bit_step_reference),
                       lambda: compare("search")),
            "one slot": (one(0, tstep.bit_step), one(1, tstep.bit_step_reference),
                         lambda: compare("one slot"))}


def worker(inputs_path: str, build: str, reps: int, runs: int) -> int:
    """Time the imported build's S1a on the saved inputs; print one JSON line."""
    dev = torch.device("cuda", 0)
    inputs = torch.load(inputs_path)
    timer = timing()
    out = {"build": build, "forms": {}}
    for name, (kernel, plain, pairs) in forms(inputs, dev).items():
        kernel()
        plain()
        torch.cuda.synchronize()
        if not same(pairs()):
            print(f"[S1a bench] {build} {name}: the kernel differs from its plain version",
                  file=sys.stderr)
            return 1
        out["forms"][name] = {
            "device_ms": timer.device_ms(kernel, reps),
            "ms": statistics.median(timer.back_to_back_ms(kernel, reps, runs))}
    print(json.dumps(out))
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", action="append", default=[], metavar="DIR",
                    help="another checkout of the repository to time beside this one "
                         "(repeatable)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--quick", action="store_true", help="the checks at board 5 on the CPU")
    ap.add_argument("--worker", nargs=2, metavar=("INPUTS", "BUILD"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.quick and not torch.cuda.is_available():
        ap.exit(1, f"{ap.prog}: no CUDA device; pass --quick to run on the CPU\n")
    for other in args.other:
        if not (Path(other) / PKG.name / "csrc" / "bit_step.cu").exists():
            ap.error(f"--other={other}: no {PKG.name}/csrc/bit_step.cu there")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        return worker(*args.worker, args.reps, args.runs)
    dev = torch.device("cpu") if args.quick else torch.device("cuda", 0)
    (board, batch, sims, plies), (o_board, o_batch) = (
        (QUICK_SEARCH, QUICK_ONE_SLOT) if args.quick else (SEARCH, ONE_SLOT))
    simulation = QUICK_SIMULATION if args.quick else SIMULATION
    inputs = {"search": {**search_inputs(dev, board, batch, sims, plies, simulation),
                         "board": board},
              "one slot": {**one_slot_inputs(dev, o_board, o_batch), "board": o_board}}
    if args.quick:
        for name, (kernel, plain, pairs) in forms(inputs, dev).items():
            kernel()
            plain()
            print(f"[S1a bench] this {name} on the CPU: the wrapper equals the plain version "
                  f"{same(pairs())}; device ms not measured")
        return 0

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[S1a bench] {card.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_dir = PKG / "_build"
    build_dir.mkdir(exist_ok=True)
    path = build_dir / "bench_bit_step_inputs.pt"
    torch.save({k: {f: (tuple(x.cpu() for x in v) if isinstance(v, tuple) else
                        v.cpu() if isinstance(v, torch.Tensor) else v) for f, v in form.items()}
                for k, form in inputs.items()}, path)
    builds = [(Path(d).resolve().name, Path(d).resolve()) for d in args.other]
    builds.append(("this", PKG.parent))
    rc = 0
    for turn, (build, root) in enumerate(builds + builds[::-1]):
        proc = subprocess.run(
            [sys.executable, "-P", __file__, "--worker", str(path), build,
             f"--reps={args.reps}", f"--runs={args.runs}"],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(f"[S1a bench] {build}: worker failed (exit {proc.returncode})\n"
                  f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
            rc = 1
            continue
        for name, f in json.loads(lines[-1])["forms"].items():
            print(f"[S1a bench] turn {turn} {build} {name}: device {f['device_ms']} ms a launch, "
                  f"{f['ms']} ms back to back through its wrapper; bit-equal to plain "
                  f"[{card.strip()}]")
    return rc


if __name__ == "__main__":
    sys.exit(main())
