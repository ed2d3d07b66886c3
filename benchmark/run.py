"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is ``benchmark/workloads/<cell>.json``
(its configuration, traffic mix, chips and check limits); the traffic's
``kind`` picks the runner under ``benchmark/harness/``.  With ``--trace 0``
the line's metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiled part of the window by the readers
under ``benchmark/metrics/``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, and ``checks`` last.  Exits non-zero, with no
result, without enough CUDA devices, or when JAX or the JAX package was
loaded in this process by the time the window closed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# transformers and its kin load JAX when they find it; nothing here uses them
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import spec
    from benchmark.harness.result import emit, forbidden_modules

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = spec.runner(cell).run(cell, seed=args.seed, seconds=args.seconds,
                                   trace=bool(args.trace), start=START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package is loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
