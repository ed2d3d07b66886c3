"""The result line, the check of what the process loaded, and the pieces
every runner shares: the device block and the per-layer readings."""

from __future__ import annotations

import json
import sys

import torch

from benchmark.harness import spec

# top-level module names that no run may load, compared whole: the port's
# name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "twixt_for_open_spiel_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_block(device, chips: int, peak_bytes: int, facts_list=None) -> dict:
    """``device``: the platform, the card's name, the cards used, the peak
    bytes on the fullest card; with traces (one a card) the busy seconds
    averaged over the cards and the traced window's length.  A run on the
    CPU (the tests') says so: ``platform`` "cpu"."""
    if torch.device(device).type == "cuda":
        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        platform, kind = "cpu", "cpu"
    out = {"platform": platform, "kind": kind, "count": chips,
           "memory_peak_bytes": int(peak_bytes)}
    if facts_list:
        out["busy_s"] = sum(f.busy_s for f in facts_list) / len(facts_list)
        out["window_s"] = sum(f.window_s for f in facts_list) / len(facts_list)
    return out


def per_layer_metrics(cell, facts) -> dict:
    """Each per-layer metric of the cell that its reader finds in
    ``facts``; a reader that finds nothing returns None and is left out."""
    out = {}
    for name, unit, reader in spec.per_layer(cell.name):
        value = reader.read(facts, cell)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def breakdown(facts) -> dict:
    return {"device_ops": facts.top_ops(10), "idle_gaps": facts.idle_gaps(10)}


def finish(cell, *, trace: bool, checks: dict, attempted: int, failed: int, rate: float,
           setup_s: float, device: dict, facts=None) -> dict:
    """The result: ``correct`` when every check is within its limit; the
    end-to-end metrics (the traffic's rate metric and ``setup_s``) or,
    traced, the per-layer metrics; ``checks`` last."""
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = per_layer_metrics(cell, facts)
    else:
        units = dict(spec.end_to_end(cell.name))
        rate_name = cell.traffic["metric"]
        metrics = {rate_name: {"value": rate, "unit": units[rate_name]},
                   "setup_s": {"value": setup_s, "unit": units["setup_s"]}}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if trace:
        out["breakdown"] = breakdown(facts)
    out["checks"] = checks
    return out


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
