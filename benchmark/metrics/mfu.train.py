"""The train step's share of the card's bfloat16 peak: three times the
net's forward FLOPs (forward, and the backward's two products) of every
frame of the traced steps (``harness/counts.py``; nothing recomputed),
over the traced window's time."""

from benchmark.harness import counts


def read(facts, cell):
    c = facts.counts
    if facts.window_s <= 0 or not facts.activities:
        return None
    flops = 3 * counts.forward_flops(cell.config) * c["frames"] * c["steps"]
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / facts.window_s
