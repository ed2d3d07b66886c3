"""The self-play step's share of the card's bfloat16 peak: the net's
forward FLOPs of the traced chunk (one root and one leaf evaluation a
simulation, every env, every ply; ``harness/counts.py``) over the traced
window's time."""

from benchmark.harness import counts


def read(facts, cell):
    c = facts.counts
    if facts.window_s <= 0 or not facts.activities:
        return None
    flops = counts.forward_flops(cell.config) * c["batch"] * c["plies"] * (c["simulations"] + 1)
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / facts.window_s
