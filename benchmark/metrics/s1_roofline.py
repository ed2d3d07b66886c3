"""S1's share of its roofline: the bytes of the traced chunk's expansions
(S1a, once a simulation, and once a ply for the env step) and selection
walks (S1b, once a simulation, counted at the root's level alone) from
their shapes (``harness/counts.py``) at the HBM peak, over the device time
of the two kernels."""

from benchmark.harness import counts


def read(facts, cell):
    seconds = facts.device_seconds(
        lambda name: "bit_step_kernel" in name or "select_walk_kernel" in name)
    if seconds <= 0:
        return None
    c = facts.counts
    n, b = cell.config["board_size"], c["batch"]
    sims = c["plies"] * c["simulations"]
    nbytes = (sims * (counts.expand_bytes(n, b) + counts.select_bytes(n, b))
              + c["plies"] * counts.env_step_bytes(n, b))
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES / seconds
