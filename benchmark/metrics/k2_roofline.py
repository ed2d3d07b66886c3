"""K2's share of its roofline: the bytes the traced launches need (the
state read and written, every step's wire words and the counters written;
``harness/counts.py``) at the HBM peak, over the device time of K2's
kernel in the traced window."""

from benchmark.harness import counts


def read(facts, cell):
    seconds = facts.device_seconds(lambda name: "fused_bit_rollout_kernel" in name)
    if seconds <= 0:
        return None
    c = facts.counts
    nbytes = c["launches"] * counts.wire_launch_bytes(c["board_size"], c["batch"], c["steps"])
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES / seconds
