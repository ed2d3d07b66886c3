"""S2's share of its roofline: the least time of the net's LayerNorms in
the traced steps, forward and backward, from their shapes
(``harness/counts.py``), over the device time of S2's kernels."""

from benchmark.harness import counts

KERNELS = ("layer_norm_forward_kernel", "layer_norm_backward_kernel",
           "layer_norm_param_grad_kernel")


def read(facts, cell):
    seconds = facts.device_seconds(lambda name: any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    c = facts.counts
    positions = c["frames"] * c["steps"]
    least = (counts.layer_norm_seconds(cell.config, positions, backward=False)
             + counts.layer_norm_seconds(cell.config, positions, backward=True))
    return 100.0 * least / seconds
