"""The yardstick's operation and byte counts against values worked by hand
at two shapes each."""

from __future__ import annotations

import pytest

from benchmark.harness import counts
from benchmark.reference import net

AZ12 = {"board_size": 12, "channels": 64, "blocks": 4}


@pytest.mark.parametrize("shape, flops", [
    # stem 2*120*64*12*9; 8 convs 2*120*64*64*9; two 1x1 heads 2*120*32*64;
    # policy dense 2*144*3840; value dense 2*256*3840; value out 2*256
    ((12, 64, 4), 1_658_880 + 8 * 8_847_360 + 2 * 491_520 + 1_105_920 + 1_966_080 + 512),
    # board 5: 15 cells; 2 convs 2*15*8*8*9; heads 2*15*32*8; dense 2*25*480, 2*256*480
    ((5, 8, 1), 25_920 + 2 * 17_280 + 2 * 7_680 + 24_000 + 245_760 + 512),
])
def test_forward_flops(shape, flops):
    assert net.forward_flops(*shape) == flops


@pytest.mark.parametrize("args, nbytes", [
    # board 24, B 8192, 16 steps: state 8192*(16*30*4 + 576*2 + 20) twice, the wire
    # 16*12*30*8192*4, the counters 5*8192*4: 0.0715 ms at 3.35 TB/s
    ((24, 8192, 16), 2 * 25_329_664 + 188_743_680 + 163_840),
    # board 8, B 4, 2 steps: state 4*(16*14*4 + 64*2 + 20)
    ((8, 4, 2), 2 * 4_176 + 5_376 + 80),
])
def test_wire_launch_bytes(args, nbytes):
    assert counts.wire_launch_bytes(*args) == nbytes


@pytest.mark.parametrize("args, expand, select, step", [
    # board 12, B 512: state 512*1460; the slot and action, the mask 512*144, flag and value
    ((12, 512), 2 * 747_520 + 8_192 + 73_728 + 2_560, 512 * (37 + 576), 2 * 747_520 + 4_096),
    ((5, 2), 2 * 2 * (16 * 11 * 4 + 50 + 20) + 32 + 50 + 10, 2 * (37 + 100),
     2 * 2 * (16 * 11 * 4 + 50 + 20) + 16),
])
def test_search_bytes(args, expand, select, step):
    assert counts.expand_bytes(*args) == expand
    assert counts.select_bytes(*args) == select
    assert counts.env_step_bytes(*args) == step


@pytest.mark.parametrize("config, positions, forward, backward", [
    # the config-5 train step (16,384 frames, 1,966,080 rows): 6,073,359,360 bytes
    # forward and 9,613,359,104 backward, the 1.8129 and 2.8697 ms of the port's
    # S2 bounds
    (AZ12, 16_384, 6_073_359_360, 9_613_359_104),
    # board 5, 8 channels, 1 block, one position (15 rows): operations bind the
    # tiny rows, bytes the rest
    ({"board_size": 5, "channels": 8, "blocks": 1}, 1, None, None),
])
def test_layer_norm_seconds(config, positions, forward, backward):
    fwd = counts.layer_norm_seconds(config, positions, backward=False)
    bwd = counts.layer_norm_seconds(config, positions, backward=True)
    if forward is not None:
        assert fwd == pytest.approx(forward / counts.PEAK_HBM_BYTES, rel=1e-12)
        assert bwd == pytest.approx(backward / counts.PEAK_HBM_BYTES, rel=1e-12)
    else:
        by_hand = 0.0
        for c, size, epi, rows in [(8, 2, "relu", 15), (8, 2, "relu", 15),
                                   (8, 2, "residual", 15), (32, 2, "relu", 15),
                                   (32, 2, "relu", 15), (256, 4, None, 1)]:
            e = rows * c * size
            res = e if epi == "residual" else 0
            by_hand += max((2 * e + res + 8 * c) / counts.PEAK_HBM_BYTES,
                           9 * rows * c / counts.PEAK_FP32_FLOPS)
        assert fwd == pytest.approx(by_hand, rel=1e-12)
        assert bwd > fwd
