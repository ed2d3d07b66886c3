"""The SASS reader of the port (``ops/_sass.py``) on small hand-written
listings in ``cuobjdump -sass`` form: blocks, edges, loops and the fewest
instructions per class on a path.  No GPU and no CUDA toolkit needed."""

import pytest

from twixt_for_open_spiel_tpu_torch.ops import _sass

HEAD = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _Z6kernelPi
	.headerflags	@"EF_CUDA_SM90"
"""


def listing(*lines: str) -> str:
    """A listing with each instruction followed by cuobjdump's encoding
    comments."""
    body = "".join(
        f"        {line}    /* 0x000000000000794d */\n"
        "                                    /* 0x000fea0003800000 */\n"
        for line in lines
    )
    return HEAD + body


# a guarded early exit, then a loop over 8 cells whose body hashes only the
# cells that are set
LOOP = listing(
    "/*0000*/                   S2R R0, SR_TID.X ;",
    "/*0010*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;",
    "/*0020*/               @P0 EXIT ;",
    "/*0030*/                   MOV R1, RZ ;",
    "/*0040*/                   LDG.E R2, desc[UR4][R4.64] ;",
    "/*0050*/                   ISETP.NE.AND P1, PT, R2, RZ, PT ;",
    "/*0060*/              @!P1 BRA 0xa0 ;",
    "/*0070*/                   IMAD R3, R2, -0x61c88647, RZ ;",
    "/*0080*/                   I2FP.F32.S32 R3, R3 ;",
    "/*0090*/                   FFMA R3, R3, 2, R1 ;",
    "/*00a0*/                   VIADD R1, R1, 0x1 ;",
    "/*00b0*/                   ISETP.LT.AND P2, PT, R1, 0x8, PT ;",
    "/*00c0*/               @P2 BRA 0x40 ;",
    "/*00d0*/                   STG.E desc[UR4][R6.64], R3 ;",
    "/*00e0*/                   EXIT ;",
    "/*00f0*/                   BRA 0xf0;",
)

# a diamond: one arm costs an integer op, the other a float op
DIAMOND = listing(
    "/*0000*/                   ISETP.NE.AND P0, PT, R0, RZ, PT ;",
    "/*0010*/               @P0 BRA 0x40 ;",
    "/*0020*/                   IADD3 R1, R1, 0x1, RZ ;",
    "/*0030*/                   BRA 0x50 ;",
    "/*0040*/                   FFMA R1, R1, 2, R1 ;",
    "/*0050*/                   EXIT ;",
)


# a per-lane loop over cells that hashes the set ones, then a butterfly of
# shuffles over the warp (two rounds shown) and a vote, inside a step loop
WARP_DRAW = listing(
    "/*0000*/                   MOV R9, RZ ;",
    "/*0010*/                   S2R R0, SR_LANEID ;",
    "/*0020*/                   MOV R1, R0 ;",
    "/*0030*/                   LDS.U8 R2, [R1] ;",
    "/*0040*/                   ISETP.NE.AND P1, PT, R2, RZ, PT ;",
    "/*0050*/              @!P1 BRA 0x80 ;",
    "/*0060*/                   IMAD R3, R1, 0x7feb352d, RZ ;",
    "/*0070*/                   FMNMX R4, R4, R3, !PT ;",
    "/*0080*/                   IADD3 R1, R1, 0x20, RZ ;",
    "/*0090*/                   ISETP.GE.AND P2, PT, R1, 0xc4, PT ;",
    "/*00a0*/              @!P2 BRA 0x30 ;",
    "/*00b0*/                   SHFL.BFLY PT, R5, R4, 0x10, 0x1f ;",
    "/*00c0*/                   FMNMX R4, R4, R5, !PT ;",
    "/*00d0*/                   SHFL.BFLY PT, R5, R4, 0x8, 0x1f ;",
    "/*00e0*/                   FMNMX R4, R4, R5, !PT ;",
    "/*00f0*/                   VOTE.ANY R6, PT, P1 ;",
    "/*0100*/                   IADD3 R9, R9, 0x1, RZ ;",
    "/*0110*/                   ISETP.LT.AND P3, PT, R9, 0x3e8, PT ;",
    "/*0120*/               @P3 BRA 0x20 ;",
    "/*0130*/                   EXIT ;",
)


def test_parse_reads_every_instruction():
    instrs = _sass.parse(LOOP)
    assert [i.addr for i in instrs] == list(range(0, 0x100, 0x10))
    assert instrs[2].opcode == "EXIT" and instrs[2].guarded
    assert instrs[7].opcode == "IMAD" and 0x9E3779B9 in instrs[7].immediates()
    assert instrs[12].target() == 0x40 and instrs[12].conditional()
    assert instrs[15].target() == 0xF0 and not instrs[15].conditional()


def test_blocks_and_edges():
    cfg = _sass.Cfg(_sass.parse(LOOP))
    starts = [cfg.instrs[s].addr for s, _ in cfg.blocks]
    assert starts == [0x00, 0x30, 0x40, 0x70, 0xA0, 0xD0, 0xF0]
    assert cfg.succ == [[1], [2], [3, 4], [4], [2, 5], [], [6]]


def test_loops_and_their_bodies():
    cfg = _sass.Cfg(_sass.parse(LOOP))
    loops = {(lp.header, lp.latch): lp.body for lp in cfg.loops()}
    assert loops == {(2, 4): frozenset({2, 3, 4}), (6, 6): frozenset({6})}
    assert (cfg.largest_loop().header, cfg.largest_loop().latch) == (2, 4)
    is_hash = lambda i: 0x9E3779B9 in i.immediates()  # noqa: E731
    loop = cfg.innermost_loop(is_hash)
    assert cfg.blocks_with(is_hash, loop.body) == [3]
    with pytest.raises(ValueError, match="no loop"):
        cfg.innermost_loop(lambda i: i.base == "STG")


def test_one_pass_with_and_without_the_guarded_arm():
    cfg = _sass.Cfg(_sass.parse(LOOP))
    loop = cfg.largest_loop()
    assert cfg.iteration(loop) == {"issue": 6, "int32": 3, "fp32": 0, "sfu": 0, "mem": 1}
    assert cfg.iteration(loop, via=3) == {"issue": 9, "int32": 4, "fp32": 2, "sfu": 0,
                                          "mem": 1}


def test_each_class_takes_its_own_shortest_path():
    cfg = _sass.Cfg(_sass.parse(DIAMOND))
    got = cfg.min_counts(0, 3, within=range(len(cfg.blocks)))
    # issue and int32 are least through the float arm, fp32 through the other
    assert got == {"issue": 4, "int32": 1, "fp32": 0, "sfu": 0, "mem": 0}


def test_a_loop_with_a_shuffle_reduction_after_it():
    cfg = _sass.Cfg(_sass.parse(WARP_DRAW))
    is_hash = lambda i: 0x7FEB352D in i.immediates()  # noqa: E731
    draw, step = cfg.innermost_loop(is_hash), cfg.largest_loop()
    assert draw.body < step.body
    assert [cfg.instrs[cfg.blocks[b][0]].addr for b in sorted(draw.body)] == [0x30, 0x60, 0x80]
    hashes = cfg.blocks_with(is_hash, draw.body)
    assert len(hashes) == 1
    # a pass over a cell that is not set, and over one that is
    assert cfg.iteration(draw) == {"issue": 6, "int32": 3, "fp32": 0, "sfu": 0, "mem": 1}
    assert cfg.iteration(draw, via=hashes[0]) == {"issue": 8, "int32": 4, "fp32": 1,
                                                  "sfu": 0, "mem": 1}
    # the step: one pass of the draw loop, two shuffles (mem) and the vote
    assert cfg.iteration(step) == {"issue": 15, "int32": 7, "fp32": 2, "sfu": 0, "mem": 3}


# a shuffle guarded by BRA.DIV: the fast path falls through when the warp
# is converged; the slow path (WARPSYNC.COLLECTIVE, the shuffle again)
# branches back after it
DIVERGENT_SHUFFLE = listing(
    "/*0000*/                   UMOV UR4, 0xffffffff ;",
    "/*0010*/                   BRA.DIV UR4, 0x50 ;",
    "/*0020*/                   SHFL.BFLY PT, R5, R4, 0x10, 0x1f ;",
    "/*0030*/                   FMNMX R4, R4, R5, !PT ;",
    "/*0040*/                   EXIT ;",
    "/*0050*/                   WARPSYNC.COLLECTIVE R17, 0x80 ;",
    "/*0060*/                   SHFL.BFLY P0, R5, R4, 0x10, 0x1f ;",
    "/*0070*/                   NOP ;",
    "/*0080*/                   BRA 0x30 ;",
)


def test_bra_div_may_fall_through_to_the_converged_path():
    cfg = _sass.Cfg(_sass.parse(DIVERGENT_SHUFFLE))
    assert cfg.instrs[1].conditional()
    starts = [cfg.instrs[s].addr for s, _ in cfg.blocks]
    assert starts == [0x00, 0x20, 0x30, 0x50]
    assert cfg.succ == [[1, 3], [2], [], [2]]
    got = cfg.min_counts(0, 2, within=range(len(cfg.blocks)))
    assert got == {"issue": 5, "int32": 0, "fp32": 1, "sfu": 0, "mem": 1}


# K1/K2's step loop, as the warp-per-env kernel's SASS lays it out: a
# prologue; the step's header tests for the wire; the staging block writes
# a lane's row of 12 planes to shared memory, then a barrier and (thread 0)
# two TMA tensor stores; a dead warp skips the step; the draw hashes the
# noise beside the 5 rounds of its scan, behind a BRA.DIV whose slow path,
# after the kernel's exit, repeats the draw and jumps back into the step
BIT_STEP = listing(
    "/*0000*/                   S2R R0, SR_LANEID ;",
    "/*0010*/                   ISETP.NE.AND P5, PT, R0, RZ, PT ;",
    "/*0020*/               @P5 BRA 0x40 ;",
    "/*0030*/                   MOV R9, RZ ;",
    "/*0040*/                   MOV R10, RZ ;",
    "/*0050*/                   ISETP.NE.AND P0, PT, R8, RZ, PT ;",
    "/*0060*/              @!P0 BRA 0x190 ;",
    "/*0070*/                   LOP3.LUT R2, R3, R4, RZ, 0xc0, !PT ;",
    *(f"/*{0x80 + 0x10 * j:04x}*/                   STS [R1+{hex(0x40 * j)}], R2 ;"
      for j in range(12)),
    "/*0140*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
    "/*0150*/               @P1 BRA 0x190 ;",
    "/*0160*/                   UTMASTG.2D [UR4], [UR8] ;",
    "/*0170*/                   UTMASTG.2D [UR4], [UR12] ;",
    "/*0180*/                   UTMACMDFLUSH ;",
    "/*0190*/                   ISETP.GE.AND P2, PT, R10, R11, PT ;",
    "/*01a0*/               @P2 BRA 0x280 ;",
    "/*01b0*/                   UMOV UR6, 0xffffffff ;",
    "/*01c0*/                   BRA.DIV UR6, 0x2d0 ;",
    "/*01d0*/                   IMAD R3, R9, 0x7feb352d, RZ ;",
    *(f"/*{0x1e0 + 0x10 * j:04x}*/                   SHFL.UP PT, R4, R5, {hex(1 << j)}, RZ ;"
      for j in range(5)),
    "/*0230*/                   VOTE.ANY R6, PT, P3 ;",
    "/*0240*/                   IADD3 R7, R4, R6, RZ ;",
    "/*0250*/                   STS [R1], R7 ;",
    "/*0260*/                   LDS R8, [R1] ;",
    "/*0270*/                   NOP ;",
    "/*0280*/                   IADD3 R9, R9, 0x1, RZ ;",
    "/*0290*/                   ISETP.LT.AND P4, PT, R9, 0x3e8, PT ;",
    "/*02a0*/               @P4 BRA 0x50 ;",
    "/*02b0*/                   EXIT ;",
    "/*02c0*/                   BRA 0x2c0;",
    "/*02d0*/                   WARPSYNC.COLLECTIVE R17, 0x340 ;",
    "/*02e0*/                   IMAD R3, R9, 0x7feb352d, RZ ;",
    *(f"/*{0x2f0 + 0x10 * j:04x}*/                   SHFL.UP PT, R4, R5, {hex(1 << j)}, RZ ;"
      for j in range(5)),
    "/*0340*/                   VOTE.ANY R6, PT, P3 ;",
    "/*0350*/                   BRA 0x240 ;",
)


def test_bit_rollout_step_and_stage_signatures():
    import chip_smoke

    cfg = _sass.Cfg(_sass.parse(BIT_STEP))
    starts = [cfg.instrs[s].addr for s, _ in cfg.blocks]
    assert starts == [0x0, 0x30, 0x40, 0x50, 0x70, 0x160, 0x190, 0x1B0, 0x1D0, 0x240, 0x280,
                      0x2B0, 0x2C0, 0x2D0]
    # the slow path's jump back closes a loop larger than the step loop
    assert cfg.largest_loop().latch == 13 and len(cfg.largest_loop().body) == 11
    got = chip_smoke.bit_rollout_counts(cfg)
    # K1: header, the dead-warp test, the BRA.DIV, the draw, the rest, latch
    assert got["K1 step"] == {"issue": 20, "int32": 7, "fp32": 0, "sfu": 0, "mem": 7}
    # K2: the same through the staging block (12 STS, the barrier), past the TMA arm
    assert got["K2 step"] == {"issue": 35, "int32": 8, "fp32": 0, "sfu": 0, "mem": 19}
    assert got["K2 stage row"] == {"issue": 15, "int32": 1, "fp32": 0, "sfu": 0, "mem": 12}


def test_bit_rollout_signatures_refuse_a_wire_without_tensor_stores():
    import chip_smoke

    plain = BIT_STEP.replace("UTMASTG.2D [UR4], [UR8]", "STG.E [R2.64], R3")
    with pytest.raises(RuntimeError, match="two TMA boxes"):
        chip_smoke.bit_rollout_counts(_sass.Cfg(_sass.parse(plain)))
    unscanned = BIT_STEP.replace("SHFL.UP PT, R4, R5, 0x10, RZ", "SHFL.IDX PT, R4, R5, 0x10, 0x1f")
    with pytest.raises(RuntimeError, match="5 rounds of its scan"):
        chip_smoke.bit_rollout_counts(_sass.Cfg(_sass.parse(unscanned)))


def test_a_path_through_a_sequence_of_blocks():
    cfg = _sass.Cfg(_sass.parse(BIT_STEP))
    step = cfg.innermost_loop(lambda i: i.opcode.startswith("SHFL.UP"), at_least=5)
    assert (step.header, step.latch) == (3, 10)
    # through the staging block alone, the shortest pass skips the step (a dead warp)
    assert cfg.iteration(step, via=4)["mem"] == 12
    assert cfg.iteration(step, via=(4, 8))["mem"] == 19
    assert cfg.iteration(step, via=[4, 8]) == cfg.iteration(step, via=(4, 8))


@pytest.mark.parametrize(
    "opcode, cls",
    [
        ("IMAD.WIDE.U32", "int32"),
        ("LOP3.LUT", "int32"),
        ("ISETP.GE.AND", "int32"),
        ("FFMA", "fp32"),
        ("I2FP.F32.S32", "fp32"),
        ("MUFU.LG2", "sfu"),
        ("POPC", "sfu"),
        ("LDG.E.CONSTANT", "mem"),
        ("STG.E.128", "mem"),
        ("SHFL.BFLY", "mem"),
        ("VOTE.ANY", "int32"),
        ("UIADD3", "issue"),
        ("UTMASTG.2D", "issue"),
        ("SHFL.UP", "mem"),
        ("BSSY", "issue"),
    ],
)
def test_instruction_classes(opcode, cls):
    assert _sass.instr_class(opcode) == cls


def test_seconds_takes_the_slowest_class():
    counts = {"issue": 128, "int32": 128, "fp32": 0, "sfu": 0, "mem": 0}
    # 128 integer lanes at 64 a clock take 2 clocks; the issue slots 1
    assert _sass.seconds(counts, sms=1, clock_hz=1.0) == 2.0


def test_listings_it_cannot_read_raise():
    with pytest.raises(ValueError, match="one kernel"):
        _sass.parse(LOOP + LOOP)
    with pytest.raises(ValueError, match="indirect"):
        _sass.Cfg(_sass.parse(listing("/*0000*/                   BRX R2 -0x10 ;")))
