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
        ("UIADD3", "issue"),
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
