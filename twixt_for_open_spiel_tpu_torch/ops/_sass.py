"""Read a built kernel's machine code (SASS) and bound what it must issue.

``cuobjdump -sass`` lists each instruction of a kernel with its address.
This module splits that list into basic blocks, finds the loops (a branch
to a lower address closes one) and counts, per instruction class, the
fewest instructions a thread can issue between two blocks: a node-weighted
shortest path, one Dijkstra per class, so each class's count is a lower
bound on its own.  ``chip_smoke.py`` multiplies these counts by the
iterations a run makes and divides by the card's issue rates to get the
operation side of each kernel's bound.

Classes and their rates per SM and clock (thread lanes) on the H100, from
the CUDA C++ Programming Guide's arithmetic-throughput table for compute
capability 9.0 and the SM's four schedulers of one warp instruction each:

  issue  every instruction                                   128
  int32  integer add, multiply, logic, shift, compare, move   64
  fp32   float32 add, multiply, fma, compare, select         128
  sfu    MUFU, popcount, bit scans, the slow conversions      16
  mem    loads and stores to global, shared and local memory  32

Uniform-datapath (``U*``) and control instructions count under ``issue``
only.  The module runs ``cuobjdump`` only in :func:`kernel_sass`; parsing
and counting are plain Python, so they run anywhere.
"""

from __future__ import annotations

import dataclasses
import heapq
import re
import subprocess
from pathlib import Path

from twixt_for_open_spiel_tpu_torch.ops import _cuda

CLASSES = ("issue", "int32", "fp32", "sfu", "mem")
LANES_PER_SM_CLOCK = {"issue": 128, "int32": 64, "fp32": 128, "sfu": 16, "mem": 32}

_SFU = {"MUFU", "POPC", "FLO", "BREV", "I2F", "F2I", "F2F", "FRND"}
_FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
         "I2FP", "F2IP", "FSWZADD", "HADD2", "HMUL2", "HFMA2"}
_MEM = {"LDG", "STG", "LD", "ST", "LDS", "STS", "LDL", "STL", "ATOM", "ATOMG",
        "ATOMS", "RED", "LDGSTS", "LDSM"}
_ISSUE_ONLY = {"BRA", "BSSY", "BSYNC", "EXIT", "NOP", "BAR", "WARPSYNC",
               "YIELD", "RET", "CALL", "S2R", "S2UR", "CS2R", "LDC", "R2UR",
               "BMOV", "DEPBAR", "MEMBAR", "ERRBAR", "CCTL"}
_TERMINATORS = {"EXIT", "RET"}
_INDIRECT = {"BRX", "JMX", "JMP"}

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_HEX = re.compile(r"-?0x[0-9a-f]+")


def instr_class(opcode: str) -> str:
    """The class of an opcode (``IMAD.WIDE.U32`` -> ``int32``); ``issue``
    for one that takes only an issue slot."""
    base = opcode.split(".")[0]
    if base in _SFU:
        return "sfu"
    if base in _FP32:
        return "fp32"
    if base in _MEM:
        return "mem"
    if base in _ISSUE_ONLY or base.startswith("U"):
        return "issue"
    return "int32"


@dataclasses.dataclass(frozen=True)
class Instr:
    addr: int
    guarded: bool  # under an @P predicate
    opcode: str
    operands: str

    @property
    def base(self) -> str:
        return self.opcode.split(".")[0]

    def immediates(self) -> list:
        """Hex literals of the operands as u32 (``-0x61c88647`` is
        ``0x9e3779b9``)."""
        return [int(h, 16) & 0xFFFFFFFF for h in _HEX.findall(self.operands)]

    def target(self):
        """The branch target address, or None."""
        if self.base != "BRA":
            return None
        return int(_HEX.findall(self.operands)[-1], 16)

    def conditional(self) -> bool:
        """A branch or exit that may fall through."""
        # "BRA P2, 0x..." and "BRA !P2, 0x..." branch on a second predicate
        return self.guarded or bool(re.match(r"!?U?P[0-6]\s*,", self.operands))


def parse(text: str) -> list:
    """The instructions of the one kernel in ``cuobjdump -sass`` output."""
    functions = text.count("Function :")
    if functions != 1:
        raise ValueError(f"expected one kernel in the SASS listing, found {functions}")
    body = text.split("Function :", 1)[1]
    out = [
        Instr(int(m.group(1), 16), bool(m.group(2)) and "PT" not in m.group(2),
              m.group(3), m.group(4).strip())
        for m in _INSTR.finditer(body)
    ]
    if not out:
        raise ValueError("no instructions in the SASS listing")
    return out


@dataclasses.dataclass(frozen=True)
class Loop:
    header: int  # block index
    latch: int   # the block whose branch closes the loop
    body: frozenset


class Cfg:
    """Basic blocks, their successors and their class counts."""

    def __init__(self, instrs: list):
        self.instrs = instrs
        index = {ins.addr: i for i, ins in enumerate(instrs)}
        leaders = {0}
        for i, ins in enumerate(instrs):
            if ins.base in _INDIRECT:
                raise ValueError(f"indirect branch at {ins.addr:#x}: not supported")
            if ins.base == "BRA" or ins.base in _TERMINATORS:
                leaders.add(i + 1)
            t = ins.target()
            if t is not None:
                if t not in index:
                    raise ValueError(f"branch at {ins.addr:#x} to {t:#x}: no instruction there")
                leaders.add(index[t])
        starts = sorted(s for s in leaders if s < len(instrs))
        self.blocks = [(s, e) for s, e in zip(starts, starts[1:] + [len(instrs)])]
        block_of = {s: b for b, (s, _) in enumerate(self.blocks)}
        self.succ = []
        for b, (s, e) in enumerate(self.blocks):
            last = instrs[e - 1]
            nxt = [b + 1] if b + 1 < len(self.blocks) else []
            t = last.target()
            if t is not None:
                out = [block_of[index[t]]] + (nxt if last.conditional() else [])
            elif last.base in _TERMINATORS:
                out = nxt if last.conditional() else []
            else:
                out = nxt
            self.succ.append(sorted(set(out)))
        self.counts = []
        for s, e in self.blocks:
            c = dict.fromkeys(CLASSES, 0)
            for ins in instrs[s:e]:
                c["issue"] += 1
                cls = instr_class(ins.opcode)
                if cls != "issue":
                    c[cls] += 1
            self.counts.append(c)

    def instructions(self, block: int) -> list:
        s, e = self.blocks[block]
        return self.instrs[s:e]

    def loops(self) -> list:
        """Every natural loop: one per branch to a lower (or the same)
        address."""
        pred = [[] for _ in self.blocks]
        for b, out in enumerate(self.succ):
            for t in out:
                pred[t].append(b)
        found = []
        for b, out in enumerate(self.succ):
            for h in out:
                if h > b:
                    continue
                # every block that reaches the latch without passing the header
                body, stack = {h, b}, ([b] if b != h else [])
                while stack:
                    for p in pred[stack.pop()]:
                        if p not in body:
                            body.add(p)
                            stack.append(p)
                found.append(Loop(h, b, frozenset(body)))
        return found

    def largest_loop(self) -> Loop:
        return max(self.loops(), key=lambda lp: len(lp.body))

    def innermost_loop(self, match, at_least: int = 1) -> Loop:
        """The smallest loop whose body holds ``at_least`` instructions for
        which ``match(instr)`` is true."""
        hits = [
            lp for lp in self.loops()
            if sum(match(i) for b in lp.body for i in self.instructions(b)) >= at_least
        ]
        if not hits:
            raise ValueError("no loop holds the instructions sought")
        return min(hits, key=lambda lp: len(lp.body))

    def blocks_with(self, match, within) -> list:
        return sorted(b for b in within if any(match(i) for i in self.instructions(b)))

    def _shortest(self, cls: str, src: int, dst: int, within) -> int:
        dist, heap = {src: self.counts[src][cls]}, [(self.counts[src][cls], src)]
        while heap:
            d, b = heapq.heappop(heap)
            if b == dst:
                return d
            if d > dist[b]:
                continue
            for t in self.succ[b]:
                if t not in within:
                    continue
                nd = d + self.counts[t][cls]
                if nd < dist.get(t, nd + 1):
                    dist[t] = nd
                    heapq.heappush(heap, (nd, t))
        raise ValueError(f"block {dst} is not reachable from block {src}")

    def min_counts(self, src: int, dst: int, within, via=None) -> dict:
        """Per class, the fewest instructions on a path from block ``src``
        to block ``dst`` (both counted) inside the blocks ``within``,
        through block ``via`` if given."""
        if via is None:
            return {c: self._shortest(c, src, dst, within) for c in CLASSES}
        return {
            c: self._shortest(c, src, via, within) + self._shortest(c, via, dst, within)
            - self.counts[via][c]
            for c in CLASSES
        }

    def iteration(self, loop: Loop, via=None) -> dict:
        """Per class, the fewest instructions of one pass through ``loop``
        (from its header to its closing branch), through ``via`` if given."""
        return self.min_counts(loop.header, loop.latch, loop.body, via)


def kernel_sass(name: str) -> str:
    """``cuobjdump -sass`` of the built ``csrc/<name>.cu``."""
    lib = _cuda.build(name)[0]
    tool = Path(_cuda.nvcc()).with_name("cuobjdump")
    return subprocess.run(
        [str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True,
        timeout=120,
    ).stdout


def seconds(counts: dict, sms: int, clock_hz: float) -> float:
    """The least time the card needs to issue ``counts`` (thread
    instructions per class): the slowest class at its rate."""
    return max(counts[c] / (LANES_PER_SM_CLOCK[c] * sms * clock_hz) for c in CLASSES)
