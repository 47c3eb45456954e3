"""Compilation pipeline (paper Fig. 4): profile → cluster → dependency
analysis → placement → codegen to the graph ISA.

``prepare`` (engine.py) already performs steps 1–4 (it holds the
Clustering and the BSR image); this module performs step 5 — emitting one
ISA ``Program`` per cluster — plus the static per-sweep cost table the
cycle model consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from . import isa
from . import semiring as sr
from .engine import Prepared

# stable ISA rule ids (the GCFG operand); historical names keep their
# ids, anything else registered in semiring.UPDATE_RULES gets one
# appended in registration order
APPLY_RULES = {"relax": 0, "pagerank": 1, "identity": 2}
for _name in sr.UPDATE_RULES:
    APPLY_RULES.setdefault(_name, len(APPLY_RULES))
del _name


@dataclasses.dataclass
class CompiledGraphProgram:
    programs: List[isa.Program]
    cluster_order: np.ndarray          # schedule (engine group ids)
    static_cycles: np.ndarray          # (S,) cycles per full cluster sweep
    instr_total: Dict[str, int]
    b: int

    def total_instructions(self) -> int:
        return sum(len(p) for p in self.programs)


def compile_graph_program(p: Prepared, apply_kind: str = "relax"
                          ) -> CompiledGraphProgram:
    """Emit per-cluster NALE programs from the prepared (clustered) image.

    The tile columns and counts are read to the host once; the programs
    are built by a Python loop over the tiles, as in the JAX package."""
    cols = p.cols.cpu().numpy()
    nnz = p.nnz.cpu().numpy()
    sr.rule(apply_kind)  # unknown rules fail with the registry's error
    rule = APPLY_RULES.setdefault(apply_kind, len(APPLY_RULES))
    programs: List[isa.Program] = []
    static = np.zeros(p.s, dtype=np.int64)
    total: Dict[str, int] = {k: 0 for k in isa.OPCODES}

    grp_of_block = np.arange(p.r_pad) // p.gb
    for s in range(p.s):
        rows = range(s * p.gb, (s + 1) * p.gb)
        ins: List[np.ndarray] = [isa.instr("GCFG", 0, rule),
                                 isa.instr("GCFG", 1, p.b)]
        # receive halo blocks from upstream clusters (FIFO blocks until
        # data ready — this is the handshake that replaces the clock)
        ext_srcs = set()
        for r in rows:
            for k in range(int(nnz[r])):
                cb = int(cols[r, k])
                if grp_of_block[cb] != s:
                    ext_srcs.add(int(grp_of_block[cb]))
        for src in sorted(ext_srcs):
            ins.append(isa.instr("GRCV", src, 1))
        loaded = set()
        for r in rows:
            for k in range(int(nnz[r])):
                cb = int(cols[r, k])
                if cb not in loaded:
                    ins.append(isa.instr("GLDX", cb))
                    loaded.add(cb)
                ins.append(isa.instr("GMAC", k, cb))
            if nnz[r] or sr.rule(apply_kind).bias:
                ins.append(isa.instr("GCMP", r))
                ins.append(isa.instr("GAPP", r, rule))
        for dst in sorted(ext_srcs):  # symmetric notification downstream
            ins.append(isa.instr("GSND", dst, 1))
        ins.append(isa.instr("GSYN"))
        prog = isa.assemble(s, ins)
        programs.append(prog)
        static[s] = prog.static_cycles(p.b)
        for k, v in prog.histogram().items():
            total[k] += v

    return CompiledGraphProgram(
        programs=programs,
        cluster_order=np.arange(p.s, dtype=np.int32),
        static_cycles=static, instr_total=total, b=p.b)
