"""The graph processor's specialized ISA (paper §II).

A NALE executes a small instruction set driven by FIFO readiness; the
co-processor compiles each cluster's work into a program of these ops.
We encode instructions as (opcode, a, b, c) int32 rows; ``compile.py``
generates per-cluster programs and ``power.py`` charges per-op costs.

Opcodes:
  GCFG  cfg_id, value, -      configure engine (semiring, apply rule, B)
  GLDX  col_block, -, -       load a source-value block into the FIFO/VMEM
  GMAC  tile_slot, col_block,- semiring MAC of one BxB tile against a block
  GCMP  row_block, -, -       three-state compare of new vs current values
  GAPP  row_block, rule, -    apply rule (relax / pagerank / identity)
  GSND  dst_cluster, nblocks,- send changed blocks downstream (handshake)
  GRCV  src_cluster, nblocks,- receive blocks (blocks until data ready)
  GSYN  -, -, -               local sweep boundary (no global barrier)
  GHLT  -, -, -               cluster converged
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

OPCODES = {
    "GCFG": 0, "GLDX": 1, "GMAC": 2, "GCMP": 3, "GAPP": 4,
    "GSND": 5, "GRCV": 6, "GSYN": 7, "GHLT": 8,
}
MNEMONICS = {v: k for k, v in OPCODES.items()}

# per-instruction NALE cost model (cycles); GMAC's B is added dynamically
BASE_COST = {
    "GCFG": 1, "GLDX": 1, "GMAC": 0, "GCMP": 1, "GAPP": 1,
    "GSND": 2, "GRCV": 2, "GSYN": 1, "GHLT": 1,
}


def instr(op: str, a: int = 0, b: int = 0, c: int = 0) -> np.ndarray:
    return np.array([OPCODES[op], a, b, c], dtype=np.int32)


@dataclasses.dataclass
class Program:
    """One cluster's instruction stream."""

    cluster_id: int
    code: np.ndarray  # (m, 4) int32

    def __len__(self) -> int:
        return int(self.code.shape[0])

    def histogram(self) -> Dict[str, int]:
        h: Dict[str, int] = {k: 0 for k in OPCODES}
        ops, counts = np.unique(self.code[:, 0], return_counts=True)
        for o, c in zip(ops, counts):
            h[MNEMONICS[int(o)]] = int(c)
        return h

    def static_cycles(self, b: int) -> int:
        """Cycles for one full execution of the stream on a NALE with a
        B-lane MAC datapath (one tile row per cycle → GMAC costs B)."""
        h = self.histogram()
        cyc = sum(BASE_COST[k] * v for k, v in h.items())
        cyc += h["GMAC"] * b
        return cyc

    def disassemble(self, limit: int = 40) -> str:
        lines = []
        for i, (op, a, b, c) in enumerate(self.code[:limit]):
            lines.append(f"{i:4d}: {MNEMONICS[int(op)]:5s} {a:6d} {b:6d} {c:6d}")
        if len(self) > limit:
            lines.append(f"... ({len(self) - limit} more)")
        return "\n".join(lines)


def assemble(cluster_id: int, instrs: List[np.ndarray]) -> Program:
    code = np.stack(instrs) if instrs else np.zeros((0, 4), dtype=np.int32)
    return Program(cluster_id=cluster_id, code=code)
