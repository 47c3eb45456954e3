"""Analytical cycle and energy models for the three platform classes
(paper §III: graph processor vs. Heracles CPU vs. MIAOW GPGPU).

The paper's NALE array and its baselines are not built here, so — like
any architecture study without silicon — performance and power are
*modeled*.  The constants describe the paper's platforms (standard-cell /
literature ballpark numbers, 45 nm-class, matching the paper's
FPGA-prototype era), not the GPU the port runs on, and are reported
alongside every result; the *relative* claims (NALE vs CPU speedup, NALE
vs GPU efficiency) are what the reproduction validates, and those depend
on the work/locality counters measured by the engines, not on the
absolute constants.

Model summary
  NALE array  : cycles = crit_tiles·(B+h) + sweeps·(fill+apply)
                — crit_tiles is the measured per-sweep critical path
                (max active cluster), i.e. perfectly self-timed elements
                limited only by the slowest cluster, no global barrier.
  CPU         : sequential worklist algorithm; cycles/edge =
                instr/edge·CPI + 2 loads·miss_rate·miss_penalty, with a
                cache-capacity miss model (graph >> cache ⇒ misses).
  GPU (SIMD)  : bulk-synchronous Jacobi over padded ELL rows (divergence
                = padding ratio); wide but must sweep everything.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .engine import Prepared, RunStats


@dataclasses.dataclass(frozen=True)
class NaleConfig:
    num_nales: int = 256          # processing elements (paper: scalable)
    freq_hz: float = 500e6        # FPGA-class clock-equivalent rate
    handshake: int = 2            # GasP handshake per tile
    fill: int = 8                 # pipeline fill per sweep
    e_mac_pj: float = 2.0         # per 32-bit MAC
    e_sram_pj_b: float = 0.5      # per byte, FIFO/VMEM
    e_dram_pj_b: float = 15.0     # per byte, main memory
    p_static_w: float = 0.15      # async logic: tiny idle power


@dataclasses.dataclass(frozen=True)
class CpuConfig:
    freq_hz: float = 1e9
    instr_per_edge: float = 8.0
    cpi: float = 1.2
    cache_bytes: float = 256e3    # Heracles-class soft core
    miss_penalty: int = 100
    loads_per_edge: float = 2.0
    e_instr_pj: float = 70.0      # full in-order pipeline per instr
    e_dram_pj_b: float = 15.0
    p_static_w: float = 0.5


@dataclasses.dataclass(frozen=True)
class GpuConfig:
    freq_hz: float = 800e6
    lanes: int = 1024             # SIMD width × CUs (MIAOW-class)
    cycles_per_edge: float = 1.0
    sweep_overhead: int = 2000    # kernel launch / global barrier
    e_op_pj: float = 15.0
    e_dram_pj_b: float = 15.0
    p_static_w: float = 25.0      # clocked SIMD array + scheduler idle


@dataclasses.dataclass
class PlatformReport:
    platform: str
    cycles: float
    time_s: float
    energy_j: float
    power_w: float

    @property
    def perf_per_watt(self) -> float:
        return 1.0 / (self.time_s * self.power_w) if self.time_s else 0.0


def _miss_rate(n_vertices: int, cfg: CpuConfig) -> float:
    working = n_vertices * 8.0
    return float(np.clip(1.0 - cfg.cache_bytes / max(working, 1.0),
                         0.02, 0.98))


def model_nale(p: Prepared, stats: RunStats,
               cfg: NaleConfig = NaleConfig()) -> PlatformReport:
    b = p.b
    # parallelism: clusters map onto NALEs; if clusters > NALEs they
    # time-multiplex (cluster-mode internal FIFO), folding the critical path
    fold = max(1.0, p.s / cfg.num_nales)
    cycles = stats.crit_tiles * (b + cfg.handshake) * fold \
        + stats.sweeps * (cfg.fill + p.gb)
    time_s = cycles / cfg.freq_hz
    macs = stats.tile_work * b * b
    bytes_tiles = stats.tile_work * b * b * 4.0        # streamed from DRAM
    bytes_halo = stats.halo_tiles * b * 4.0            # FIFO/on-chip
    energy = (macs * cfg.e_mac_pj + bytes_tiles * cfg.e_dram_pj_b
              + bytes_halo * cfg.e_sram_pj_b) * 1e-12 \
        + cfg.p_static_w * time_s
    return PlatformReport("nale", float(cycles), float(time_s),
                          float(energy),
                          float(energy / time_s) if time_s else 0.0)


def model_cpu(p: Prepared, stats: RunStats,
              cfg: CpuConfig = CpuConfig()) -> PlatformReport:
    """Sequential CPU running the classic worklist algorithm: its total
    edge relaxations ≈ the async engine's edge_work (same data-driven
    semantics, but serialized on one core with a cache)."""
    mr = _miss_rate(p.n, cfg)
    per_edge = cfg.instr_per_edge * cfg.cpi \
        + cfg.loads_per_edge * mr * cfg.miss_penalty
    cycles = stats.edge_work * per_edge
    time_s = cycles / cfg.freq_hz
    energy = (stats.edge_work * cfg.instr_per_edge * cfg.e_instr_pj
              + stats.edge_work * cfg.loads_per_edge * mr * 64
              * cfg.e_dram_pj_b) * 1e-12 + cfg.p_static_w * time_s
    return PlatformReport("cpu", float(cycles), float(time_s),
                          float(energy),
                          float(energy / time_s) if time_s else 0.0)


def model_gpu(p: Prepared, stats_sync: RunStats, k_max_pad: float,
              avg_degree: float,
              cfg: GpuConfig = GpuConfig()) -> PlatformReport:
    """GPU executes bulk-synchronous sweeps over ELL-padded rows; SIMD
    divergence charges padded (not true) edges.  Needs *sync* sweep count."""
    pad_ratio = max(k_max_pad / max(avg_degree, 1e-9), 1.0)
    padded_edges = stats_sync.edge_work * pad_ratio
    cycles = padded_edges * cfg.cycles_per_edge / cfg.lanes \
        + stats_sync.sweeps * cfg.sweep_overhead
    time_s = cycles / cfg.freq_hz
    energy = (padded_edges * cfg.e_op_pj
              + padded_edges * 12 * cfg.e_dram_pj_b) * 1e-12 \
        + cfg.p_static_w * time_s
    return PlatformReport("gpu", float(cycles), float(time_s),
                          float(energy),
                          float(energy / time_s) if time_s else 0.0)
