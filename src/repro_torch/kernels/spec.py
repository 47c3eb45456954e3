"""KernelSpec — the structured kernel-selection half of an ExecutionPolicy.

Field for field the JAX package's ``KernelSpec``, with the same
validation, so policies compare and hash alike in both packages:

  impl           "ref" or "pallas".  On CUDA tensors both run the
                 hand-written CUDA SpMV kernels (the compacted route,
                 ``kernels/csrc/bsr_spmv_compact.cu``, on every engine);
                 "pallas" is the historical spelling of "the hand-written
                 kernel" and is the only impl that may set the knobs below
                 or ask for the fused kernel.  On CPU tensors both run the
                 plain torch versions in ``kernels/ref.py``, which ignore
                 the knobs.
  block_size     warps per thread block of the compacted kernels (32 ×
                 block_size threads, 1..32).  None = the default, 8 (256
                 threads), or the autotuned winner when ``autotune=True``.
  rows_per_step  vertex rows one thread walks in the unfused compacted
                 kernel, grid-strided so that a warp's entry loads still
                 fall on neighbouring rows.  The fused kernel keeps 1: its
                 ``changed`` ballot needs one row per lane, so it only
                 accepts None/1 here, as in the JAX package.  None = 1 or
                 the autotuned winner.
  fuse_frontier  run the fused relax + frontier-select + convergence
                 kernel (``bsr_spmv.bsr_spmv_fused``) instead of the SpMV
                 followed by the torch apply step.
  autotune       measure (not model) the free knobs on a calibration
                 sweep of the plan on its device (``kernels/autotune.py``)
                 and cache the winner beside the plan, in the PlanStore
                 when the session has one.

The defaults are the launch the kernels had before they took knobs (256
threads, one row a thread), and every value of the knobs gives the same
bits.

Incoherent combinations fail loudly at construction: every knob other
than ``impl`` describes the hand-written kernel, so they all require
``impl="pallas"``; ``autotune`` with every tunable pinned has nothing
left to tune.

Specs are frozen/hashable: they ride in ``ExecutionPolicy`` equality and
in ``PlanKey``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

IMPLS = ("ref", "pallas")

DEFAULT_BLOCK_SIZE = 8     # warps a thread block: 256 threads
DEFAULT_ROWS_PER_STEP = 1


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    impl: str = "ref"
    block_size: Optional[int] = None
    rows_per_step: Optional[int] = None
    fuse_frontier: bool = False
    autotune: bool = False

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(
                f"impl must be one of {IMPLS}: {self.impl!r}")
        for field in ("block_size", "rows_per_step"):
            v = getattr(self, field)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(
                    f"{field} must be None or a positive int: {v!r}")
        if self.impl == "ref":
            bad = [f for f in ("block_size", "rows_per_step") if
                   getattr(self, f) is not None]
            bad += [f for f in ("fuse_frontier", "autotune") if
                    getattr(self, f)]
            if bad:
                raise ValueError(
                    f"{'/'.join(bad)} describe the Pallas kernel and "
                    "require impl='pallas'; the ref path has no tiling "
                    "knobs")
        if self.fuse_frontier and self.rows_per_step not in (None, 1):
            raise ValueError(
                "the fused kernel walks its compact active-row list one "
                "row-block per grid step; rows_per_step="
                f"{self.rows_per_step} needs fuse_frontier=False")
        if self.autotune:
            tunables = ("block_size",) if self.fuse_frontier else \
                ("block_size", "rows_per_step")
            if all(getattr(self, f) is not None for f in tunables):
                raise ValueError(
                    "autotune=True with every tunable pinned "
                    f"({', '.join(tunables)}) has nothing to tune; "
                    "unpin one or drop autotune")

    def concrete(self, tuning: Optional[dict] = None) -> "KernelSpec":
        """The spec engines actually execute: free knobs filled from a
        tuning record (``kernels.autotune`` output) or defaults, and the
        ``autotune`` request flag stripped (it described *how to pick*
        the knobs, not the kernel itself)."""
        t = tuning or {}
        if self.impl == "ref":
            return KernelSpec(impl="ref")
        bk = self.block_size or int(t.get("block_size")
                                    or DEFAULT_BLOCK_SIZE)
        if self.fuse_frontier:
            rs = 1
        else:
            rs = self.rows_per_step or int(t.get("rows_per_step")
                                           or DEFAULT_ROWS_PER_STEP)
        return KernelSpec(impl=self.impl, block_size=bk, rows_per_step=rs,
                          fuse_frontier=self.fuse_frontier, autotune=False)


def as_kernel_spec(spec) -> KernelSpec:
    """Coerce the historical spellings — None (defaults) and the bare
    impl string — into a KernelSpec."""
    if spec is None:
        return KernelSpec()
    if isinstance(spec, str):
        return KernelSpec(impl=spec)
    if isinstance(spec, KernelSpec):
        return spec
    raise TypeError(
        f"expected KernelSpec, impl string or None, got {type(spec)}")
