"""KernelSpec — the structured kernel-selection half of an ExecutionPolicy.

Field for field the JAX package's ``KernelSpec``, with the same
validation, so policies compare and hash alike in both packages:

  impl           "ref" or "pallas".  On CUDA tensors both run the
                 hand-written CUDA SpMV kernel (``kernels/csrc/
                 bsr_spmv.cu``); "pallas" is the historical spelling of
                 "the hand-written kernel" and is the only impl that may
                 ask for the fused kernel.  On CPU tensors both run the
                 plain torch versions in ``kernels/ref.py``.
  block_size     kept for equality and validation.  The CUDA kernels'
                 own tiling (one thread block per row-block and query,
                 one thread per tile element) ignores it.
  rows_per_step  kept for equality and validation; ignored by the CUDA
                 kernels, as ``block_size`` is.  The fused kernel only
                 accepts None/1 here, as in the JAX package.
  fuse_frontier  run the fused relax + frontier-select + convergence
                 kernel (``bsr_spmv.bsr_spmv_fused``) instead of the SpMV
                 followed by the torch apply step.
  autotune       accepted by the spec; the session rejects it with a
                 ValueError until the autotuner is ported (ROADMAP).

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
