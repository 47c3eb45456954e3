"""Measured tuning of the compacted SpMV kernels' launch knobs.

The JAX package's ``kernels/autotune.py`` with the same names, candidate
grid, tie-break and record keys.  The paper's NALE array is self-timed:
throughput follows the data, not a static worst-case schedule.  The
software analogue is picking the kernel's launch knobs, and the honest
way to pick them is to *measure* a calibration sweep on the plan's own
structure.  On this card the knobs are those of the compacted kernels
(``kernels/csrc/bsr_spmv_compact.cu``, see ``kernels/spec.py``):

  block_size     warps a thread block, over ``BK_CANDIDATES`` (2, 4, 8, 16:
                 64 to 512 threads), capped at the plan's ``k_max`` as in
                 the JAX package (whose knob was tiles a grid step);
  rows_per_step  rows a thread of the unfused kernel walks, over
                 ``RS_CANDIDATES`` (1, 2, 4); the fused kernel keeps 1.

``autotune_spmv(p, spec)`` times one sweep per candidate on a seeded
~25 %-dense calibration frontier drawn from ``np.random.default_rng(seed)``
exactly as the JAX package draws it, uploaded to the plan's device.  The
winner is deterministic for a given seed and measurement function: ties
break toward the smallest (block_size, rows_per_step), so with the same
injected ``measure`` the record's knobs, seed, ``measured_s`` and
candidate list equal the JAX package's.  Every candidate gives the same
bits (the kernels compute each row in the same order at every launch
shape), so the choice moves time only.

Each record carries a roofline cross-check from
``launch.roofline.kernel_roofline``: ``roofline_agrees`` is True when the
measured time is at or above the modelled lower bound (a measurement
below it means the timing is wrong: recorded, never used to override the
measurement).  The model counts what the **compacted** kernel must move
(``entry_bytes``): the filled entries of the walked rows, 8 B each, their
row pointers, the x values they read (each once) and y written once;
fused, the active rows only, with their xg, valid, the act mask and the
changed bits.  The JAX package counts B x B f32 ELL tiles, the Pallas
kernel's reads: about 20x more bytes at the full CA plan, so every
measurement on this card would fall below its roofline.

The caller (``core/api.GraphProcessor``) caches the record in the
PlanStore keyed by ``(fingerprint, PlanKey(kernel=spec))``, so warm
restarts reuse tunings instead of re-measuring.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import semiring as sr
from ..launch.roofline import kernel_roofline
from . import ops
from .spec import KernelSpec

CALIBRATION_DENSITY = 0.25
BK_CANDIDATES = (2, 4, 8, 16)
RS_CANDIDATES = (1, 2, 4)
# cycles the card spins before each timed call, so that the host has put
# the whole call on the stream before its start event runs (about 1 ms on
# an H100): the events then time the device's work alone
_LEAD_CYCLES = 2_000_000


def _device_of(out) -> torch.device:
    return (out[0] if isinstance(out, tuple) else out).device


def default_measure(call: Callable[[], object], config: KernelSpec,
                    iters: int) -> float:
    """Seconds of one candidate: one warm-up call (which builds and loads
    the library), then the best of ``iters`` timed calls.

    On a CUDA device each call is timed by two ``torch.cuda.Event``s on
    the current stream behind a spin of ``_LEAD_CYCLES``, and the host
    waits on the last event alone.  A device-wide ``torch.cuda.
    synchronize()`` would invalidate a CUDA-graph capture that another
    thread holds open (``core/engine._CapturedSweep``), so none is made.
    On the CPU, ``time.perf_counter`` around each call.  Injectable for
    tests."""
    del config
    dev = _device_of(call())
    if dev.type != "cuda":
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        pairs = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_LEAD_CYCLES)
            start.record(stream)
            call()
            end.record(stream)
            pairs.append((start, end))
        pairs[-1][1].synchronize()
        return min(a.elapsed_time(b) for a, b in pairs) / 1e3


def candidate_specs(spec: KernelSpec, k_max: int):
    """Concrete candidate grid for ``spec``'s free knobs.  Pinned fields
    stay pinned; block_size candidates never exceed the plan's k_max (the
    JAX package's cap, kept so both grids agree)."""
    if spec.block_size is not None:
        bks = [spec.block_size]
    else:
        cap = max(int(k_max), 2)
        bks = [c for c in BK_CANDIDATES if c <= cap] or [2]
    if spec.fuse_frontier:
        rss = [1]
    elif spec.rows_per_step is not None:
        rss = [spec.rows_per_step]
    else:
        rss = list(RS_CANDIDATES)
    return [
        KernelSpec(impl=spec.impl, block_size=bk, rows_per_step=rs,
                   fuse_frontier=spec.fuse_frontier)
        for bk in bks for rs in rss
    ]


def _calibration_inputs(p, seed: int, apply_kind: str):
    """Seeded synthetic state on the plan's real structure, on its
    device: x (r_pad, b) and the row-block frontier act (r_pad,)."""
    del apply_kind
    rng = np.random.default_rng(seed)
    r_pad, b = int(p.r_pad), int(p.b)
    zero = float(sr.get(p.semiring).zero)
    x = torch.from_numpy(np.where(
        rng.random((r_pad, b)) < 0.5, rng.random((r_pad, b)),
        zero).astype(np.float32)).to(p.device)
    act = torch.from_numpy(rng.random(r_pad) < CALIBRATION_DENSITY).to(
        p.device)
    f32 = torch.float32
    damping = torch.tensor(0.85, dtype=f32)
    tol = torch.tensor(1e-6, dtype=f32)
    inv_n = torch.tensor(1.0 / max(int(getattr(p, "n", r_pad * b)), 1),
                         dtype=f32)
    return x, act, damping, tol, inv_n


def _walked(index, act=None):
    """(rows walked, entries walked, distinct x values they read) of one
    query's call over ``index``: every row, or those of the row-blocks
    set in ``act`` (R,)."""
    b = index.b
    row_ptr = index.row_ptr.long()
    walked = (torch.ones(index.r * b, dtype=torch.bool,
                         device=row_ptr.device)
              if act is None else act.repeat_interleave(b))
    on = walked.repeat_interleave(row_ptr.diff())     # per entry
    src = index.pairs[int(row_ptr[0]):int(row_ptr[-1]), 0][on]
    return int(walked.sum()), src.numel(), int(torch.unique(src).numel())


def entry_bytes(index, q, act=None, fused=False) -> int:
    """The compacted kernel's own bytes for one call of ``q`` queries:
    the filled entries of the walked rows (8 B each: source and value),
    their row pointers, the x values those entries read (each once), y
    written once for the walked rows; fused, also xg and valid of those
    rows, the act mask and the changed bits."""
    n, e, n_x = _walked(index, act)
    nbytes = e * 8 + (n + 1) * 4 + q * n_x * 4 + q * n * 4
    if fused:
        nbytes += q * n * 4 + n + 2 * q * index.r
    return nbytes


def _modeled_seconds(p, act, fused: bool) -> dict:
    """Roofline lower bound for one calibration sweep (one query): the
    bytes of ``entry_bytes`` (active rows for the fused kernel, all rows
    unfused); flops are 2 per walked entry (⊗ and ⊕)."""
    index = p.compact_index()
    walk = act if fused else None
    return kernel_roofline(2.0 * _walked(index, walk)[1],
                           entry_bytes(index, 1, walk, fused=fused))


def autotune_spmv(p, spec: KernelSpec, seed: int = 0, iters: int = 3,
                  measure: Optional[Callable] = None,
                  apply_kind: str = "relax",
                  platform: Optional[str] = None) -> dict:
    """Measure ``spec``'s free knobs on plan ``p``; return a
    JSON-serializable tuning record (see module docstring).  ``platform``
    is the JAX package's platform guard; here the plan's device decides,
    as in every kernel wrapper."""
    del platform
    if spec.impl != "pallas":
        raise ValueError(f"autotune targets the hand-written kernel "
                         f"(impl='pallas'), not impl={spec.impl!r}")
    if p.semiring not in sr.BUILTIN:
        raise ValueError(f"autotune measures the compacted kernels, which "
                         f"implement the built-in rings, not "
                         f"{p.semiring!r}")
    measure = measure or default_measure
    x, act, damping, tol, inv_n = _calibration_inputs(p, seed, apply_kind)
    vals, cols, nnz, valid = p.vals, p.cols, p.nnz, p.valid
    index = p.compact_index()

    results = []
    for cand in candidate_specs(spec, p.k_max):
        fn = ops.select_kernel("bsr_spmv", cand)
        if cand.fuse_frontier:
            def call(fn=fn):
                return fn(vals, cols, nnz, x, x, valid, act, damping,
                          tol, inv_n, semiring=p.semiring,
                          apply_kind=apply_kind, index=index)
        else:
            def call(fn=fn):
                return fn(vals, cols, nnz, x, semiring=p.semiring,
                          index=index)
        t = float(measure(call, cand, iters))
        results.append((t, cand))

    t_best, best = min(
        results, key=lambda r: (r[0], r[1].block_size, r[1].rows_per_step))
    model = _modeled_seconds(p, act, spec.fuse_frontier)
    return {
        "block_size": int(best.block_size),
        "rows_per_step": int(best.rows_per_step),
        "measured_s": t_best,
        "modeled_s": model["modeled_s"],
        "roofline_agrees": bool(t_best >= model["modeled_s"]),
        "seed": int(seed),
        "candidates": [
            {"block_size": int(c.block_size),
             "rows_per_step": int(c.rows_per_step), "measured_s": t}
            for t, c in results
        ],
    }
