"""Hand-written CUDA SpMV kernels: build at first use, bind, check, launch.

``bsr_spmv`` replaces the JAX package's Pallas kernel ``bsr_spmv`` and
``bsr_spmv_fused`` its Pallas kernel ``bsr_spmv_fused`` (both in
``src/repro/kernels/bsr_spmv.py``).  Each has two routes, chosen by the
caller and never by a fallback:

  * the ELL route (no ``index``): ``csrc/bsr_spmv.cu`` walks the plan's
    ELL image tile by tile, B x B values per tile (about 1.4 GB, 0.42 ms
    at 3.35 TB/s for one unfused sweep of the full-scale CA plan at b=16);
  * the compacted route (``index=`` a ``CompactIndex``):
    ``csrc/bsr_spmv_compact.cu`` reads only the filled tile entries
    (about 65 MB, 0.020 ms for the same sweep).  The engines take it.

Both compute the same bits.  Each source's head states its work split,
its bound and what its design does about it.

Knobs.  The compacted kernels take two launch knobs (``KernelSpec``'s
``block_size`` and ``rows_per_step``, kernels/spec.py): the warps of a
thread block (1..32; 8 by default) and the vertex rows one thread of the
unfused kernel walks (at least 1; 1 by default; the fused kernel walks one
row a thread whatever it is given).  Every value gives the same bits.  The
ELL route and the plain versions take the knobs and ignore them.

Device rule.  A wrapper given CPU tensors runs the plain torch version in
``kernels/ref.py``; given CUDA tensors it launches its kernel or raises.
There is no fallback from a failed build or launch.

Build.  ``kernels/cuda_lib.py`` compiles each source with nvcc for sm_90a
and ``-fmad=false`` (bit equality with the plain versions) into
``build/kernels/libbsr_spmv-<hash>.so`` and
``build/kernels/libbsr_spmv_compact-<hash>.so`` the first time one of its
kernels is launched, and loads it with ``ctypes``; the C functions take
raw pointers and the current stream and return the CUDA error code.

Each wrapper adds one to ``launch_counts[name]`` (``count_launch``)
where it launches its kernel, and nowhere else: ``bsr_spmv`` and
``bsr_spmv_fused`` count the ELL route, ``bsr_spmv_compact`` and
``bsr_spmv_fused_compact`` the compacted one.  Under a CUDA-graph capture
a wrapper records its launch instead of making it; ``capture_launches``
keeps the capturing thread's counts apart and ``add_launches`` adds them
at each replay, while launches of other threads count as they happen.
The counts take a lock, so they stay exact under concurrent callers.  The
wrappers read nothing from the device, so a capture may hold them.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import pathlib
import threading

import numpy as np
import torch

from . import ref
from ..core import semiring as sr
from .cuda_lib import BASE_FLAGS, CudaLibrary, expect, on_cpu
from .spec import DEFAULT_BLOCK_SIZE, DEFAULT_ROWS_PER_STEP

SEMIRING_CODES = {"plus_times": 0, "min_plus": 1, "max_min": 2,
                  "min_select": 3}
RULE_CODES = {"relax": 0, "pagerank": 1, "pagerank_delta": 2, "kcore": 3,
              "identity": 4}
BLOCK_SIZES = (8, 16, 32)
# the compacted kernels walk a row of more entries than this one warp a
# row, and shorter rows one thread a row
LONG_ROW = 32
MAX_WARPS = 32   # 1,024 threads: CUDA's most a block

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "bsr_spmv.cu"
SOURCE_COMPACT = CSRC / "bsr_spmv_compact.cu"
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)

launch_counts = {"bsr_spmv": 0, "bsr_spmv_fused": 0,
                 "bsr_spmv_compact": 0, "bsr_spmv_fused_compact": 0}


_COUNT_LOCK = threading.Lock()
_capturing = threading.local()   # .recorded: the open capture's counts


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel: into the capture this thread has
    open (``capture_launches``), else into ``launch_counts``."""
    recorded = getattr(_capturing, "recorded", None)
    if recorded is not None:
        recorded[name] += 1
        return
    with _COUNT_LOCK:
        launch_counts[name] += 1


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in launch_counts:
            launch_counts[k] = 0


@contextlib.contextmanager
def capture_launches():
    """Around a CUDA-graph capture: yields a dict that, on exit, holds the
    launches this thread's wrappers counted inside (recorded into the
    graph, not made).  They never reach ``launch_counts``; launches of
    other threads meanwhile do."""
    recorded = dict.fromkeys(launch_counts, 0)
    _capturing.recorded = recorded
    try:
        yield recorded
    finally:
        _capturing.recorded = None


def add_launches(recorded: dict) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    with _COUNT_LOCK:
        for k, v in recorded.items():
            launch_counts[k] += v


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bsr_spmv_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.bsr_spmv_launch.restype = i
    lib.bsr_spmv_fused_launch.argtypes = [
        p, p, p, p, p, p, p, f, f, f, p, p, p, i, i, i, i, i, i, i, p]
    lib.bsr_spmv_fused_launch.restype = i


def _bind_compact(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bsr_spmv_compact_launch.argtypes = [
        p, p, p, i, i, i, p, p, i, i, i, i, i, i, i, p]
    lib.bsr_spmv_compact_launch.restype = i
    lib.bsr_spmv_fused_compact_launch.argtypes = [
        p, p, p, i, i, i, p, p, p, p, f, f, f, p, p, p, i, i, i, i, i, i, i,
        p]
    lib.bsr_spmv_fused_compact_launch.restype = i


LIBRARY = CudaLibrary("bsr_spmv", SOURCE, NVCC_FLAGS, _bind,
                      "bsr_error_string")
LIBRARY_COMPACT = CudaLibrary("bsr_spmv_compact", SOURCE_COMPACT,
                              NVCC_FLAGS, _bind_compact,
                              "bsr_compact_error_string")


@dataclasses.dataclass(frozen=True, eq=False)
class CompactIndex:
    """The filled entries of an ELL tile image, vertex row by vertex row.

    ``row_ptr`` (n_rows + 1,) int32: row v's entries are
    ``pairs[row_ptr[v]:row_ptr[v + 1]]`` (absolute offsets, so the index
    of a range of row-blocks is a slice of ``row_ptr``, see ``rows``).
    ``pairs`` (E, 2) int32: the source column ``cols[r, k]·B + j`` and the
    bits of the f32 value ``vals[r, k, i, j]``, one 8-byte load each.
    Entries are ordered by (row-block r, row i, tile k, column j); ``b``
    is the tile size, ``semiring`` the ring whose ⊕-identity was left
    out.  ``long_rows`` (int32, on the device) and ``long_host`` (the same
    ids on the host) list the rows of more than ``LONG_ROW`` entries,
    which the kernels walk one warp a row, by their id in the full index;
    ``row_base`` is the id there of this index's first row.  Built by
    ``build_compact_index``."""

    row_ptr: torch.Tensor
    pairs: torch.Tensor
    long_rows: torch.Tensor
    long_host: np.ndarray
    b: int
    semiring: str
    row_base: int = 0

    @property
    def src(self) -> torch.Tensor:
        return self.pairs[:, 0]

    @property
    def val(self) -> torch.Tensor:
        return self.pairs.view(torch.float32)[:, 1]

    @property
    def r(self) -> int:
        """Row-blocks covered."""
        return (self.row_ptr.shape[0] - 1) // self.b

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.row_ptr, self.pairs, self.long_rows))

    def rows(self, sl: slice) -> "CompactIndex":
        """The index of row-blocks ``sl`` (step 1): views, no copy, no
        device sync."""
        start, stop, step = sl.indices(self.r)
        if step != 1:
            raise ValueError(f"row-block slices take step 1, not {step}")
        stop = max(stop, start)
        first = self.row_base + start * self.b
        lo, hi = np.searchsorted(self.long_host,
                                 [first, self.row_base + stop * self.b])
        return dataclasses.replace(
            self, row_ptr=self.row_ptr[start * self.b: stop * self.b + 1],
            long_rows=self.long_rows[lo:hi], long_host=self.long_host[lo:hi],
            row_base=first)


def build_compact_index(vals, cols, nnz, semiring: str) -> CompactIndex:
    """The compacted index of a plan's ELL image, on the image's device.

    Keeps every entry ``vals[r, k, i, j]`` of a true tile (k < nnz[r])
    whose value is not, bit for bit, the ring's ⊕-identity: by the
    semiring contract (``core/semiring.py``, ``mul(zero, x) == zero``) an
    identity entry changes no sum on the inputs the ring admits, so both
    routes give the same bits.  Tiles at k ≥ nnz[r] never enter, whatever
    they hold.  Torch ops only; it reads the entry count and the long
    rows to the host, once each."""
    if vals.dim() != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (R, K, B, B), got {tuple(vals.shape)}")
    r, k, b, _ = vals.shape
    expect(vals, "vals", torch.float32, (r, k, b, b))
    expect(cols, "cols", torch.int32, (r, k))
    expect(nnz, "nnz", torch.int32, (r,))
    zero = torch.tensor(float(sr.get(semiring).zero), dtype=torch.float32)
    bits = vals.view(torch.int32)
    live = torch.arange(k, device=vals.device)[None, :] < nnz[:, None]
    keep = (bits != int(zero.view(torch.int32))) & live[:, :, None, None]
    keep = keep.permute(0, 2, 1, 3)                      # (R, B_i, K, B_j)
    at = keep.nonzero()                                  # (r, i, k, j) order
    if at.shape[0] >= 2 ** 31:
        raise ValueError(f"{at.shape[0]} entries overflow the int32 index")
    ri, ii, ki, ji = at.unbind(1)
    pairs = torch.stack([cols[ri, ki] * b + ji.int(), bits[ri, ki, ii, ji]],
                        dim=1).contiguous()
    lens = keep.sum(dim=(2, 3)).reshape(-1)
    row_ptr = torch.zeros(r * b + 1, dtype=torch.int32, device=vals.device)
    row_ptr[1:] = lens.cumsum(0)
    long_rows = (lens > LONG_ROW).nonzero()[:, 0].int()
    return CompactIndex(row_ptr=row_ptr, pairs=pairs, long_rows=long_rows,
                        long_host=long_rows.cpu().numpy().astype(np.int64),
                        b=b, semiring=semiring)


def _check_call(b, x, semiring):
    """Checks both routes share: tile size, ring, x (Q, C, B) f32."""
    if b not in BLOCK_SIZES:
        raise ValueError(f"block size {b} not in {BLOCK_SIZES}")
    if semiring not in SEMIRING_CODES:
        raise ValueError(f"the CUDA kernels implement {sorted(SEMIRING_CODES)}, "
                         f"not {semiring!r}")
    if x.dim() != 3 or x.shape[2] != b:
        raise ValueError(f"x must be (Q, C, {b}), got {tuple(x.shape)}")
    expect(x, "x", torch.float32, tuple(x.shape))


def _check_index(index: CompactIndex, x, semiring):
    b = index.b
    _check_call(b, x, semiring)
    if semiring != index.semiring:
        raise ValueError(f"the index leaves out {index.semiring!r}'s "
                         f"identity; the call asks for {semiring!r}")
    expect(index.row_ptr, "row_ptr", torch.int32, (index.r * b + 1,))
    expect(index.pairs, "pairs", torch.int32, (index.pairs.shape[0], 2))
    expect(index.long_rows, "long_rows", torch.int32,
           (len(index.long_host),))
    return index.r, b, x.shape[1], x.shape[0]


def _rows_args(index: CompactIndex):
    """The C launchers' leading arguments: the index's rows."""
    return (index.row_ptr.data_ptr(), index.pairs.data_ptr(),
            index.long_rows.data_ptr(), len(index.long_host),
            index.row_base, LONG_ROW)


def check_knobs(block_size: int, rows_per_step: int = 1) -> None:
    """Raise unless the compacted kernels can launch these knobs: 1..32
    warps a block, at least one row a thread."""
    if (not isinstance(block_size, int) or isinstance(block_size, bool)
            or not 1 <= block_size <= MAX_WARPS):
        raise ValueError(f"block_size (warps a thread block) must be an int "
                         f"in 1..{MAX_WARPS}, got {block_size!r}")
    if (not isinstance(rows_per_step, int) or isinstance(rows_per_step, bool)
            or rows_per_step < 1):
        raise ValueError(f"rows_per_step must be an int >= 1, got "
                         f"{rows_per_step!r}")


def _check_plan(vals, cols, nnz, x, semiring):
    if vals.dim() != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (R, K, B, B), got {tuple(vals.shape)}")
    r, k, b, _ = vals.shape
    _check_call(b, x, semiring)
    expect(vals, "vals", torch.float32, (r, k, b, b))
    expect(cols, "cols", torch.int32, (r, k))
    expect(nnz, "nnz", torch.int32, (r,))
    return r, k, b, x.shape[1], x.shape[0]


def bsr_spmv(block_vals, block_cols, block_nnz, x,
             semiring: str = "plus_times",
             index: CompactIndex | None = None,
             block_size: int = DEFAULT_BLOCK_SIZE,
             rows_per_step: int = DEFAULT_ROWS_PER_STEP) -> torch.Tensor:
    """y[q,r,i] = ⊕_{k<nnz[r], j} vals[r,k,i,j] ⊗ x[q, cols[r,k], j].

    x is (Q, C, B), or (C, B) for one query (then y is (R, B)).  On CUDA
    tensors the semiring must be one of the four built-ins.  Given the
    plan's ``index`` (``build_compact_index``) the call takes the
    compacted route, which reads the index alone, launched with
    ``block_size`` warps a block and ``rows_per_step`` rows a thread;
    without it the ELL route."""
    check_knobs(block_size, rows_per_step)
    if index is not None:
        return _spmv_compact(index, x, semiring, block_size, rows_per_step)
    if on_cpu(block_vals, block_cols, block_nnz, x):
        return ref.bsr_spmv_ref(block_vals, block_cols, block_nnz, x,
                                semiring)
    single = x.dim() == 2
    xq = x[None] if single else x
    r, k, b, c, q = _check_plan(block_vals, block_cols, block_nnz, xq,
                                semiring)
    y = torch.empty((q, r, b), dtype=torch.float32, device=x.device)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bsr_spmv_launch(
            block_vals.data_ptr(), block_cols.data_ptr(),
            block_nnz.data_ptr(), xq.data_ptr(), y.data_ptr(), r, k, c, b,
            q, SEMIRING_CODES[semiring], stream)
    LIBRARY.check(rc, "bsr_spmv")
    count_launch("bsr_spmv")
    return y[0] if single else y


def _spmv_compact(index: CompactIndex, x, semiring, block_size,
                  rows_per_step):
    if on_cpu(index.row_ptr, index.pairs, index.long_rows, x):
        return ref.bsr_spmv_compact_ref(index, x, semiring)
    single = x.dim() == 2
    xq = x[None] if single else x
    r, b, c, q = _check_index(index, xq, semiring)
    y = torch.empty((q, r, b), dtype=torch.float32, device=x.device)
    lib = LIBRARY_COMPACT.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bsr_spmv_compact_launch(
            *_rows_args(index), xq.data_ptr(), y.data_ptr(), r * b, c, b, q,
            SEMIRING_CODES[semiring], block_size, rows_per_step, stream)
    LIBRARY_COMPACT.check(rc, "bsr_spmv_compact")
    count_launch("bsr_spmv_compact")
    return y[0] if single else y


def _host_f32(v) -> float:
    """A float32 scalar as a Python float, exactly (0-d CPU tensors and
    numbers; a CUDA scalar would cost a device sync, so it is refused)."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            raise ValueError("apply-rule scalars must be CPU scalars")
        return float(v.to(torch.float32))
    return float(torch.tensor(v, dtype=torch.float32))


def bsr_spmv_fused(block_vals, block_cols, block_nnz, x, xg, valid,
                   act_rows, damping, tol, inv_n,
                   semiring: str = "min_plus", apply_kind: str = "relax",
                   index: CompactIndex | None = None,
                   block_size: int = DEFAULT_BLOCK_SIZE):
    """One fused frontier-masked sweep over the rows in ``act_rows``.

    Args:
      x: (Q, C, B) full source values, read-only for the whole launch.
      xg: (Q, R, B) current values of THESE rows (``x`` itself for the
        sync engine, the group's rows for the async engine).
      valid: (R, B) bool; act_rows: (Q, R) bool.
      damping/tol/inv_n: float32 scalars (0-d CPU tensors or numbers).
    Returns:
      x_new (Q, R, B) — a new buffer: active rows relaxed, the others
      copied from xg bitwise; changed (Q, R) bool; conv (Q,) bool, the
      any-changed flag.  A 2-D x drops the query axis throughout.
    Given ``index`` (the index of THESE rows, e.g. ``plan_index.rows(sl)``)
    the call takes the compacted route, as ``bsr_spmv`` does, with
    ``block_size`` warps a block and one row a thread.
    """
    check_knobs(block_size)
    if index is not None:
        return _fused_compact(index, x, xg, valid, act_rows, damping, tol,
                              inv_n, semiring, apply_kind, block_size)
    if on_cpu(block_vals, block_cols, block_nnz, x, xg, valid, act_rows):
        return ref.bsr_spmv_fused_ref(
            block_vals, block_cols, block_nnz, x, xg, valid, act_rows,
            damping, tol, inv_n, semiring, apply_kind)
    _check_rule(apply_kind)
    single = x.dim() == 2
    if single:
        x, xg, act_rows = x[None], xg[None], act_rows[None]
    r, k, b, c, q = _check_plan(block_vals, block_cols, block_nnz, x,
                                semiring)
    x_new, changed, conv = _fused_outputs(xg, valid, act_rows, r, b, q)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bsr_spmv_fused_launch(
            block_vals.data_ptr(), block_cols.data_ptr(),
            block_nnz.data_ptr(), x.data_ptr(), xg.data_ptr(),
            valid.data_ptr(), act_rows.data_ptr(), _host_f32(damping),
            _host_f32(tol), _host_f32(inv_n), x_new.data_ptr(),
            changed.data_ptr(), conv.data_ptr(), r, k, c, b, q,
            SEMIRING_CODES[semiring], RULE_CODES[apply_kind], stream)
    LIBRARY.check(rc, "bsr_spmv_fused")
    count_launch("bsr_spmv_fused")
    return _fused_result(x_new, changed, conv, single)


def _check_rule(apply_kind):
    if apply_kind not in RULE_CODES:
        raise ValueError(f"the fused kernel implements {sorted(RULE_CODES)}, "
                         f"not {apply_kind!r}")


def _fused_outputs(xg, valid, act_rows, r, b, q):
    """Checks the fused kernels' row inputs; x_new as a copy of xg, zeroed
    changed bits and conv words."""
    expect(xg, "xg", torch.float32, (q, r, b))
    expect(valid, "valid", torch.bool, (r, b))
    expect(act_rows, "act_rows", torch.bool, (q, r))
    return (xg.clone(),
            torch.zeros((q, r), dtype=torch.bool, device=xg.device),
            torch.zeros((q,), dtype=torch.int32, device=xg.device))


def _fused_result(x_new, changed, conv, single):
    conv = conv != 0
    if single:
        return x_new[0], changed[0], conv[0]
    return x_new, changed, conv


def _fused_compact(index: CompactIndex, x, xg, valid, act_rows, damping,
                   tol, inv_n, semiring, apply_kind, block_size):
    if on_cpu(index.row_ptr, index.pairs, index.long_rows, x, xg, valid,
              act_rows):
        return ref.bsr_spmv_fused_compact_ref(
            index, x, xg, valid, act_rows, damping, tol, inv_n, semiring,
            apply_kind)
    _check_rule(apply_kind)
    single = x.dim() == 2
    if single:
        x, xg, act_rows = x[None], xg[None], act_rows[None]
    r, b, c, q = _check_index(index, x, semiring)
    x_new, changed, conv = _fused_outputs(xg, valid, act_rows, r, b, q)
    lib = LIBRARY_COMPACT.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bsr_spmv_fused_compact_launch(
            *_rows_args(index), x.data_ptr(), xg.data_ptr(),
            valid.data_ptr(), act_rows.data_ptr(), _host_f32(damping),
            _host_f32(tol), _host_f32(inv_n),
            x_new.data_ptr(), changed.data_ptr(), conv.data_ptr(), r * b, c,
            b, q, SEMIRING_CODES[semiring], RULE_CODES[apply_kind],
            block_size, stream)
    LIBRARY_COMPACT.check(rc, "bsr_spmv_fused_compact")
    count_launch("bsr_spmv_fused_compact")
    return _fused_result(x_new, changed, conv, single)
