"""Hand-written CUDA SpMV kernels: build at first use, bind, check, launch.

``bsr_spmv`` replaces the JAX package's Pallas kernel ``bsr_spmv`` and
``bsr_spmv_fused`` its Pallas kernel ``bsr_spmv_fused`` (both in
``src/repro/kernels/bsr_spmv.py``).  The CUDA source is
``csrc/bsr_spmv.cu``; its head states the work split, the bound on the
H100 (bytes: about 1.4 GB, 0.42 ms at 3.35 TB/s for one unfused sweep of
the full-scale CA plan at b=16) and what the simple design leaves on the
table.

Device rule.  A wrapper given CPU tensors runs the plain torch version in
``kernels/ref.py``; given CUDA tensors it launches its kernel or raises.
There is no fallback from a failed build or launch.

Build.  ``kernels/cuda_lib.py`` compiles the source with nvcc for sm_90a
and ``-fmad=false`` (bit equality with the plain versions) into
``build/kernels/libbsr_spmv-<hash>.so`` the first time a kernel is
launched, and loads it with ``ctypes``; the C functions take raw pointers
and the current stream and return the CUDA error code.

Each wrapper adds one to ``launch_counts[name]`` where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from .cuda_lib import BASE_FLAGS, CudaLibrary, expect, on_cpu

SEMIRING_CODES = {"plus_times": 0, "min_plus": 1, "max_min": 2,
                  "min_select": 3}
RULE_CODES = {"relax": 0, "pagerank": 1, "pagerank_delta": 2, "kcore": 3,
              "identity": 4}
BLOCK_SIZES = (8, 16, 32)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "bsr_spmv.cu"
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)

launch_counts = {"bsr_spmv": 0, "bsr_spmv_fused": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bsr_spmv_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.bsr_spmv_launch.restype = i
    lib.bsr_spmv_fused_launch.argtypes = [
        p, p, p, p, p, p, p, f, f, f, p, p, p, i, i, i, i, i, i, i, p]
    lib.bsr_spmv_fused_launch.restype = i


LIBRARY = CudaLibrary("bsr_spmv", SOURCE, NVCC_FLAGS, _bind,
                      "bsr_error_string")


def _check_plan(vals, cols, nnz, x, semiring):
    if vals.dim() != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (R, K, B, B), got {tuple(vals.shape)}")
    r, k, b, _ = vals.shape
    if b not in BLOCK_SIZES:
        raise ValueError(f"block size {b} not in {BLOCK_SIZES}")
    if semiring not in SEMIRING_CODES:
        raise ValueError(f"the CUDA kernels implement {sorted(SEMIRING_CODES)}, "
                         f"not {semiring!r}")
    if x.dim() != 3 or x.shape[2] != b:
        raise ValueError(f"x must be (Q, C, {b}), got {tuple(x.shape)}")
    expect(vals, "vals", torch.float32, (r, k, b, b))
    expect(cols, "cols", torch.int32, (r, k))
    expect(nnz, "nnz", torch.int32, (r,))
    expect(x, "x", torch.float32, tuple(x.shape))
    return r, k, b, x.shape[1], x.shape[0]


def bsr_spmv(block_vals, block_cols, block_nnz, x,
             semiring: str = "plus_times") -> torch.Tensor:
    """y[q,r,i] = ⊕_{k<nnz[r], j} vals[r,k,i,j] ⊗ x[q, cols[r,k], j].

    x is (Q, C, B), or (C, B) for one query (then y is (R, B)).  On CUDA
    tensors the semiring must be one of the four built-ins."""
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
    launch_counts["bsr_spmv"] += 1
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
                   semiring: str = "min_plus", apply_kind: str = "relax"):
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
    """
    if on_cpu(block_vals, block_cols, block_nnz, x, xg, valid, act_rows):
        return ref.bsr_spmv_fused_ref(
            block_vals, block_cols, block_nnz, x, xg, valid, act_rows,
            damping, tol, inv_n, semiring, apply_kind)
    if apply_kind not in RULE_CODES:
        raise ValueError(f"the fused kernel implements {sorted(RULE_CODES)}, "
                         f"not {apply_kind!r}")
    single = x.dim() == 2
    if single:
        x, xg, act_rows = x[None], xg[None], act_rows[None]
    r, k, b, c, q = _check_plan(block_vals, block_cols, block_nnz, x,
                                semiring)
    expect(xg, "xg", torch.float32, (q, r, b))
    expect(valid, "valid", torch.bool, (r, b))
    expect(act_rows, "act_rows", torch.bool, (q, r))
    x_new = xg.clone()
    changed = torch.zeros((q, r), dtype=torch.bool, device=x.device)
    conv = torch.zeros((q,), dtype=torch.int32, device=x.device)
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
    launch_counts["bsr_spmv_fused"] += 1
    conv = conv != 0
    if single:
        return x_new[0], changed[0], conv[0]
    return x_new, changed, conv
