"""Hand-written CUDA flash attention: build at first use, bind, check, launch.

``flash_attention`` replaces the JAX package's Pallas kernel
``flash_attention`` (``src/repro/kernels/flash_attention.py``).  The CUDA
source is ``csrc/flash_attention.cu``; its head states the work split, the
bound on the H100 (operations: 17.2 GFLOP, 17.4 us at the bf16 tensor-core
peak for one granite-3-2b prefill wave of 4 x 1024 tokens) and what the
simple design leaves on the table.

Device rule.  Given CPU tensors the wrapper runs the plain torch version
(``ref.attention_ref``: ``mha_ref``, or ``mha_chunked`` from S = 16384
on); given CUDA tensors it launches the kernel or raises.  There is no
fallback from a failed build or launch.

Build.  ``kernels/cuda_lib.py`` compiles the source with nvcc for sm_90a
into its own ``build/kernels/libflash_attention-<hash>.so`` (no
``-fmad=false``: nothing here is held bit for bit) the first time the
kernel is launched.

The wrapper adds one to ``launch_counts["flash_attention"]`` where it
launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from . import ref
from .cuda_lib import BASE_FLAGS, CudaLibrary, on_cpu

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "flash_attention.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GRID_Y = 65535  # B * H blocks along the grid's y axis

launch_counts = {"flash_attention": 0}


def reset_launch_counts() -> None:
    launch_counts["flash_attention"] = 0


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, i, i,
        ctypes.c_float, i, p]
    lib.flash_attention_launch.restype = i


LIBRARY = CudaLibrary("flash_attention", SOURCE, BASE_FLAGS, _bind,
                      "flash_error_string")


def build() -> pathlib.Path:
    """Compile the attention library unless it exists; returns its path."""
    return LIBRARY.build()


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != (b, hkv, s, d):
        raise ValueError(
            f"k and v must be (B, Hkv, S, D) = ({b}, Hkv, {s}, {d}) with "
            f"S == Skv and D_v == D; got {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"kv heads {hkv} must divide heads {h}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(
            f"the CUDA kernel takes {sorted(map(str, DTYPE_CODES))} for q, "
            f"k and v alike; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} > {MAX_GRID_Y}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    return b, h, hkv, s, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """o = softmax(q kᵀ · scale, masked) v, per head.

    q (B, H, S, D); k, v (B, Hkv, S, D) with Hkv dividing H: query head h
    reads kv head h // (H / Hkv).  Any strides with a contiguous last dim.
    ``window`` (≥ 1) keeps keys with kpos > qpos - window; keys at or past
    S never attend.  Returns o (B, H, S, D) in q's dtype; on the card its
    memory is laid out as (B, S, H, D), so ``o.transpose(1, 2)`` is
    contiguous.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if on_cpu(q, k, v):
        return ref.attention_ref(q, k, v, causal, window, scale)
    b, h, hkv, s, d = _check(q, k, v)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o = torch.empty((b, s, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            b, h, hkv, s, d, int(bool(causal)), window or 0, float(scale),
            DTYPE_CODES[q.dtype], stream)
    LIBRARY.check(rc, "flash_attention")
    launch_counts["flash_attention"] += 1
    return o
