"""Hand-written CUDA WKV6 recurrence: build at first use, bind, check, launch.

``wkv6`` replaces the JAX package's Pallas kernel ``wkv6``
(``src/repro/kernels/wkv6.py``) with its signature; ``wkv6_heads`` is the
form the RWKV-6 model calls, in the model's (B, T, H, hs) layout with one
u per head.  The CUDA source is ``csrc/wkv6.cu``; its head states the work
split, the bound on the H100 (operations: 2.73 GFLOP, 40.7 us at the f32
CUDA-core peak for one rwkv6-1.6b prefill layer of 4 x 1024 tokens) and
what the simple design leaves on the table.

The Pallas kernel's ``chunk`` (time steps per grid step, sized for VMEM)
and ``interpret`` have no counterpart: the CUDA kernel stages its own
chunk of steps in shared memory, and on the CPU the plain version runs.

Device rule.  Given CPU tensors a wrapper runs the plain torch version
(``ref.wkv6_ref``, ``ref.wkv6_heads_ref``); given CUDA tensors it launches
the kernel or raises.  There is no fallback from a failed build or launch.

Build.  ``kernels/cuda_lib.py`` compiles the source with nvcc for sm_90a
and ``-fmad=false`` (every product and sum then rounds as the plain
version's torch ops, which repeat the kernel's order: the two agree bit
for bit) into ``build/kernels/libwkv6-<hash>.so`` the first time the
kernel is launched.

The wrappers add one to ``launch_counts["wkv6"]`` where they launch the
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from .cuda_lib import BASE_FLAGS, CudaLibrary, expect, on_cpu

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_SIZE = 128

launch_counts = {"wkv6": 0}


def reset_launch_counts() -> None:
    launch_counts["wkv6"] = 0


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [
        p, p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i,
        i, i, p]
    lib.wkv6_launch.restype = i


LIBRARY = CudaLibrary("wkv6", SOURCE, NVCC_FLAGS, _bind, "wkv6_error_string")


def _check_shapes(r, k, v, w, u, s0):
    """(B, T, H, hs) of model-layout inputs; raises on any mismatch."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, hs), got {tuple(r.shape)}")
    b, t, h, hs = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} must have r's shape {tuple(r.shape)}, "
                             f"got {tuple(x.shape)}")
    if tuple(u.shape) != (h, hs):
        raise ValueError(f"u must be (H, hs) = ({h}, {hs}), got "
                         f"{tuple(u.shape)}")
    if tuple(s0.shape) != (b, h, hs, hs):
        raise ValueError(f"the state must be (B, H, hs, hs) = ({b}, {h}, "
                         f"{hs}, {hs}), got {tuple(s0.shape)}")
    return b, t, h, hs


def _launch(r, k, v, w, u, s0, s_out) -> torch.Tensor:
    """Launch on CUDA tensors in the model's layout; s_out may be s0."""
    b, t, h, hs = r.shape
    if r.dtype not in DTYPE_CODES or any(x.dtype != r.dtype
                                         for x in (k, v, w)):
        raise TypeError(
            f"the CUDA kernel takes {sorted(map(str, DTYPE_CODES))} for r, "
            f"k, v and w alike; got {r.dtype}, {k.dtype}, {v.dtype}, "
            f"{w.dtype}")
    if hs > MAX_HEAD_SIZE:
        raise ValueError(f"head size {hs} > {MAX_HEAD_SIZE}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    expect(s0, "s0", torch.float32, (b, h, hs, hs))
    expect(s_out, "s_out", torch.float32, (b, h, hs, hs))
    if not u.is_floating_point():
        raise TypeError(f"u must be a float tensor, got {u.dtype}")
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty((b, t, h, hs), dtype=r.dtype, device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *(x.stride(i) for x in (r, k, v, w, y) for i in range(3)))
    lib = LIBRARY.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            strides, b, t, h, hs, DTYPE_CODES[r.dtype], stream)
    LIBRARY.check(rc, "wkv6")
    launch_counts["wkv6"] += 1
    return y


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: torch.Tensor) -> torch.Tensor:
    """The multi-head recurrence of the RWKV-6 model, updating ``state``.

    r, k, v, w: (B, T, H, hs), one dtype (bf16 or f32 on the card), any
    strides with a contiguous last dim; u (H, hs), any float dtype (read
    as f32: an f32 contiguous u, as the model's ``RWKV.u_rounded`` gives,
    is passed with no copy); state (B, H, hs, hs) f32, contiguous, keyed
    [k dim, v dim]:
    read as the initial state and overwritten with the final one, in
    place.  Returns y (B, T, H, hs) in r's dtype.
    """
    _check_shapes(r, k, v, w, u, state)
    if on_cpu(r, k, v, w, u, state):
        y, s = ref.wkv6_heads_ref(r, k, v, w, u, state)
        state.copy_(s)
        return y
    return _launch(r, k, v, w, u, state, state)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The JAX package's ``wkv6``: r, k, v, w (BH, T, hs); u (hs,) shared
    by every row; s0 (BH, hs, hs), any float dtype.  Returns (y (BH, T,
    hs) in r's dtype, s_final (BH, hs, hs) f32); ``s0`` is not written."""
    if r.dim() != 3:
        raise ValueError(f"r must be (BH, T, hs), got {tuple(r.shape)}")
    if u.dim() != 1 or s0.dim() != 3:
        raise ValueError(f"u must be (hs,) and s0 (BH, hs, hs); got "
                         f"{tuple(u.shape)}, {tuple(s0.shape)}")
    heads = [x[:, :, None] for x in (r, k, v, w)]
    _check_shapes(*heads, u[None], s0[:, None])
    if on_cpu(r, k, v, w, u, s0):
        return ref.wkv6_ref(r, k, v, w, u, s0)
    s0 = s0.to(torch.float32).contiguous()  # read only: a copy at most
    s_out = torch.empty_like(s0)
    y = _launch(*heads, u[None], s0[:, None], s_out[:, None])
    return y[:, :, 0], s_out
