"""Hand-written CUDA WKV6 recurrence: route, build at first use, bind,
check, launch.

``wkv6`` replaces the JAX package's Pallas kernel ``wkv6``
(``src/repro/kernels/wkv6.py``) with its signature; ``wkv6_heads`` is the
form the RWKV-6 model calls, in the model's (B, T, H, hs) layout with one
u per head.  Two CUDA kernels compute it, picked by ``route(dtype, t,
hs)`` before any launch:

- ``"chunked"``: bf16 at head size 64 and T >= CHUNKED_MIN_T (the
  rwkv6-1.6b prefill), ``csrc/wkv6_chunked.cu``: the chunked form, matrix
  products over sub-chunks of 16 steps on the tensor cores;
- ``"recurrent"``: everything else (f32, decode steps, short prompts,
  other head sizes), ``csrc/wkv6.cu``: the step-by-step recurrence on the
  CUDA cores.

Each source's head states its work split, its bound on the H100 and what
its design leaves on the table.

The Pallas kernel's ``chunk`` (time steps per grid step, sized for VMEM)
and ``interpret`` have no counterpart: each CUDA kernel stages its own
chunk of steps in shared memory, and on the CPU the plain version runs.

Device rule.  Given CPU tensors a wrapper runs the recurrent plain
version (``ref.wkv6_ref``, ``ref.wkv6_heads_ref``) whatever the dtype and
T; given CUDA tensors it launches the routed kernel or raises.  There is
no fallback from a failed build or launch, nor between the kernels.  The
chunked form's plain version, ``ref.wkv6_chunked_heads_ref``, is what the
chunked kernel is held to; the wrappers never call it.

Build.  ``kernels/cuda_lib.py`` compiles each source with nvcc for sm_90a
into its own ``build/kernels/lib<name>-<hash>.so`` the first time its
kernel is launched: the recurrent one with ``-fmad=false`` (every product
and sum then rounds as the plain version's torch ops, which repeat the
kernel's order: the two agree bit for bit), the chunked one without (its
matrix products sum in the tensor cores' order).

The wrappers add one to ``launch_counts["wkv6"]`` and to the route's own
count (``wkv6_recurrent`` or ``wkv6_chunked``) where they launch a
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from .cuda_lib import BASE_FLAGS, CudaLibrary, expect, on_cpu

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "wkv6.cu"
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_SIZE = 128
CHUNKED_HEAD_SIZE = 64   # rwkv6's head size, the chunked kernel's only one
CHUNKED_MIN_T = 128      # below it (decode steps; the recurrent kernel's
                         # own card checks, T <= 100) the recurrence runs

launch_counts = {"wkv6": 0, "wkv6_recurrent": 0, "wkv6_chunked": 0}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def route(dtype: torch.dtype, t: int, hs: int) -> str:
    """The kernel that takes r, k, v, w of this dtype, T steps and head
    size: ``"chunked"`` for bf16 at hs 64 and T >= 128, else
    ``"recurrent"``."""
    if dtype == torch.bfloat16 and hs == CHUNKED_HEAD_SIZE and \
            t >= CHUNKED_MIN_T:
        return "chunked"
    return "recurrent"


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [
        p, p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i,
        i, i, p]
    lib.wkv6_launch.restype = i


def _bind_chunked(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_chunked_launch.argtypes = [
        p, p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i,
        i, p]
    lib.wkv6_chunked_launch.restype = i


LIBRARY = CudaLibrary("wkv6", SOURCE, NVCC_FLAGS, _bind, "wkv6_error_string")
LIBRARY_CHUNKED = CudaLibrary("wkv6_chunked", CSRC / "wkv6_chunked.cu",
                              BASE_FLAGS, _bind_chunked,
                              "wkv6_chunked_error_string")


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


def _launch(r, k, v, w, u, s0, s_out, path=None) -> torch.Tensor:
    """Launch on CUDA tensors in the model's layout; s_out may be s0.
    ``path`` is ``route(...)``'s pick unless given: the card checks hold
    the recurrent kernel at inputs the route sends to the chunked one."""
    b, t, h, hs = r.shape
    if r.dtype not in DTYPE_CODES or any(x.dtype != r.dtype
                                         for x in (k, v, w)):
        raise TypeError(
            f"the CUDA kernel takes {sorted(map(str, DTYPE_CODES))} for r, "
            f"k, v and w alike; got {r.dtype}, {k.dtype}, {v.dtype}, "
            f"{w.dtype}")
    if hs > MAX_HEAD_SIZE:
        raise ValueError(f"head size {hs} > {MAX_HEAD_SIZE}")
    path = path or route(r.dtype, t, hs)
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if path == "chunked" and (x.data_ptr() % 16 or any(
                x.stride(i) % 8 for i in range(3))):
            raise ValueError(f"the chunked kernel reads 16-byte rows: {name}"
                             f" needs a 16-byte aligned start and strides "
                             f"in multiples of 8, got {x.stride()}")
    if path == "chunked" and (r.dtype != torch.bfloat16
                              or hs != CHUNKED_HEAD_SIZE):
        raise ValueError(f"the chunked kernel takes bf16 at head size "
                         f"{CHUNKED_HEAD_SIZE}; got {r.dtype}, {hs}")
    expect(s0, "s0", torch.float32, (b, h, hs, hs))
    expect(s_out, "s_out", torch.float32, (b, h, hs, hs))
    if not u.is_floating_point():
        raise TypeError(f"u must be a float tensor, got {u.dtype}")
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty((b, t, h, hs), dtype=r.dtype, device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *(x.stride(i) for x in (r, k, v, w, y) for i in range(3)))
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr())
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "chunked":
            rc = LIBRARY_CHUNKED.load().wkv6_chunked_launch(
                *ptrs, strides, b, t, h, hs, stream)
        else:
            rc = LIBRARY.load().wkv6_launch(
                *ptrs, strides, b, t, h, hs, DTYPE_CODES[r.dtype], stream)
    (LIBRARY_CHUNKED if path == "chunked" else LIBRARY).check(
        rc, "wkv6_" + path)
    launch_counts["wkv6"] += 1
    launch_counts["wkv6_" + path] += 1
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
    place.  Returns y (B, T, H, hs) in r's dtype.  On the card, inputs
    that ``route`` sends to the chunked kernel (bf16, hs 64, T >= 128)
    must also start 16-byte aligned with b, t and h strides in multiples
    of 8, as the model's contiguous projections are; it raises otherwise.
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
