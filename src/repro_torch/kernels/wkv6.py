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

Training.  ``wkv6_train`` is an autograd Function with hand-written
backwards; the JAX package has no kernel here: it differentiates its
``lax.scan`` by XLA.  The forward is the routed kernel above, writing a
fresh final state; nothing is updated in place.  The backward takes the
forward's route:

- ``"chunked"``: ``csrc/wkv6_backward_chunked.cu``, the gradient of the
  chunked form in its blocking on the tensor cores (a state pass, then
  sub-chunks of 16 steps from the last; no -fmad=false); its plain
  version ``ref.wkv6_chunked_heads_backward_ref`` repeats its algebra and
  operand splits, so the two differ only in the order of the sums;
- ``"recurrent"``: ``csrc/wkv6_backward.cu``, step by step on the CUDA
  cores (built with ``-fmad=false``; its plain version
  ``ref.wkv6_heads_backward_ref`` agrees bit for bit).

A failed build or launch raises; a chunked-route input never drops to
the recurrent kernel.  The backward adds one to
``launch_counts["wkv6_backward"]`` and to the route's own count
(``wkv6_backward_recurrent`` or ``wkv6_backward_chunked``) where it
launches (each kernel and the batch sum of du behind it, one call).  On
CPU tensors the same Function runs ``ref.wkv6_heads_ref`` forward and
``ref.wkv6_heads_backward_ref`` backward whatever the route, so the CPU
tests check the recurrent kernel's very gradient, and the chunked one is
held to its plain version by the card checks and tests.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from . import cost
from .cuda_lib import BASE_FLAGS, CudaLibrary, expect, on_cpu

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "wkv6.cu"
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_SIZE = 128
CHUNKED_HEAD_SIZE = 64   # rwkv6's head size, the chunked kernel's only one
CHUNKED_MIN_T = 128      # below it (decode steps; the recurrent kernel's
                         # own card checks, T <= 100) the recurrence runs

BACKWARD_MAX_HEAD_SIZE = 64

launch_counts = {"wkv6": 0, "wkv6_recurrent": 0, "wkv6_chunked": 0,
                 "wkv6_backward": 0, "wkv6_backward_recurrent": 0,
                 "wkv6_backward_chunked": 0}


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


def _bind_backward(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_backward_launch.argtypes = [p] * 17 + [i] * 5 + [p]
    lib.wkv6_backward_launch.restype = i
    lib.wkv6_backward_scratch_steps.argtypes = []
    lib.wkv6_backward_scratch_steps.restype = i


def _bind_backward_chunked(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_backward_chunked_launch.argtypes = [p] * 16 + [i] * 4 + [p]
    lib.wkv6_backward_chunked_launch.restype = i
    lib.wkv6_backward_chunked_scratch_steps.argtypes = []
    lib.wkv6_backward_chunked_scratch_steps.restype = i


LIBRARY = CudaLibrary("wkv6", SOURCE, NVCC_FLAGS, _bind, "wkv6_error_string")
LIBRARY_CHUNKED = CudaLibrary("wkv6_chunked", CSRC / "wkv6_chunked.cu",
                              BASE_FLAGS, _bind_chunked,
                              "wkv6_chunked_error_string")
LIBRARY_BACKWARD = CudaLibrary("wkv6_backward", CSRC / "wkv6_backward.cu",
                               NVCC_FLAGS, _bind_backward,
                               "wkv6_backward_error_string")
LIBRARY_BACKWARD_CHUNKED = CudaLibrary(
    "wkv6_backward_chunked", CSRC / "wkv6_backward_chunked.cu", BASE_FLAGS,
    _bind_backward_chunked, "wkv6_backward_chunked_error_string")


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
    if r.device.type == "meta":
        return _on_meta(r)
    if on_cpu(r, k, v, w, u, state):
        y, s = ref.wkv6_heads_ref(r, k, v, w, u, state)
        state.copy_(s)
        return y
    return _launch(r, k, v, w, u, state, state)


def _on_meta(r):
    """The routed kernel's stand-in on meta tensors (the dry run): its
    output and its work noted (``cost``); the state is written in place,
    which on meta is nothing."""
    b, t, h, hs = r.shape
    path = route(r.dtype, t, hs)
    cost.note("wkv6_" + path, cost.wkv6_ops(b, t, h, hs, path),
              cost.wkv6_bytes(b, t, h, hs, r.element_size()))
    return torch.empty_like(r)


def _on_meta_backward(r, k, v, w, u, s0, dy, ds_last):
    """The routed backward kernel's stand-in on meta: its gradients and
    scratch (the chunked kernel's states at every sub-chunk and du's
    partial sums) made, its work noted."""
    b, t, h, hs = r.shape
    path = route(r.dtype, t, hs)
    grads = (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
             torch.empty_like(w), torch.empty((h, hs), dtype=torch.float32,
                                              device=r.device),
             torch.empty_like(s0))
    if path == "chunked":     # live while the kernel runs, then freed
        scratch = (torch.empty(b * h * -(-t // cost.CHUNK) * hs * hs,
                               dtype=torch.float32, device=r.device),
                   torch.empty((b, h, hs), dtype=torch.float32,
                               device=r.device))
        del scratch
    cost.note("wkv6_backward_" + path,
              cost.wkv6_backward_ops(b, t, h, hs, path),
              cost.wkv6_backward_bytes(b, t, h, hs, r.element_size()))
    return grads


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


def _launch_backward(r, k, v, w, u, s0, dy, ds_last):
    """The backward kernel on CUDA tensors: (dr, dk, dv, dw) in r's
    dtype, du (H, hs) f32, ds0 (B, H, hs, hs) f32."""
    b, t, h, hs = r.shape
    if r.dtype not in DTYPE_CODES or any(x.dtype != r.dtype
                                         for x in (k, v, w, dy)):
        raise TypeError(
            f"the backward kernel takes {sorted(map(str, DTYPE_CODES))} for "
            f"r, k, v, w and dy alike; got {r.dtype}, {k.dtype}, {v.dtype}, "
            f"{w.dtype}, {dy.dtype}")
    if hs > BACKWARD_MAX_HEAD_SIZE:
        raise ValueError(f"the backward kernel takes head sizes up to "
                         f"{BACKWARD_MAX_HEAD_SIZE}, got {hs}")
    r, k, v, w, dy = (x.contiguous() for x in (r, k, v, w, dy))
    expect(dy, "dy", r.dtype, r.shape)
    for name, x in (("s0", s0), ("ds_last", ds_last)):
        expect(x, name, torch.float32, (b, h, hs, hs))
    expect(u, "u", torch.float32, (h, hs))
    lib = LIBRARY_BACKWARD.load()
    steps = lib.wkv6_backward_scratch_steps()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((h, hs), dtype=torch.float32, device=r.device)
    du_part = torch.empty((b, h, hs), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0)
    ckpt = torch.empty(b * h * -(-t // steps) * hs * hs,
                       dtype=torch.float32, device=r.device)
    buf = torch.empty(b * h * steps * hs * hs, dtype=torch.float32,
                      device=r.device)
    ptrs = [x.data_ptr() for x in (r, k, v, w, dy, u, s0, ds_last, dr, dk,
                                   dv, dw, du, du_part, ds0, ckpt, buf)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wkv6_backward_launch(*ptrs, b, t, h, hs,
                                      DTYPE_CODES[r.dtype], stream)
    LIBRARY_BACKWARD.check(rc, "wkv6_backward")
    launch_counts["wkv6_backward"] += 1
    launch_counts["wkv6_backward_recurrent"] += 1
    return dr, dk, dv, dw, du, ds0


def _launch_backward_chunked(r, k, v, w, u, s0, dy, ds_last):
    """The chunked backward kernel on CUDA tensors (bf16 r, k, v, w, dy at
    head size 64): (dr, dk, dv, dw) bf16, du (H, hs) f32, ds0 (B, H, hs,
    hs) f32.  Its scratch: the state at every sub-chunk's start, ceil(T /
    16)·hs² f32 a (b, h), and du's (B, H, hs) partials."""
    b, t, h, hs = r.shape
    if any(x.dtype != torch.bfloat16 for x in (r, k, v, w, dy)) or \
            hs != CHUNKED_HEAD_SIZE or t < 1:
        raise ValueError(
            f"the chunked backward kernel takes bf16 r, k, v, w and dy at "
            f"head size {CHUNKED_HEAD_SIZE} and T >= 1; got {r.dtype}, "
            f"{k.dtype}, {v.dtype}, {w.dtype}, {dy.dtype}, hs {hs}, T {t}")
    r, k, v, w, dy = (x.contiguous() for x in (r, k, v, w, dy))
    expect(dy, "dy", r.dtype, r.shape)
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("dy", dy)):
        if x.data_ptr() % 16:
            raise ValueError(f"the chunked backward kernel reads 16-byte "
                             f"rows: {name} must start 16-byte aligned")
    for name, x in (("s0", s0), ("ds_last", ds_last)):
        expect(x, name, torch.float32, (b, h, hs, hs))
    expect(u, "u", torch.float32, (h, hs))
    lib = LIBRARY_BACKWARD_CHUNKED.load()
    steps = lib.wkv6_backward_chunked_scratch_steps()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((h, hs), dtype=torch.float32, device=r.device)
    du_part = torch.empty((b, h, hs), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0)
    ckpt = torch.empty(b * h * -(-t // steps) * hs * hs,
                       dtype=torch.float32, device=r.device)
    ptrs = [x.data_ptr() for x in (r, k, v, w, dy, u, s0, ds_last, dr, dk,
                                   dv, dw, du, du_part, ds0, ckpt)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wkv6_backward_chunked_launch(*ptrs, b, t, h, hs, stream)
    LIBRARY_BACKWARD_CHUNKED.check(rc, "wkv6_backward_chunked")
    launch_counts["wkv6_backward"] += 1
    launch_counts["wkv6_backward_chunked"] += 1
    return dr, dk, dv, dw, du, ds0


class _Train(torch.autograd.Function):
    """y and the final state of the recurrence from (r, k, v, w, u, s0),
    and their gradients: the kernels on CUDA tensors, the plain versions
    when ``plain`` (CPU tensors)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, plain):
        ctx.plain = plain
        ctx.save_for_backward(r, k, v, w, u, s0)
        if r.device.type == "meta":
            return _on_meta(r), torch.empty_like(s0)
        if plain:
            return ref.wkv6_heads_ref(r, k, v, w, u, s0)
        s = torch.empty_like(s0)
        return _launch(r, k, v, w, u, s0, s), s

    @staticmethod
    def backward(ctx, dy, ds_last):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy
        ds_last = torch.zeros_like(s0) if ds_last is None else ds_last
        if r.device.type == "meta":
            fn = _on_meta_backward
        elif ctx.plain:
            fn = ref.wkv6_heads_backward_ref
        elif route(r.dtype, r.shape[1], r.shape[3]) == "chunked":
            fn = _launch_backward_chunked
        else:
            fn = _launch_backward
        return (*fn(r, k, v, w, u, s0, dy, ds_last), None)


def wkv6_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The recurrence with a gradient for every input: returns (y (B, T,
    H, hs) in r's dtype, the final state (B, H, hs, hs) f32), writing
    nothing in place.  r, k, v, w (B, T, H, hs), one dtype (bf16 or f32
    on the card); u (H, hs) f32; s0 (B, H, hs, hs) f32, contiguous.  On
    the card the forward launches the routed kernel (``route``; the
    chunked one's alignment rules hold) and the backward that route's
    backward kernel (the recurrent one: head size at most 64)."""
    _check_shapes(r, k, v, w, u, s0)
    for name, x in (("u", u), ("s0", s0)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    return _Train.apply(r, k, v, w, u, s0, on_cpu(r, k, v, w, u, s0))
