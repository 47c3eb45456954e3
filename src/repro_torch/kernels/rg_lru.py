"""Hand-written CUDA RG-LRU scan, forward and backward: build at first use,
bind, check, launch.

``rg_lru_scan(a, g, h0)`` computes Griffin's recurrence h_t = a_t·h_{t−1}
+ g_t over t and is an autograd Function whose forward and backward are
the two kernels of ``csrc/rg_lru.cu``.  It replaces no Pallas kernel: the
JAX package runs the scan as a ``lax.scan`` in ``models/griffin.py``'s
``_rg_lru`` and trains through XLA's autodiff of it.  The port's training
path (``models/griffin.py``) calls it; serving keeps its step loop.

Device rule.  Given CPU tensors the Function runs the plain versions
(``ref.rg_lru_scan_ref`` forward, ``ref.rg_lru_scan_backward_ref``
backward); given CUDA tensors it launches the kernels or raises.  There
is no fallback from a failed build or launch.

Build.  ``kernels/cuda_lib.py`` compiles the source with nvcc for sm_90a
and ``-fmad=false`` (each product and sum then rounds as the plain
versions' torch ops, which repeat the kernels' order: the two agree bit
for bit) into ``build/kernels/librg_lru-<hash>.so`` the first time a
kernel is launched.

The wrapper adds one to ``launch_counts["rg_lru"]`` where it launches
the forward kernel and to ``launch_counts["rg_lru_backward"]`` where it
launches the backward one, and nowhere else.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from .cuda_lib import BASE_FLAGS, CudaLibrary, expect, on_cpu

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rg_lru.cu"
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)

launch_counts = {"rg_lru": 0, "rg_lru_backward": 0}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rg_lru_forward_launch.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.rg_lru_forward_launch.restype = i
    lib.rg_lru_backward_launch.argtypes = [p] * 8 + [i] * 3 + [p]
    lib.rg_lru_backward_launch.restype = i


LIBRARY = CudaLibrary("rg_lru", SOURCE, NVCC_FLAGS, _bind,
                      "rg_lru_error_string")


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _launch(a, g, h0):
    """The forward kernel: (h (B, S, ld), h_last (B, ld)), f32."""
    b, s, ld = a.shape
    expect(a, "a", torch.float32, (b, s, ld))
    expect(g, "g", torch.float32, (b, s, ld))
    expect(h0, "h0", torch.float32, (b, ld))
    h_all = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    rc = LIBRARY.load().rg_lru_forward_launch(
        a.data_ptr(), g.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
        h_last.data_ptr(), b, s, ld, _stream(a.device))
    LIBRARY.check(rc, "rg_lru")
    launch_counts["rg_lru"] += 1
    return h_all, h_last


def _launch_backward(a, h0, h_all, dh, dh_last):
    """The backward kernel: (da, dg (B, S, ld), dh0 (B, ld)), f32."""
    b, s, ld = a.shape
    dh = dh.contiguous()
    for name, x in (("a", a), ("h_all", h_all), ("dh", dh)):
        expect(x, name, torch.float32, (b, s, ld))
    for name, x in (("h0", h0), ("dh_last", dh_last)):
        expect(x, name, torch.float32, (b, ld))
    da, dg = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    rc = LIBRARY.load().rg_lru_backward_launch(
        a.data_ptr(), h0.data_ptr(), h_all.data_ptr(), dh.data_ptr(),
        dh_last.data_ptr(), da.data_ptr(), dg.data_ptr(), dh0.data_ptr(),
        b, s, ld, _stream(a.device))
    LIBRARY.check(rc, "rg_lru_backward")
    launch_counts["rg_lru_backward"] += 1
    return da, dg, dh0


class _Scan(torch.autograd.Function):
    """(h for every step, h_last) from (a, g, h0), and the gradients of
    all three: the kernels on CUDA tensors, the plain versions when
    ``plain`` (CPU tensors)."""

    @staticmethod
    def forward(ctx, a, g, h0, plain):
        h_all, h_last = (ref.rg_lru_scan_ref if plain else _launch)(a, g, h0)
        ctx.plain = plain
        ctx.save_for_backward(a, h0, h_all)
        return h_all, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h0, h_all = ctx.saved_tensors
        dh = torch.zeros_like(a) if dh is None else dh
        dh_last = torch.zeros_like(h0) if dh_last is None else dh_last
        fn = ref.rg_lru_scan_backward_ref if ctx.plain else _launch_backward
        return (*fn(a, h0, h_all, dh, dh_last), None)


def rg_lru_scan(a: torch.Tensor, g: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t·h_{t−1} + g_t from h0, with a gradient for a, g and h0.
    a, g (B, S, ld) f32, contiguous on the card; h0 (B, ld) f32.  Returns
    (h (B, S, ld), every step's, h_last (B, ld)), f32; nothing is
    written in place."""
    if a.dim() != 3 or g.shape != a.shape or \
            tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"a and g must be (B, S, ld) and h0 (B, ld); got "
                         f"{tuple(a.shape)}, {tuple(g.shape)}, "
                         f"{tuple(h0.shape)}")
    for name, x in (("a", a), ("g", g), ("h0", h0)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    return _Scan.apply(a, g, h0, on_cpu(a, g, h0))
