"""Hand-written CUDA flash attention: route, build at first use, bind, check,
launch.

``flash_attention`` replaces the JAX package's Pallas kernel
``flash_attention`` (``src/repro/kernels/flash_attention.py``) with two
CUDA kernels, picked by ``route(dtype, d)`` before any launch:

- ``"tensor_cores"``: bf16 at head dim 64, 128, 192 or 256 (granite-3-2b,
  chatglm3 and the llama family; nemotron-4-340b's 192, recurrentgemma-9b's
  256), ``csrc/flash_attention_sm90.cu``: wgmma on the tensor cores fed by
  a TMA ring of K/V tiles;
- ``"cuda_cores"``: f32 at any head dim up to 256, and bf16 at the other
  head dims up to 256 (16, 32, 96, ...), ``csrc/flash_attention.cu``: f32
  products on the CUDA cores.

Each source's head states its work split, the bound on the H100
(operations: 17.2 GFLOP, 17.4 us at the bf16 tensor-core peak for one
granite-3-2b prefill wave of 4 x 1024 tokens; 275 GFLOP, 0.278 ms for one
recurrentgemma-9b wave of 4 x 3072 tokens under its 2048-key window) and
what its design leaves on the table.

Device rule.  Given CPU tensors the wrapper runs the plain torch version
(``ref.attention_ref``: ``mha_ref``, or ``mha_chunked`` from S = 16384
on); given CUDA tensors it launches the routed kernel or raises.  The
route is never chosen after a failure: a failed build or launch raises,
with no fallback to the other kernel or to the plain version.

Build.  ``kernels/cuda_lib.py`` compiles each source with nvcc for sm_90a
into its own ``build/kernels/lib<name>-<hash>.so`` (no ``-fmad=false``:
nothing here is held bit for bit) the first time its kernel is launched.

The wrapper adds one to ``launch_counts["flash_attention"]`` and to the
route's own count (``flash_attention_tensor_cores`` or
``flash_attention_cuda_cores``) where it launches a kernel, and nowhere
else.

Training.  The kernel has no backward, and neither has the JAX package's
Pallas kernel: the reference trains through ``mha_ref`` and takes XLA's
autodiff of it.  ``flash_attention_train`` runs the kernel forward and,
in the backward, recomputes the plain attention (``ref.attention_ref``)
from the saved q, k and v and returns its autograd's gradients, the
counterpart of that autodiff.  No backward kernel is written.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from . import ref
from .cuda_lib import BASE_FLAGS, CudaLibrary, on_cpu

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORE_HEAD_DIMS = (64, 128, 192, 256)
MAX_HEAD_DIM = 256
MAX_GRID_Y = 65535  # B * H blocks along the CUDA-core kernel's grid y axis

launch_counts = {"flash_attention": 0, "flash_attention_tensor_cores": 0,
                 "flash_attention_cuda_cores": 0}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes q, k, v of this dtype and head dim:
    ``"tensor_cores"`` for bf16 at D 64, 128, 192 or 256, else
    ``"cuda_cores"``.
    Raises for a head dim the kernels do not take (D > 256) or a dtype
    other than f32 and bf16."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} not in [1, {MAX_HEAD_DIM}]")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take "
                        f"{sorted(map(str, DTYPE_CODES))}; got {dtype}")
    if dtype == torch.bfloat16 and d in TENSOR_CORE_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def _bind_cuda_cores(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, i, i,
        ctypes.c_float, i, p]
    lib.flash_attention_launch.restype = i


def _bind_tensor_cores(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_sm90_launch.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, i, i,
        ctypes.c_float, p]
    lib.flash_attention_sm90_launch.restype = i


LIBRARIES = {
    "cuda_cores": CudaLibrary("flash_attention", CSRC / "flash_attention.cu",
                              BASE_FLAGS, _bind_cuda_cores,
                              "flash_error_string"),
    "tensor_cores": CudaLibrary(
        "flash_attention_sm90", CSRC / "flash_attention_sm90.cu", BASE_FLAGS,
        _bind_tensor_cores, "flash_sm90_error_string"),
}


def _check(q, k, v):
    """(B, H, Hkv, S, D, route), or raise for what the kernels do not
    take."""
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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    path = route(q.dtype, d)
    if path == "cuda_cores" and b * h > MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} > {MAX_GRID_Y}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        # TMA reads 16-byte aligned rows with strides in 16-byte steps
        if path == "tensor_cores" and (t.data_ptr() % 16 or any(
                t.stride(i) % 8 for i in range(3) if t.shape[i] > 1)):
            raise ValueError(f"{name} needs a 16-byte aligned address and "
                             f"strides of b, h, s in multiples of 8 for the "
                             f"tensor-core kernel")
    return b, h, hkv, s, d, path


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """o = softmax(q kᵀ · scale, masked) v, per head.

    q (B, H, S, D); k, v (B, Hkv, S, D) with Hkv dividing H: query head h
    reads kv head h // (H / Hkv).  Any strides with a contiguous last dim
    (the tensor-core route also needs them in 16-byte steps).
    ``window`` (≥ 1) keeps keys with kpos > qpos - window; keys at or past
    S never attend.  Returns o (B, H, S, D) in q's dtype; on the card its
    memory is laid out as (B, S, H, D), so ``o.transpose(1, 2)`` is
    contiguous.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if on_cpu(q, k, v):
        # on meta (the dry run) the stand-in skips masked key blocks, as
        # the kernel skips masked tiles, so its work is counted as such
        return ref.attention_ref(q, k, v, causal, window, scale,
                                 1 if q.device.type == "meta"
                                 else ref.CHUNKED_THRESHOLD)
    b, h, hkv, s, d, path = _check(q, k, v)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o = torch.empty((b, s, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    library = LIBRARIES[path]
    lib = library.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            b, h, hkv, s, d, int(bool(causal)), window or 0, float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tensor_cores":
            rc = lib.flash_attention_sm90_launch(*args, stream)
        else:
            rc = lib.flash_attention_launch(*args, DTYPE_CODES[q.dtype],
                                            stream)
    library.check(rc, f"flash_attention ({path})")
    launch_counts["flash_attention"] += 1
    launch_counts["flash_attention_" + path] += 1
    return o


class _KernelForwardPlainBackward(torch.autograd.Function):
    """Forward: the hand kernel.  Backward: autograd of the plain
    attention, recomputed from the saved q, k, v (past 1024 rows in
    1024-row query chunks, each over the keys it may see)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        return flash_attention(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, do):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            # in query chunks past 1024 rows, each over the keys it may
            # see: the same values, without the masked blocks' work
            o = ref.attention_ref(*ins, *ctx.args, chunk_from=1)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(o, wrt, do))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` with a gradient: on CUDA tensors the kernel's
    output, differentiated through the plain attention recomputed in the
    backward; on CPU tensors the plain attention, differentiated
    directly.  On meta tensors (the dry run) the CUDA path's structure
    with the plain version in the kernel's place, so its count of work
    and of live bytes is the card's."""
    if on_cpu(q, k, v) and q.device.type != "meta":
        return ref.attention_ref(q, k, v, causal, window, scale)
    return _KernelForwardPlainBackward.apply(q, k, v, causal, window, scale)
