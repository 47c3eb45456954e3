"""Kernel entry points behind one ``select_kernel`` registry.

Engines resolve a callable once per run via ``select_kernel(op, spec)``,
where ``spec`` is a ``KernelSpec`` (kernels/spec.py).  The callable then
decides by the device of the tensors it is given:

  * CUDA tensors: ``impl="ref"`` and unfused ``impl="pallas"`` launch the
    hand-written CUDA SpMV (``bsr_spmv.bsr_spmv``; the engine applies the
    update rule in torch); fused ``impl="pallas"`` launches
    ``bsr_spmv.bsr_spmv_fused``.  Given ``index=`` (the plan's
    ``CompactIndex``, or a group's ``rows(sl)`` view) they take the
    compacted route (``csrc/bsr_spmv_compact.cu``), without it the ELL
    route (``csrc/bsr_spmv.cu``).  The engines always pass the index.
  * CPU tensors: both impls run the plain torch versions in
    ``kernels/ref.py`` (the wrappers themselves make that choice), over
    the index when one is given.
  * The callable launches the compacted kernels with the spec's knobs,
    ``block_size`` warps a block and (unfused) ``rows_per_step`` rows a
    thread; a knob left None runs its default (8 warps, 1 row), as does
    ``impl="ref"``, which has no knobs.  The session hands the engines
    the concrete spec (``KernelSpec.concrete``, with an autotuned record
    when ``autotune=True``).
  * A registered custom semiring runs the plain versions on every device:
    the kernels know only the four built-in rings.
  * Attention is not in the registry: ``attention()`` below keys on the
    device alone.  On CUDA tensors it launches the hand-written flash
    kernel (``flash_attention.flash_attention``) wherever the JAX
    package's Pallas path would run it (S == Skv, S > 1, D_v == D); other
    shapes, such as a decode step, run the plain ``ref.attention_ref``,
    as the JAX package computes them in XLA outside any kernel.  The JAX
    package's ``impl`` switch has no counterpart: its serving path passes
    ``impl="ref"``, and the port runs the kernel there all the same.
    Where autograd records the call (training), the kernel runs through
    ``flash_attention.flash_attention_train``: its forward, and in the
    backward the plain attention's gradients, recomputed.
  * The WKV6 recurrence is not in the registry either: ``wkv6()`` below
    keys on the device alone and launches the hand-written kernel
    (``wkv6.wkv6_heads``) for every CUDA call, prefill and decode step
    alike.  The JAX package's model runs its ``_wkv_scan`` in XLA and
    never its Pallas kernel; the port's model runs the kernel, which
    computes the same recurrence, head by head.
  * Training differentiates the two scans through autograd Functions
    whose backwards are hand-written kernels too: ``wkv6_train()``
    (``wkv6.wkv6_train``: the routed forward kernel, then the same
    route's backward, ``csrc/wkv6_backward_chunked.cu`` or
    ``csrc/wkv6_backward.cu``) and ``rg_lru_scan()``
    (``rg_lru.rg_lru_scan``: ``csrc/rg_lru.cu``, forward and backward).
    The JAX package differentiates its ``lax.scan``s by XLA.

Nothing else reaches the plain versions on the card, and a failed build
or launch raises: there is no fallback.

Registered call signatures (one contract per (op, fused) pair):

  ("bsr_spmv", fused=False)  fn(vals, cols, nnz, x, semiring=...,
                                index=None)
                             -> y (Q, R, B)
  ("bsr_spmv", fused=True)   fn(vals, cols, nnz, x, xg, valid, act_rows,
                                damping, tol, inv_n, semiring=...,
                                apply_kind=..., index=None)
                             -> (x_new, changed, improved_any)

A custom semiring ignores ``index`` and runs ``ref.bsr_spmv_ref`` (or its
fused form) over the ELL arrays.
"""

from __future__ import annotations

import torch

from . import bsr_spmv as _cuda
from . import flash_attention as _flash
from . import ref as _ref
from . import rg_lru as _rg_lru
from . import wkv6 as _wkv6
from .. import resilience
from ..core.semiring import BUILTIN
from .spec import (DEFAULT_BLOCK_SIZE, DEFAULT_ROWS_PER_STEP, KernelSpec,
                   as_kernel_spec)

_KERNELS = {}


def register_kernel(op: str, impl: str, fused: bool = False):
    def deco(builder):
        _KERNELS[(op, impl, fused)] = builder
        return builder
    return deco


def select_kernel(op: str, spec=None):
    """Resolve one kernel callable for (op, spec).

    ``spec`` may be a ``KernelSpec``, a bare impl string, or None
    (defaults).  Raises ``KeyError`` naming the available registrations
    when the combination has no kernel.  Fault site ``kernel.select``
    fires here (ctx: op/impl/fused), once per engine run.
    """
    spec = as_kernel_spec(spec)
    resilience.fire("kernel.select", op=op, impl=spec.impl,
                    fused=spec.fuse_frontier)
    key = (op, spec.impl, spec.fuse_frontier)
    try:
        builder = _KERNELS[key]
    except KeyError:
        raise KeyError(
            f"no kernel registered for op={op!r} impl={spec.impl!r} "
            f"fused={spec.fuse_frontier}; have {sorted(_KERNELS)}"
        ) from None
    return builder(spec)


@register_kernel("bsr_spmv", "ref")
@register_kernel("bsr_spmv", "pallas")
def _build_bsr_spmv(spec: KernelSpec):
    bk = spec.block_size or DEFAULT_BLOCK_SIZE
    rs = spec.rows_per_step or DEFAULT_ROWS_PER_STEP

    def spmv(block_vals, block_cols, block_nnz, x, semiring="plus_times",
             index=None):
        if semiring not in BUILTIN:
            return _ref.bsr_spmv_ref(block_vals, block_cols, block_nnz, x,
                                     semiring)
        return _cuda.bsr_spmv(block_vals, block_cols, block_nnz, x,
                              semiring, index=index, block_size=bk,
                              rows_per_step=rs)
    return spmv


@register_kernel("bsr_spmv", "pallas", fused=True)
def _build_bsr_spmv_fused(spec: KernelSpec):
    bk = spec.block_size or DEFAULT_BLOCK_SIZE

    def spmv_fused(block_vals, block_cols, block_nnz, x, xg, valid,
                   act_rows, damping, tol, inv_n, semiring="min_plus",
                   apply_kind="relax", index=None):
        if semiring not in BUILTIN:
            return _ref.bsr_spmv_fused_ref(
                block_vals, block_cols, block_nnz, x, xg, valid, act_rows,
                damping, tol, inv_n, semiring, apply_kind)
        return _cuda.bsr_spmv_fused(
            block_vals, block_cols, block_nnz, x, xg, valid, act_rows,
            damping, tol, inv_n, semiring, apply_kind, index=index,
            block_size=bk)
    return spmv_fused


def attention(q, k, v, causal=True, window=None, scale=None):
    """Multi-head attention; q (B, H, S, D), k/v (B, Hkv, Skv, D), Hkv | H.

    GQA: the kernel reads kv head h // (H / Hkv) in place, and the plain
    path repeats the kv heads to H, as the JAX package's ``attention``
    does before its kernel; both compute the same function.

    DTensors (a mesh's, ``launch/dryrun.py``) attend shard by shard
    (``_attention_on_mesh``).
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"kv heads {k.shape[1]} must divide heads "
                         f"{q.shape[1]}")
    if type(q).__name__ == "DTensor":
        return _attention_on_mesh(q, k, v, causal, window, scale)
    s, d = q.shape[2], q.shape[3]
    if s == k.shape[2] and s > 1 and v.shape[-1] == d:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return _flash.flash_attention_train(q, k, v, causal, window,
                                                scale)
        return _flash.flash_attention(q, k, v, causal, window, scale)
    return _ref.attention_ref(q, k, v, causal, window, scale)


def _attention_on_mesh(q, k, v, causal, window, scale):
    """``attention`` on DTensors: each shard attends over its own batch
    rows and query heads (``local_map``), as laid out by q's placements
    on the batch and head dims (any other split of q, k or v is
    gathered).  The kv heads are split with the query heads where their
    count divides; else each shard takes the whole kv heads and keeps
    the ones its query heads read, and their gradients are partial sums
    over the head shards.  No shard gathers another's heads, which a
    (B, H) flatten of a batch- and head-split tensor would."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    q_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                 else Replicate() for p in q.placements)
    head_dims = [i for i, p in enumerate(q_pl)
                 if isinstance(p, Shard) and p.dim == 1]
    n_h = 1
    for i in head_dims:
        n_h *= mesh.size(i)
    h, hkv = q.shape[1], k.shape[1]
    split_kv = hkv % n_h == 0
    kv_pl = tuple(p if (isinstance(p, Shard) and p.dim == 0) or split_kv
                  else Replicate() for p in q_pl)
    kv_grad = tuple(Partial() if i in head_dims and not split_kv else p
                    for i, p in enumerate(kv_pl))
    h_local = h // n_h
    group = h // hkv

    def attend(ql, kl, vl):
        if not split_kv:
            m = 0
            for i in head_dims:
                m = m * mesh.size(i) + mesh.get_local_rank(i)
            lo = m * h_local // group
            hi = max(lo + 1, (m + 1) * h_local // group)
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        return attention(ql, kl, vl, causal, window, scale)

    return local_map(attend, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def per_shard(fn, args, dims, out_dims):
    """``fn`` on each shard's local pieces of DTensor ``args`` whose work
    splits along a batch and a channel dim (a scan: every (row, channel)
    independent).  ``dims[i]`` = (batch dim, channel dim) of ``args[i]``,
    None where it has none; ``out_dims`` likewise for each output.  The
    splits of ``args[0]`` along its two dims are kept, every other split
    is gathered, a plain tensor counts as replicated; an input without
    one of those dims is taken whole and its gradient is a partial sum
    over that split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lead = args[0]
    mesh = lead.device_mesh
    # a plain tensor among them (a state the model makes) is replicated
    args = tuple(a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, (Replicate(),) * mesh.ndim, run_check=False) for a in args)
    role = {i: dims[0].index(p.dim) for i, p in enumerate(lead.placements)
            if isinstance(p, Shard) and p.dim in dims[0]
            and p.dim is not None}

    def lay(d, grad=False):
        out = []
        for i in range(mesh.ndim):
            if i in role and d[role[i]] is not None:
                out.append(Shard(d[role[i]]))
            else:
                out.append(Partial() if grad and i in role else Replicate())
        return tuple(out)

    return local_map(fn, out_placements=tuple(lay(d) for d in out_dims),
                     in_placements=tuple(lay(d) for d in dims),
                     in_grad_placements=tuple(lay(d, True) for d in dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


_WKV_DIMS = ((0, 2),) * 4 + ((None, 0), (0, 1))


def wkv6(r, k, v, w, u, state):
    """The RWKV-6 recurrence: r, k, v, w (B, T, H, hs), u (H, hs), the
    f32 state (B, H, hs, hs) updated in place; returns y (B, T, H, hs) in
    r's dtype (``wkv6.wkv6_heads``).  DTensors run shard by shard
    (``per_shard``: batch rows and heads)."""
    if type(r).__name__ == "DTensor":
        def local(*a):
            y = _wkv6.wkv6_heads(*a)
            return y, a[-1]
        y, s = per_shard(local, (r, k, v, w, u, state), _WKV_DIMS,
                         ((0, 2), (0, 1)))
        state.copy_(s)
        return y
    return _wkv6.wkv6_heads(r, k, v, w, u, state)


def wkv6_train(r, k, v, w, u, s0):
    """The recurrence with gradients, for training: r, k, v, w (B, T, H,
    hs), u (H, hs) f32, s0 (B, H, hs, hs) f32; returns (y, the final
    state), nothing written in place (``wkv6.wkv6_train``)."""
    if type(r).__name__ == "DTensor":
        return per_shard(_wkv6.wkv6_train, (r, k, v, w, u, s0), _WKV_DIMS,
                         ((0, 2), (0, 1)))
    return _wkv6.wkv6_train(r, k, v, w, u, s0)


def rg_lru_scan(a, g, h0):
    """The RG-LRU scan h_t = a_t·h_{t−1} + g_t with gradients: a, g (B, S,
    ld) f32, h0 (B, ld) f32; returns (h (B, S, ld), h_last)
    (``rg_lru.rg_lru_scan``)."""
    if type(a).__name__ == "DTensor":
        return per_shard(_rg_lru.rg_lru_scan, (a, g, h0),
                         ((0, 2), (0, 2), (0, 1)), ((0, 2), (0, 1)))
    return _rg_lru.rg_lru_scan(a, g, h0)
