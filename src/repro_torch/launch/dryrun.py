"""Pod dry run: trace every (arch × shape × mesh) cell on abstract tensors.

The JAX package's ``launch/dryrun.py`` in PyTorch.  The proof that the
distribution config is coherent without the hardware: a fake world of
256 (or 512) ranks in one process stands in for the pod
(``launch/mesh.py``), and every input is a DTensor whose local shard lies
on the ``meta`` device (``launch/specs.py``), so nothing is allocated and
nothing is sent.  For every cell we:

  1. build the abstract inputs on the mesh (the f32 master tree and the
     optimizer state for training; the compute-dtype model for serving),
  2. run the port's real entry point on them (``train.step``'s
     ``train_step``, ``lm.prefill``, ``lm.decode_step``) under
     ``implicit_replication`` (a plain tensor the model makes, such as
     positions, counts as replicated) and the mesh in force
     (``sharding.rules.use_mesh``: ``constrain`` and flash-decoding),
  3. record one device's view of it (``DeviceCounter``: flops, bytes
     read and written, collectives by kind with their payload bytes, and
     live local bytes for the memory estimate), ``FlopCounterMode``'s
     count of the same local ops and DTensor's own collective counts
     (``CommDebugMode``).

On meta the attention takes its plain version (``cuda_lib.on_cpu``), as
the reference's dry run lowers ``attn_impl="ref"``, in query chunks of
1,024 (past 16,384 rows; past 1,024 where it stands in for the flash
kernel, whose training structure, forward then a recomputed plain
backward, it keeps), so the memory estimate sees chunked scores.  The
scans (WKV6, RG-LRU, Griffin's serving loop)
stand in for their kernels: outputs and scratch made, the kernel's work
noted by formula (``kernels/cost.py``, listed under ``noted_kernels``),
since their plain versions' step loops would take hours on meta.
Nothing is computed.

Cost composition: XLA's cost analysis counts a loop body once, so the
reference composes superblock pieces.  Eager PyTorch runs every layer,
so a prefill's or decode's ``composed`` equals its ``full`` and
``--no-pieces`` changes nothing.  A train cell traces one of its
``accum_for`` microbatches through ``train_step`` and scales its cost
and collectives by the accumulation steps in ``composed`` (the
optimizer then counted accum times, as in the reference's
composition).

Memory: ``argument_bytes`` are the live local bytes when the entry point
is called (parameters, optimizer state, batch or cache), ``peak_est_bytes``
the most live at once during it, ``output_bytes`` the results' bytes
(``alias_bytes`` of them the arguments updated in place), ``temp_bytes``
the rest of the peak, so peak = argument + output + temp − alias as in
the reference.  A prefill or decode cell's arguments are the serving
model's compute-dtype weights, not the f32 masters the reference passes.

A cell whose op has no DTensor sharding rule ends ``status: "error"``
with the op's name and DTensor's message (``OpError``).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out build/dryrun
  python -m repro_torch.launch.dryrun --all --multi-pod
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback
import warnings
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..configs.base import ARCH_IDS, ModelConfig, get_config
from ..kernels import cost
from ..models import lm
from ..sharding.rules import DEFAULT_RULES, _contiguous_stride, \
    distribute_parameter, spec_for, use_mesh
from ..train import tree as T
from ..train.optimizer import make_optimizer, warmup_cosine
from ..train.step import make_train_step
from . import specs as S
from .mesh import make_factored_mesh, make_production_mesh

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# ops that move no data: allocation, aliasing, autograd bookkeeping
_FREE = {"empty", "empty_strided", "detach", "alias", "lift_fresh",
         "_wrap_tensor_autograd", "wait_tensor", "_local_scalar_dense",
         "set_", "resize_"}


def _tensors(tree):
    out = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, (list, tuple)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)
    visit(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCounter(TorchDispatchMode):
    """One device's view of a traced step.

    An op on DTensors is handed back (``NotImplemented``) so DTensor runs
    it; the ops it runs on the local shards, the collectives included,
    come back here and are counted: flops by ``torch.utils.flop_counter``'s
    formulas on the local shapes, bytes as every input read once and
    every output written once (views and allocations move nothing),
    collectives by kind with their result's bytes (the reference's
    ``parse_collectives`` reads result shapes), and the live bytes of
    every storage an op makes, freed when the storage dies.  On plain
    tensors (one card, no mesh) it counts the same way."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.noted: Dict[str, int] = {}
        self.largest: Dict[str, int] = {}   # one collective's bytes, by kind
        self._sizes: Dict[int, int] = {}

    def track(self, tree) -> int:
        """Count ``tree``'s storages as live (arguments); returns the bytes
        newly counted."""
        before = self.live
        for t in _tensors(tree):
            self._alloc(_local(t))
        return self.live - before

    def bytes_of(self, tree) -> int:
        """Bytes of the distinct storages of ``tree``'s local shards."""
        seen = {}
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            seen[st._cdata] = st.nbytes()
        return sum(seen.values())

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def note(self, what: str, flops: float, nbytes: float) -> None:
        """A scan kernel's work on meta (``kernels/cost.py``), which no
        op shows."""
        self.flops += flops
        self.bytes += nbytes
        self.noted[what] = self.noted.get(what, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            n = sum(_nbytes(t) for t in _tensors(out))
            self.collectives[kind] = self.collectives.get(kind, 0.0) + n
            self.largest[kind] = max(self.largest.get(kind, 0), n)
            self.collectives["count"] = self.collectives.get("count", 0.0) \
                + 1
        elif not func.is_view and name not in _FREE:
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            self.bytes += sum(_nbytes(t) for t in
                              _tensors((args, kwargs)) + _tensors(out))
        for t in _tensors(out):
            self._alloc(t)
        return out

    def collectives_summary(self) -> Dict[str, float]:
        out = dict(self.collectives)
        out["total_bytes"] = sum(v for k, v in out.items()
                                 if k not in ("count", "total_bytes"))
        out.setdefault("count", 0.0)
        return out


# views that their schema does not mark as views
_VIEWS = (torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default)


# in-place ops DTensor refuses or gets wrong on a split tensor (it will
# not change the placement an in-place op writes; its index_copy_ can
# leave the local shard whole): run out of place, then copied back
_OUT_OF_PLACE = {torch.ops.aten.index_copy_.default:
                 torch.ops.aten.index_copy.default,
                 torch.ops.aten.index_put_.default:
                 torch.ops.aten.index_put.default}


class OpError(RuntimeError):
    """A DTensor op that failed in the dry run; the message starts with
    the op's name."""


class PodLayout(TorchDispatchMode):
    """The layout choices GSPMD makes on its own and DTensor, which places
    each op by itself, does not.  Six rules, on DTensor ops only:

    * a product ``mm(a, b)`` (every ``x @ w`` of the model reaches one)
      keeps its left operand's row (batch) sharding: the right operand is
      gathered over the mesh axes that split those rows (ZeRO-3's
      all-gather of a weight before use), and a right operand that a mesh
      axis leaves whole while the left is whole (or a partial sum) on it
      is split along its contraction dim there, the left's columns with
      it, so the product is a partial sum rather than computed once on
      every shard of that axis; a product's partial sums over the model
      axes are all-reduced at once (Megatron's row-parallel all-reduce),
      over the batch axes (a weight's gradient) they stay partial until
      they land in the gradient's sharded buffer (a reduce-scatter);
    * ``new_zeros``/``new_empty`` keep their source's split on every dim
      whose length they keep (DTensor makes them whole: a gather's
      backward would build full-batch zeros on every shard);
    * ``index_copy_`` and ``index_put_`` run out of place and are copied
      back (DTensor refuses an in-place op that would change the
      placement it writes, and its ``index_copy_`` can leave a split
      shard whole);
    * a lookup ``table[indices]`` gathers the table over the mesh axes
      that split the indices (the embedding's ZeRO-3 gather), and
      ``gather`` along a dim takes its input whole along that dim and its
      index laid out as the input;
    * a view that fails on the input's layout (DTensor refuses a dim
      sharded unevenly for the split, such as a projection's heads ×
      head_dim over 16 shards when there are 6 heads, or the local view
      does not fit) gathers the input's sharded mesh axes one at a time,
      last first, until it goes through.

    The gathers are collectives like any other and are counted.  An op
    that fails is raised as an ``OpError`` naming it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        try:
            return self._dispatch(func, args, kwargs or {})
        except OpError:
            raise
        except Exception as e:
            raise OpError(f"{func}: {type(e).__name__}: {e}") from e

    def _dispatch(self, func, args, kwargs):
        if func is torch.ops.aten.mm.default:
            return _reduce_tp_partials(func(*_product_layout(*args),
                                            **kwargs))
        if func in (torch.ops.aten.new_zeros.default,
                    torch.ops.aten.new_empty.default):
            return _new_like(func, args[0], args[1], kwargs)
        if func in _OUT_OF_PLACE:
            dst = args[0]
            dst.copy_(_OUT_OF_PLACE[func](*args, **kwargs))
            return dst
        if func is torch.ops.aten.index.Tensor:
            args = (_whole_where_split(args[0], args[1]),) + \
                tuple(args[1:])
        elif func is torch.ops.aten.gather.default:
            x = _whole_along(args[0], args[1])
            args = (x, args[1], _laid_out_as(args[2], x)) + tuple(args[3:])
        try:
            return func(*args, **kwargs)
        except RuntimeError:
            if not (func.is_view or func in _VIEWS):
                raise
            x = args[0]
        from torch.distributed.tensor import Partial, Replicate
        pl = list(x.placements)
        for i in reversed(range(len(pl))):
            if isinstance(pl[i], (Replicate, Partial)):   # not a split
                continue
            pl[i] = Replicate()
            try:
                return func(x.redistribute(x.device_mesh, tuple(pl)),
                            *args[1:], **kwargs)
            except RuntimeError:
                continue
        raise RuntimeError(f"{func}: no layout of {x.placements} takes "
                           "this view")


def _reduce_tp_partials(out):
    """A product's partial sums over the model axes all-reduced at once
    (Megatron's row-parallel all-reduce); over the batch axes (a weight's
    gradient) they stay partial until they land in their sharded buffer
    (a reduce-scatter)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(out, DTensor):
        return out
    names = out.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if isinstance(p, Partial) and
               names[i] not in DEFAULT_RULES["batch"] else p
               for i, p in enumerate(out.placements))
    return out if pl == tuple(out.placements) else \
        out.redistribute(out.device_mesh, pl)


def _new_like(func, x, size, kwargs):
    """``x.new_zeros(size)`` laid out as x on every dim whose length it
    keeps (DTensor makes it whole, so a gather's backward would build its
    full-batch zeros on every shard)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return func(x, size, **kwargs)
    mesh = x.device_mesh
    size = tuple(size)
    pl = []
    for i, p in enumerate(x.placements):
        keep = isinstance(p, Shard) and p.dim < len(size) and \
            size[p.dim] == x.shape[p.dim]
        pl.append(p if keep else Replicate())
    local = list(size)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    t = func(x.to_local(), local, **kwargs)
    return DTensor.from_local(t, mesh, tuple(pl), run_check=False,
                              shape=torch.Size(size),
                              stride=_contiguous_stride(size))


def _whole_where_split(table, indices):
    """A looked-up ``table`` gathered over the mesh axes that split the
    indices (the embedding's ZeRO-3 gather), so the lookup keeps the
    indices' batch split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(table, DTensor):
        return table
    split = set()
    for idx in indices:
        if isinstance(idx, DTensor):
            split |= {i for i, p in enumerate(idx.placements)
                      if isinstance(p, Shard)}
    pl = tuple(Replicate() if i in split else p
               for i, p in enumerate(table.placements))
    return table if pl == tuple(table.placements) else \
        table.redistribute(table.device_mesh, pl)


def _laid_out_as(t, like):
    """t (a DTensor) redistributed to ``like``'s placements."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or not isinstance(like, DTensor) or \
            tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(t.device_mesh, like.placements)


def _whole_along(x, dim: int):
    """x with its shards along ``dim`` and its partial sums gathered
    (DTensor's masked gather along a split vocab fails on 3-D inputs)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    pl = tuple(p if isinstance(p, Shard) and p.dim != dim else Replicate()
               for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _product_layout(a, b):
    """``PodLayout``'s product rule: (a, b) laid out for ``a @ b``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return a, b
    mesh = b.device_mesh
    pa, pb = list(a.placements), list(b.placements)
    for i in range(len(pb)):
        if mesh.size(i) > 1 and isinstance(pa[i], Shard) and \
                pa[i].dim == 0 and isinstance(pb[i], Shard):
            pb[i] = Replicate()
    split = 1
    for i, p in enumerate(pb):
        if isinstance(p, Shard) and p.dim == 0:
            split *= mesh.size(i)
    for i in range(len(pb)):
        if mesh.size(i) > 1 and isinstance(pa[i], (Replicate, Partial)) and \
                isinstance(pb[i], Replicate) and \
                b.shape[0] % (split * mesh.size(i)) == 0:
            pa[i], pb[i] = Shard(1), Shard(0)     # a partial product
            split *= mesh.size(i)
    if tuple(pa) != tuple(a.placements):
        a = a.redistribute(mesh, tuple(pa))
    if tuple(pb) != tuple(b.placements):
        b = b.redistribute(mesh, tuple(pb))
    return a, b


@contextlib.contextmanager
def _unseen_propagation():
    """DTensor works out an op's output shape by running it on fake
    tensors of the global shape; that is bookkeeping, not device work, so
    the counters do not see it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def unseen(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = unseen
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


@contextlib.contextmanager
def _quiet():
    """DTensor warns at every sequential multi-axis all-reduce and at the
    CPU all-to-all fallback; a sweep would print thousands."""
    logger = logging.getLogger("torch.distributed")
    level = logger.level
    logger.setLevel(logging.ERROR)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            yield
        finally:
            logger.setLevel(level)


def trace(fn, args, mesh=None) -> Dict[str, Any]:
    """Run ``fn(*args)`` under the counters; returns the reference's
    per-lowering record (``cost``, ``mem``, ``collectives``,
    ``compile_s`` as the trace's seconds) plus ``flops_global`` (one
    device's flops × the mesh's devices), ``flops_counter_mode``
    (``FlopCounterMode``'s count, which sees the same local ops: a
    cross-check of ``cost.flops``) and DTensor's own ``comm_counts``."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    dev = DeviceCounter()
    arg_bytes = dev.track(args)
    flops = FlopCounterMode(display=False)
    comm = CommDebugMode()
    t0 = time.time()
    unlisten = cost.listen(dev.note)
    try:
        with _quiet(), _unseen_propagation(), use_mesh(mesh), dev, flops, \
                comm, PodLayout(), implicit_replication():
            out = fn(*args)
    finally:
        unlisten()
    dt = time.time() - t0
    out_bytes = dev.bytes_of(out)
    arg_keys = {_local(t).untyped_storage()._cdata for t in _tensors(args)}
    alias = {}
    for t in _tensors(out):
        st = _local(t).untyped_storage()
        if st._cdata in arg_keys:
            alias[st._cdata] = st.nbytes()
    alias_bytes = sum(alias.values())
    mem = {"argument_bytes": float(arg_bytes),
           "output_bytes": float(out_bytes),
           "temp_bytes": float(dev.peak - arg_bytes - out_bytes
                               + alias_bytes),
           "alias_bytes": float(alias_bytes),
           "peak_est_bytes": float(dev.peak)}
    world = mesh.size() if mesh is not None else 1
    return {"cost": {"flops": float(dev.flops), "bytes": float(dev.bytes)},
            "flops_counter_mode": float(flops.get_total_flops()),
            "flops_global": float(dev.flops) * world,
            "mem": mem, "collectives": dev.collectives_summary(),
            "comm_counts": {str(k): v for k, v in
                            comm.get_comm_counts().items()},
            "noted_kernels": dev.noted,
            "largest_collective_bytes": dev.largest,
            "compile_s": dt}


# ---------------------------------------------------------------------------
# cell runners
# ---------------------------------------------------------------------------


def abstract_model(cfg: ModelConfig, mesh) -> lm.LM:
    """The serving model (compute-dtype weights, ``lm.LM``) with every
    parameter an abstract DTensor laid out as its master leaf."""
    model = lm.LM(cfg, device="meta")
    axes = lm.param_axes(cfg)
    for param, path, r in list(lm.param_paths(cfg, model)):
        ax = T.get(axes, path)
        if r is not None:                 # the leaf without its stack axis
            ax = ax.split(" ", 1)[1] if " " in ax else ""
        distribute_parameter(model, param,
                             spec_for(tuple(param.shape), ax, mesh), mesh)
    return model


def run_train_cell(cfg: ModelConfig, mesh, pieces: bool = True,
                   shard_grads: bool = True) -> Dict[str, Any]:
    """One microbatch of ``SHAPES["train_4k"]`` (its batch over
    ``accum_for``) through ``train_step``; ``composed`` is that trace's
    cost and collectives × the accumulation steps, so the optimizer is
    counted accum times, as the reference's composition counts it, and
    the peak is the traced step's (microbatches run one after another
    into the same gradient buffers).  The port lays every gradient
    buffer out as its master (``train.step.Working``), so the
    reduce-scatter is always pinned: ``shard_grads=False`` is recorded
    and changes nothing."""
    accum = S.accum_for(cfg.name, mesh)
    sh = S.SHAPES["train_4k"]
    opt = make_optimizer(cfg.optimizer, warmup_cosine(3e-4, 100, 10000))
    params, axes = S.abstract_params(cfg, mesh)
    opt_state = S.abstract_opt_state(opt, params, axes, mesh)
    batch = S.batch_specs(cfg, mesh, sh["batch"] // accum, sh["seq"],
                          train=True)
    full = trace(make_train_step(cfg, opt, device="meta"),
                 (params, opt_state, batch), mesh)
    composed = {
        "cost": {k: v * accum for k, v in full["cost"].items()},
        "collectives": {k: v * accum
                        for k, v in full["collectives"].items()},
        "note": f"one microbatch of {accum} traced, x {accum}: the "
                "optimizer counted accum times"}
    return {"accum_steps": accum, "shard_grads": shard_grads,
            "full": full, "composed": composed}


def run_prefill_cell(cfg: ModelConfig, mesh, pieces: bool = True
                     ) -> Dict[str, Any]:
    sh = S.SHAPES["prefill_32k"]
    model = abstract_model(cfg, mesh)
    batch = S.batch_specs(cfg, mesh, sh["batch"], sh["seq"], train=False)
    extras = {k: v for k, v in batch.items() if k != "tokens"}

    def pf(m, tokens, ex):
        return lm.prefill(cfg, m, tokens, cache_len=sh["seq"],
                          extras=ex or None)

    return {"full": trace(pf, (model, batch["tokens"], extras), mesh)}


def run_decode_cell(cfg: ModelConfig, mesh, shape_name: str,
                    pieces: bool = True) -> Dict[str, Any]:
    sh = S.SHAPES[shape_name]
    model = abstract_model(cfg, mesh)
    cache = S.cache_specs(cfg, mesh, sh["batch"], sh["seq"])
    tok, pos = S.decode_input_specs(cfg, mesh, sh["batch"])

    def step(m, c, t, p):
        return lm.decode_step(cfg, m, c, t, p)

    return {"full": trace(step, (model, cache, tok, pos), mesh)}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             pieces: bool = True, factored: bool = False,
             shard_grads: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    ok, why = S.cell_applicable(cfg, shape_name)
    base = {"arch": arch, "shape": shape_name, "package": "repro_torch",
            "mesh": ("2x16x16" if multi_pod else "16x16")
            + ("f" if factored else "")}
    if not ok:
        return dict(base, status="skipped", reason=why)
    mesh = make_factored_mesh(multi_pod=multi_pod) if factored else \
        make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        if shape_name == "train_4k":
            r = run_train_cell(cfg, mesh, pieces, shard_grads=shard_grads)
        elif shape_name == "prefill_32k":
            r = run_prefill_cell(cfg, mesh, pieces)
        else:
            r = run_decode_cell(cfg, mesh, shape_name, pieces)
        full = r["full"]
        r.setdefault("composed", {"cost": full["cost"],
                                  "collectives": full["collectives"],
                                  "note": "eager trace of every layer: "
                                          "composed = full"})
        return dict(base, status="ok", wall_s=time.time() - t0, **r)
    except Exception as e:  # a failure here is a gap in the sharding
        return dict(base, status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:],
                    wall_s=time.time() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(S.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-pieces", action="store_true",
                    help="accepted: eager tracing has no pieces to compose")
    ap.add_argument("--factored", action="store_true",
                    help="factored model axis (16,8,2)")
    ap.add_argument("--no-shard-grads", action="store_true",
                    help="recorded; the port always lays gradients out "
                         "as their masters")
    ap.add_argument("--out", default=None, help="directory for JSON dumps")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s_) for a in ARCH_IDS for s_ in S.SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    if args.no_pieces:
        print("--no-pieces: eager PyTorch traces every layer; composed = "
              "full either way", flush=True)

    results = []
    for a, s_ in cells:
        r = run_cell(a, s_, multi_pod=args.multi_pod,
                     pieces=not args.no_pieces, factored=args.factored,
                     shard_grads=not args.no_shard_grads)
        results.append(r)
        status = r["status"]
        if status == "ok":
            peak = r["full"]["mem"]["peak_est_bytes"] / 2**30
            extra = f"peak={peak:.2f}GiB trace={r['full']['compile_s']:.1f}s"
        elif status == "error":
            extra = r["error"][:160]
        else:
            extra = r["reason"][:80]
        print(f"[{r['mesh']}] {a:28s} {s_:12s} {status:8s} {extra}",
              flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            tag = f"{a}__{s_}__{r['mesh'].replace('x', '_')}.json"
            with open(os.path.join(args.out, tag), "w") as f:
                json.dump(r, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped "
          f"(documented), {n_err} errors ==")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
