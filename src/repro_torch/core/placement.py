"""Cluster → device placement and the distributed graph engine.

The JAX package's ``core/placement.py`` in PyTorch.  Paper mapping:
inter-NALE FIFOs become inter-device halo exchange.  Row groups
(clusters) are placed contiguously on the "graph" axis of a 2-D
``("graph", "query")`` mesh; each sweep a device gathers the frontier
values it needs and computes its local rows.  The second mesh axis
carries concurrent queries: halo exchange stays confined to "graph"
because queries are independent, and ``query=1`` degenerates to the 1-D
layout.

One process drives the whole mesh, as the JAX engines do (a single
controller), so a ``GraphMesh`` is a (graph, query) grid of torch
devices and every collective is a copy or a reduction this process
issues:

  * **Halo exchange** (the JAX engines' tiled ``all_gather``): each graph
    shard's ``(q, rows, B)`` slice is copied into one gathered
    ``(q, rows of the plan, B)`` buffer per destination device and query
    shard — a peer copy across cards; slots on one device share the
    buffer.
  * **SpMV**: each (graph, query) slot launches the compacted SpMV kernel
    (``kernels/bsr_spmv.py``) over ``CompactIndex.rows`` of its shard,
    whose source columns are global, against that buffer: views of the
    plan's index, no copy, no sync.  The JAX engines shard its ``ref``
    kernel; on CUDA tensors ``impl="ref"`` is the hand kernel.
  * **Convergence vote** (the JAX engines' ``psum``): one small device
    reduction, read to the host once a round — the engines' rule of one
    host read a sweep (``DistStats.host_syncs``); nothing synchronizes
    the whole device.

``make_graph_mesh(device="cpu")`` puts every slot on the CPU (the tests:
the counterpart of XLA's fake host devices), ``device="cuda:0"`` every
slot on one card; without ``device`` the slots are ``cuda:0 …
cuda:n-1``.  Processes joined by ``torch.distributed`` are not used:
NCCL refuses two ranks on one card, and a world of one would leave the
exchange untested there.  A multi-host mesh is a later item (ROADMAP
queue 1).

The mesh's padded rows (the plan's rows rounded up to a multiple of the
"graph" extent) hold the ⊕-identity, are never valid and are never read
as a column, so a slot keeps only its shard's rows of the plan; the
last shards hold fewer rows, or none.

``lower_distributed`` traces, and does not run, one sweep of the sharded
engine as one rank's SPMD program (``make_fx`` on fake tensors over a
``DeviceMesh`` of a fake world, functional collectives): the
counterpart of the JAX package's ``jax.jit(...).lower`` for its dry-run
tooling, whose graph text names the collectives.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import semiring as sr
from .engine import Prepared, _apply, _scalars
from .. import resilience
from ..kernels import ops
from ..kernels.spec import KernelSpec

# the distributed engines run the ref kernel's registration, resolved
# once through the same registry the local engines use; on CUDA tensors
# it launches the compacted hand kernel at its default knobs (a
# distributed policy takes impl="ref", so no tuning reaches it)
_spmv_ref = ops.select_kernel("bsr_spmv", KernelSpec(impl="ref"))


@dataclasses.dataclass(frozen=True)
class GraphMesh:
    """A (graph, query) grid of torch devices: ``devices[g][q]`` runs the
    slot of graph shard ``g`` and query shard ``q``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"graph": len(self.devices), "query": len(self.devices[0])}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_graph_mesh(num_devices: Optional[int] = None,
                    query_axis: int = 1, device=None) -> GraphMesh:
    """2-D ``("graph", "query")`` device mesh.

    ``num_devices`` are factored as ``graph = num_devices // query_axis``
    (row-major, as ``jax.make_mesh``); ``query_axis=1`` is the degenerate
    1-D layout.  With ``device`` named every slot is that device and
    ``num_devices`` defaults to 1; without it the slots are the cards
    ``cuda:0 … cuda:n-1``, all of them by default, and no card raises.
    """
    q = int(query_axis)
    if q < 1:
        raise ValueError(f"query_axis must be >= 1, got {q}")
    if device is not None:
        n = num_devices or 1
        slots = [_device(device)] * n
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards == 0:
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to build a mesh "
                "of CPU slots")
        n = num_devices or cards
        if n > cards:
            raise ValueError(
                f"{n} devices asked for, {cards} cards present; pass "
                "device= to put several slots on one device")
        slots = [torch.device("cuda", i) for i in range(n)]
    if n % q:
        raise ValueError(
            f"query_axis={q} does not divide {n} devices; pick a "
            f"divisor of the device count (see factor_query_axis)")
    return GraphMesh(tuple(tuple(slots[g * q:(g + 1) * q])
                           for g in range(n // q)))


def factor_query_axis(num_devices: int, num_queries: int) -> int:
    """Auto-factor the device count for a Q-source batch: the largest
    divisor of ``num_devices`` not exceeding ``num_queries``, so both
    mesh axes stay as full as the batch allows (q queries can't feed
    more than q query-shards; leftover devices go to "graph")."""
    q = max(int(num_queries), 1)
    for cand in range(min(q, num_devices), 0, -1):
        if num_devices % cand == 0:
            return cand
    return 1


def _default_mesh(device: torch.device, num_queries: int,
                  query_axis: Optional[int]) -> GraphMesh:
    """Every card when the plan is on one, else one slot on the plan's
    device (the JAX package's default mesh is every device)."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    q = query_axis or factor_query_axis(n, num_queries)
    if device.type == "cuda":
        return make_graph_mesh(n, q)
    return make_graph_mesh(n, q, device=device)


@dataclasses.dataclass
class DistStats:
    sweeps: int
    converged: bool
    halo_bytes_per_sweep: float   # all_gather payload an exchange, a device
    cut_fraction: float
    mesh_shape: Tuple[int, int] = (1, 1)       # (graph, query) extent
    query_sweeps: Optional[np.ndarray] = None  # per-query sweep counts
    # the bulk-synchronous engines exchange once per sweep, so
    # halo_exchanges == sweeps there; the async flavor (core/async_dist.py)
    # runs local_sweeps relaxations per exchange and reports strictly
    # fewer exchanges on multi-sweep fixpoints.
    halo_exchanges: int = 0
    local_sweeps: int = 1                      # k (1 = bulk-synchronous)
    shard_sweeps: Optional[np.ndarray] = None  # per-"graph"-shard active
    #                                            local sweeps (self-timed
    #                                            rate of each shard)
    # not fields of the JAX package's DistStats, whose loops stay on the
    # device: the device→host reads of the round loop (one a round), and
    # the bytes this process's exchange copies write each round (the
    # reference's formula above counts what a real mesh moves instead)
    host_syncs: int = dataclasses.field(default=0, compare=False)
    copy_bytes_per_exchange: float = dataclasses.field(default=0.0,
                                                       compare=False)


def _pad_rows(t: torch.Tensor, rows: int, value=0) -> torch.Tensor:
    pad = rows - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), value)])


@dataclasses.dataclass
class ShardedBatch:
    """The layout shared by every batched distributed flavor: the mesh,
    the row/query padding, the padded validity mask and frontier.

    Built by :func:`shard_batched_inputs`; the bulk-synchronous engine
    (:func:`distributed_sync_run_batched`) and the self-timed one
    (``core.async_dist``) both run on it, which is what makes their
    converged states comparable bit for bit.  The JAX package's also
    holds the padded tile image; here every slot reads the plan's
    compacted index instead.
    """

    mesh: Optional[GraphMesh]
    d_g: int                # "graph" extent
    d_q: int                # "query" extent
    r_pad: int              # rows padded to a multiple of d_g
    q_pad: int              # queries padded to a multiple of d_q
    q: int                  # real (un-padded) query count
    valid: torch.Tensor     # (r_pad, B) bool
    x0: torch.Tensor        # (q_pad, r_pad, B) f32
    qlive: np.ndarray       # (q_pad,) — padding queries start converged

    def halo_bytes_per_exchange(self, b: int) -> float:
        """Remote bytes a device gathers in ONE tiled all_gather of the
        frontier (summed over its resident query rows)."""
        return (self.r_pad // self.d_g) * b * 4.0 * (self.d_g - 1) * \
            (self.q_pad // self.d_q)


def _x0_tensor(p: Prepared, x0) -> torch.Tensor:
    """A stacked frontier as float32 on the plan's device (numpy arrays
    are uploaded; a tensor on another device is refused)."""
    if isinstance(x0, torch.Tensor):
        if x0.device != p.device:
            raise ValueError(f"x0 is on {x0.device}, the plan on {p.device}")
        return x0.to(torch.float32)
    return torch.from_numpy(np.asarray(x0, dtype=np.float32)).to(p.device)


def shard_batched_inputs(p: Prepared, x0,
                         mesh: Optional[GraphMesh] = None,
                         query_axis: Optional[int] = None) -> ShardedBatch:
    """Pad a ``Prepared`` image's validity mask and a stacked
    ``(Q, r_pad, B)`` frontier for a 2-D ``("graph", "query")`` mesh, on
    the plan's device.

    Rows are padded to a multiple of the "graph" extent (padding rows
    hold the ⊕-identity so they never win a reduction), queries to a
    multiple of the "query" extent (padding queries are marked dead in
    ``qlive`` — converged from sweep 0, zero work).  ``query_axis=None``
    auto-factors the device count against the batch size; 0 is rejected
    here for every flavor (the per-source escape hatch lives in the
    session API, not the engines).
    """
    x0 = _x0_tensor(p, x0)
    Q = int(x0.shape[0])
    if query_axis is not None and query_axis < 1:
        # the query_axis=0 per-source escape hatch lives one layer up
        # (GraphProcessor._run_batched) — the engine itself must never
        # silently reinterpret 0 as "auto-factor"
        raise ValueError(
            "batched distributed engines need query_axis=None (auto) "
            f"or >= 1, got {query_axis}; the query_axis=0 per-source "
            "loop is dispatched by the session API, not the engine")
    if mesh is None:
        mesh = _default_mesh(p.device, Q, query_axis)
    d_g, d_q = mesh.shape["graph"], mesh.shape["query"]
    r_pad = ((p.r_pad + d_g - 1) // d_g) * d_g
    q_pad = ((Q + d_q - 1) // d_q) * d_q
    x = x0.new_zeros((q_pad, r_pad, p.b))
    x[:Q, : p.r_pad] = x0
    # padding rows hold the ⊕-identity so they never win a reduction
    x[:, p.r_pad:] = float(sr.get(p.semiring).zero)
    return ShardedBatch(mesh=mesh, d_g=d_g, d_q=d_q, r_pad=r_pad,
                        q_pad=q_pad, q=Q,
                        valid=_pad_rows(p.valid, r_pad, False), x0=x,
                        qlive=np.arange(q_pad) < Q)


@dataclasses.dataclass
class _ShardRows:
    """One graph shard's rows of the plan on one device: the compacted
    index's view (None for a custom semiring, which reads the tile image
    through the plain version), the tile image's rows for that case, the
    validity mask and, for the async flavor, the interior rows."""

    index: Optional[object]
    vals: Optional[torch.Tensor]
    cols: Optional[torch.Tensor]
    nnz: Optional[torch.Tensor]
    valid: torch.Tensor
    interior: Optional[torch.Tensor]


def _index_rows(index, sl: slice, dev: torch.device):
    """``index.rows(sl)``, on ``dev``: the view itself on the index's
    device, else its entries copied there with ``row_ptr`` rebased."""
    rows = index.rows(sl)
    if rows.row_ptr.device == dev:
        return rows
    lo, hi = (int(v) for v in rows.row_ptr[[0, -1]].tolist())
    return dataclasses.replace(
        rows, row_ptr=(rows.row_ptr - lo).to(dev),
        pairs=rows.pairs[lo:hi].to(dev), long_rows=rows.long_rows.to(dev))


class _Slots:
    """One run's (graph, query) slots: each slot's rows of the frontier on
    its device, the gathered halo buffers, and the SpMV of a slot's rows.

    ``own_halo`` (the async flavor): every slot also keeps its own copy of
    the gathered buffer, and its state is a view of its rows there, so
    the buffer always reads the halo of the round's start overlaid with
    the slot's freshest values; the bulk-synchronous flavor reads the
    shared buffer and keeps its state apart.
    """

    def __init__(self, p: Prepared, sb: ShardedBatch, own_halo: bool):
        self.p, self.sb, self.own_halo = p, sb, own_halo
        self.rl = sb.r_pad // sb.d_g
        self.q_l = sb.q_pad // sb.d_q
        self.ranges = [(min(s * self.rl, p.r_pad),
                        min((s + 1) * self.rl, p.r_pad))
                       for s in range(sb.d_g)]
        self.slots = [(s, j, sb.mesh.devices[s][j]) for j in range(sb.d_q)
                      for s in range(sb.d_g)]
        self.root = sb.mesh.devices[0][0]
        index = p.compact_index()
        self.rows: Dict[Tuple[int, torch.device], _ShardRows] = {}
        for s, _, dev in self.slots:
            if (s, dev) not in self.rows:
                self.rows[s, dev] = self._shard_rows(s, dev, index)
        shape = (self.q_l, p.r_pad, p.b)
        self.halo: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        for _, j, dev in self.slots:
            if (j, dev) not in self.halo:
                self.halo[j, dev] = torch.empty(shape, device=dev)
        self.buf: Dict[Tuple[int, int], torch.Tensor] = {}
        self.x: Dict[Tuple[int, int], torch.Tensor] = {}
        for s, j, dev in self.slots:
            lo, hi = self.ranges[s]
            if own_halo:
                self.buf[s, j] = torch.empty(shape, device=dev)
                self.x[s, j] = self.buf[s, j][:, lo:hi]
            else:
                self.x[s, j] = torch.empty((self.q_l, hi - lo, p.b),
                                           device=dev)
            self.x[s, j].copy_(sb.x0[j * self.q_l:(j + 1) * self.q_l,
                                     lo:hi])
        entry = self.q_l * p.r_pad * p.b * 4.0
        self.copy_bytes = entry * (len(self.halo) +
                                   (len(self.buf) if own_halo else 0))

    def _shard_rows(self, s: int, dev: torch.device, index) -> _ShardRows:
        p, (lo, hi) = self.p, self.ranges[s]
        sl = slice(lo, hi)
        interior = None
        if self.own_halo:
            # interior rows: every live in-tile reads this shard's rows —
            # relaxable before any halo byte lands
            row0 = s * self.rl
            cols = p.cols[sl]
            lane = torch.arange(cols.shape[1], device=p.device)
            live_tile = lane[None, :] < p.nnz[sl, None]
            local = (cols >= row0) & (cols < row0 + self.rl)
            interior = (~(live_tile & ~local).any(dim=1)).to(dev)
        if index is None:
            return _ShardRows(None, p.vals[sl].to(dev), p.cols[sl].to(dev),
                              p.nnz[sl].to(dev), self.sb.valid[sl].to(dev),
                              interior)
        return _ShardRows(_index_rows(index, sl, dev), None, None, None,
                          self.sb.valid[sl].to(dev), interior)

    def exchange(self) -> None:
        """The halo exchange: every graph shard's rows into each gathered
        buffer of its query shard, then (``own_halo``) each slot's copy."""
        for (j, dev), g in self.halo.items():
            for s, (lo, hi) in enumerate(self.ranges):
                if hi > lo:
                    g[:, lo:hi].copy_(self.x[s, j], non_blocking=True)
        for (s, j), h in self.buf.items():
            h.copy_(self.halo[j, h.device], non_blocking=True)

    def source(self, s: int, j: int, dev: torch.device) -> torch.Tensor:
        """What slot (s, j)'s SpMV reads: its own buffer or the shared
        gathered one."""
        return self.buf[s, j] if self.own_halo else self.halo[j, dev]

    def relax(self, s: int, j: int, dev: torch.device, apply_kind: str,
              ring, scalars):
        """One sweep of slot (s, j)'s rows against its source buffer:
        (x_new, improved), neither written back."""
        rows, x = self.rows[s, dev], self.x[s, j]
        if x.shape[1] == 0:     # a shard past the plan's rows: no launch
            y = torch.empty_like(x)
        else:
            y = _spmv_ref(rows.vals, rows.cols, rows.nnz,
                          self.source(s, j, dev),
                          semiring=self.p.semiring, index=rows.index)
        damping, tol, inv_n = scalars
        return _apply(apply_kind, ring, y, x, rows.valid, damping, inv_n,
                      tol)

    def to_devices(self, t: torch.Tensor) -> Dict[Tuple[int, torch.device],
                                                   torch.Tensor]:
        """A (q_pad,) tensor on the root device as each query shard's
        slice on each of its slots' devices."""
        return {(j, dev): t[j * self.q_l:(j + 1) * self.q_l].to(dev)
                for s, j, dev in self.slots}

    def vote(self, flags: Dict[Tuple[int, int], torch.Tensor]
             ) -> torch.Tensor:
        """The convergence vote: OR over "graph" of each slot's (q_l,)
        flags, as a (q_pad,) tensor on the root device."""
        d_g, d_q = self.sb.d_g, self.sb.d_q
        stacked = torch.stack([flags[s, j].to(self.root)
                               for j in range(d_q) for s in range(d_g)])
        return stacked.view(d_q, d_g, self.q_l).any(dim=1).reshape(-1)

    def gather(self) -> torch.Tensor:
        """The (q_pad, plan rows, B) state on the plan's device."""
        dev = self.p.device
        return torch.cat([
            torch.cat([self.x[s, j].to(dev) for s in range(self.sb.d_g)],
                      dim=1) for j in range(self.sb.d_q)])


class _Rounds:
    """The host side of a round loop: done flags read once a round, the
    per-query sweep counts the host can derive from them, and the read
    count."""

    def __init__(self, sb: ShardedBatch, root: torch.device):
        self.done = ~sb.qlive
        self.done_dev = torch.from_numpy(self.done.copy()).to(root)
        self.sweeps = np.zeros(sb.q_pad, dtype=np.int32)
        self.rounds = 0
        self.syncs = 0

    def open(self, limit: int) -> bool:
        return self.rounds < limit and not self.done.all()

    def close(self, improved: torch.Tensor) -> None:
        """End a round whose convergence vote is ``improved`` (q_pad,):
        a query that improved nothing is done; one host read."""
        self.sweeps += ~self.done
        self.done_dev = self.done_dev | ~improved
        self.done = self.done_dev.cpu().numpy()
        self.syncs += 1
        self.rounds += 1


def _sync_rounds(p: Prepared, sb: ShardedBatch, apply_kind: str, damping,
                 tol, max_sweeps: int):
    """The bulk-synchronous round loop; returns (x (q_pad, plan rows, B),
    _Rounds, _Slots)."""
    ring = sr.get(p.semiring)
    scalars = _scalars(p, damping, tol)
    st = _Slots(p, sb, own_halo=False)
    rd = _Rounds(sb, st.root)
    while rd.open(max_sweeps):
        live = st.to_devices(~rd.done_dev)
        # halo exchange: ONLY along "graph" — queries are independent
        st.exchange()
        flags = {}
        for s, j, dev in st.slots:
            x_new, imp = st.relax(s, j, dev, apply_kind, ring, scalars)
            # a live query's final (no-improvement) sweep still writes
            # x_new and counts — exactly like the sequential loop
            st.x[s, j] = torch.where(live[j, dev][:, None, None], x_new,
                                     st.x[s, j])
            flags[s, j] = imp.flatten(1).any(dim=1)
        rd.close(st.vote(flags))
    return st.gather(), rd, st


def distributed_sync_run(
        p: Prepared, x0, apply_kind: str = "relax",
        damping: float = 0.85, tol: float = 1e-6, max_sweeps: int = 10_000,
        mesh: Optional[GraphMesh] = None
        ) -> Tuple[torch.Tensor, DistStats]:
    """Bulk-synchronous distributed engine, one source: rows over "graph"
    (the mesh's first query column)."""
    mesh = mesh or _default_mesh(p.device, 1, 1)
    d = mesh.shape["graph"]
    # host-level fault sites: an exchange-round failure (raise) and a
    # straggling shard (delay), at the engine's dispatch boundary
    resilience.fire("dist.straggler", flavor="sync", batched=False,
                    shards=d)
    resilience.fire("dist.dispatch", flavor="sync", batched=False,
                    shards=d)
    column = GraphMesh(tuple((row[0],) for row in mesh.devices))
    sb = shard_batched_inputs(p, _x0_tensor(p, x0)[None], mesh=column)
    x, rd, st = _sync_rounds(p, sb, apply_kind, damping, tol, max_sweeps)
    sweeps = int(rd.sweeps[0])
    stats = DistStats(sweeps=sweeps, converged=bool(rd.done[0]),
                      halo_bytes_per_sweep=sb.halo_bytes_per_exchange(p.b),
                      cut_fraction=p.clustering.cut_fraction,
                      mesh_shape=(d, mesh.shape["query"]),
                      halo_exchanges=sweeps,   # BSP: one per sweep
                      host_syncs=rd.syncs,
                      copy_bytes_per_exchange=st.copy_bytes)
    return x[0], stats


def distributed_sync_run_batched(
        p: Prepared, x0, apply_kind: str = "relax",
        damping: float = 0.85, tol: float = 1e-6, max_sweeps: int = 10_000,
        mesh: Optional[GraphMesh] = None, query_axis: Optional[int] = None
        ) -> Tuple[torch.Tensor, DistStats]:
    """Batched distributed engine: one round loop over the 2-D
    ``("graph", "query")`` mesh for a stacked ``(Q, r_pad, B)`` frontier.

    Rows shard over "graph" exactly as in :func:`distributed_sync_run`;
    the query axis shards over "query".  Halo exchange runs only along
    "graph" — queries are independent, so nothing crosses the "query"
    axis except the convergence vote.  Each query freezes (bit-exactly,
    including its final no-improvement sweep) once it individually
    converges, so results are bit-identical to running the sources one
    at a time, for any mesh factorization.

    ``query_axis``: explicit "query" extent (must divide the device
    count); None auto-factors via :func:`factor_query_axis`.  Ignored
    when ``mesh`` is given.
    """
    sb = shard_batched_inputs(p, x0, mesh=mesh, query_axis=query_axis)
    resilience.fire("dist.straggler", flavor="sync", batched=True,
                    shards=sb.d_g)
    resilience.fire("dist.dispatch", flavor="sync", batched=True,
                    shards=sb.d_g)
    x, rd, st = _sync_rounds(p, sb, apply_kind, damping, tol, max_sweeps)
    sweeps_q = rd.sweeps[: sb.q]
    straggler = int(sweeps_q.max(initial=0))
    stats = DistStats(
        sweeps=straggler, converged=bool(rd.done[: sb.q].all()),
        halo_bytes_per_sweep=sb.halo_bytes_per_exchange(p.b),
        cut_fraction=p.clustering.cut_fraction,
        mesh_shape=(sb.d_g, sb.d_q), query_sweeps=sweeps_q,
        halo_exchanges=straggler,  # bulk-synchronous: one per sweep
        host_syncs=rd.syncs, copy_bytes_per_exchange=st.copy_bytes)
    return x[: sb.q], stats


def lower_distributed(p: Prepared, mesh, apply_kind: str = "relax",
                      batch: Optional[int] = None):
    """Trace (no execution) one sweep of the distributed engine as one
    rank's program, for dry-run inspection; returns the traced
    ``torch.fx.GraphModule`` (its ``code`` names every collective).

    ``mesh``: a ("graph", "query") ``DeviceMesh``, or a ``GraphMesh``,
    whose shape is laid over a fake world of as many ranks
    (``launch/mesh.py``).  Each rank holds its graph shard's rows of the
    plan (rows padded to a multiple of the "graph" extent, as the
    reference pads them) and gathers the frontier with a tiled
    all-gather on "graph".  ``batch=Q`` traces the 2-D batched sweep
    instead: a (q_pad, r_pad, B) frontier split over ("query", "graph"),
    q_pad = Q rounded up to the "query" extent; its halo exchange stays
    on "graph"."""
    import torch.distributed._functional_collectives as funcol
    from torch.fx.experimental.proxy_tensor import make_fx
    from ..launch.mesh import device_mesh
    if isinstance(mesh, GraphMesh):
        mesh = device_mesh(tuple(mesh.shape.values()), ("graph", "query"))
    shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    d = shape["graph"]
    d_q = shape.get("query", 1)
    r_pad = ((p.r_pad + d - 1) // d) * d
    rows = r_pad // d
    ring = sr.get(p.semiring)
    graph = (mesh, mesh.mesh_dim_names.index("graph"))
    damping, tol, inv_n = _scalars(p, 0.85, 1e-6)

    def sweep(vals_l, cols_l, nnz_l, valid_l, x_l):
        with warnings.catch_warnings():   # a newer name in later torch
            warnings.simplefilter("ignore", FutureWarning)
            xg = funcol.all_gather_tensor(
                x_l, gather_dim=1 if batch else 0, group=graph)
        y = _spmv_ref(vals_l, cols_l, nnz_l, xg, semiring=p.semiring)
        x_new, _ = _apply(apply_kind, ring, y, x_l, valid_l, damping,
                          inv_n, tol)
        return x_new

    meta = dict(device="meta")
    args = [torch.empty((rows, p.k_max, p.b, p.b), dtype=torch.float32,
                        **meta),
            torch.empty((rows, p.k_max), dtype=torch.int32, **meta),
            torch.empty((rows,), dtype=torch.int32, **meta),
            torch.empty((rows, p.b), dtype=torch.bool, **meta)]
    if batch:
        q_pad = ((int(batch) + d_q - 1) // d_q) * d_q
        args.append(torch.empty((q_pad // d_q, rows, p.b),
                                dtype=torch.float32, **meta))
    else:
        args.append(torch.empty((rows, p.b), dtype=torch.float32, **meta))
    return make_fx(sweep, tracing_mode="fake")(*args)
