"""Graph execution engines — the paper's model of computation, in PyTorch.

Two engines over the same clustered BSR substrate:

  * ``run_sync``  — bulk-synchronous (Jacobi): every sweep processes every
    tile against last sweep's values.

  * ``run_async`` — the paper's asynchronous model: clusters ("groups" of
    contiguous row-blocks) are processed in index order; each group (a)
    *skips* entirely when none of its inputs changed — self-timed, work ∝
    data readiness — and (b) reads the *freshest* values, including ones
    produced earlier in the same sweep (Gauss-Seidel).

Every loop carries a query axis Q written out: the single-query runners
are the Q=1 case of the batched ones.  A query that has converged (or hit
``max_sweeps``) is frozen: its values are no longer updated and its
counters no longer grow, as under the JAX package's vmapped while loop.

The loops run in Python and read the device once per sweep, to decide
whether every query is done; ``RunStats.host_syncs`` counts these reads,
so it equals ``sweeps`` for every runner.  The async engine decides on the
device whether a group is ready: it launches every group and masks what
an idle group would write, and on the card it captures one sweep as a CUDA
graph and replays it for every later sweep (the counterpart of the JAX
package's one jitted loop).

Every loop hands the SpMV its plan's compacted index of filled tile
entries (``Prepared.compact_index``, built at the first query), so the
kernels take their compacted route; the async loop hands each group a
view of it.  The work counters still count whole tiles, as the
reference's do.

Counters of the fused and async paths accumulate in float32 on the
device, sweep by sweep and group by group in the reference's order, so
they equal the JAX package's bit for bit (and, like them, round once a
total passes 2^24).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import semiring as sr
from .cluster import Clustering, cluster_graph, identity_clustering
from .graph import Graph, to_bsr
from ..kernels import bsr_spmv, ops
from ..kernels.spec import KernelSpec, as_kernel_spec
from .. import resilience


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names one.  Without a card and without an explicit device this
    raises — it never carries on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch path on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class Prepared:
    """Clustered, permuted, device-resident graph + engine metadata."""

    # device tensors (all on one device)
    vals: torch.Tensor       # (r_pad, K, B, B) f32
    cols: torch.Tensor       # (r_pad, K) i32
    nnz: torch.Tensor        # (r_pad,) i32
    valid: torch.Tensor      # (r_pad, B) bool — real (non-padding) vertices
    dangling: torch.Tensor   # (r_pad, B) bool — zero-outdegree vertices
    group_tiles: torch.Tensor  # (S,) f32
    group_edges: torch.Tensor  # (S,) f32
    group_ext_tiles: torch.Tensor  # (S,) f32 — tiles reading outside group
    row_edges: torch.Tensor  # (r_pad,) f32 — true edges per row-block
    row_ext: torch.Tensor    # (r_pad,) f32 — tiles reading outside the
    #                          row's group (fused-path halo accounting)
    # host metadata
    n: int
    b: int
    r_pad: int
    k_max: int
    gb: int                  # row-blocks per group ("cluster" at engine level)
    s: int                   # number of groups
    semiring: str
    perm: np.ndarray         # old id -> new id
    inv_perm: np.ndarray     # new id -> old id
    clustering: Clustering
    tiles_total: float = 0.0
    edges_total: float = 0.0
    # the compacted index of the filled tile entries, built at the first
    # query (``compact_index``); not part of the plan's bytes, == or repr
    compact: Optional[bsr_spmv.CompactIndex] = dataclasses.field(
        default=None, compare=False, repr=False)
    _index_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, compare=False,
        repr=False)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nbytes(self) -> int:
        """Footprint of the plan (device tile image + host metadata), the
        unit of the plan store's byte budget, by the JAX package's formula
        so that both stores evict in the same order.  Read from tensor
        metadata, with no device-to-host copy.  The compacted index is
        not counted: the reference has none."""
        dev = sum(getattr(self, f).numel() * getattr(self, f).element_size()
                  for f in _PREPARED_DEVICE_FIELDS)
        host = int(self.perm.nbytes) + int(self.inv_perm.nbytes) + \
            int(self.clustering.assign.nbytes) + \
            int(self.clustering.perm.nbytes)
        return dev + host

    def compact_index(self) -> Optional[bsr_spmv.CompactIndex]:
        """The SpMV kernels' compacted index of this plan, built once on
        the plan's device (under the plan's lock: two threads' first
        queries build it once, and neither reads it half built); None for
        a custom semiring, which runs the plain versions over the ELL
        arrays."""
        if self.compact is None and self.semiring in sr.BUILTIN:
            with self._index_lock:
                if self.compact is None:
                    self.compact = bsr_spmv.build_compact_index(
                        self.vals, self.cols, self.nnz, self.semiring)
        return self.compact

    def to_blocks(self, x_flat: np.ndarray, pad: float) -> torch.Tensor:
        """(n,) values in OLD ids → (r_pad, B) block layout in new ids,
        built on the host and uploaded once."""
        out = np.full(self.r_pad * self.b, pad, dtype=np.float32)
        out[self.perm] = x_flat
        return torch.from_numpy(out.reshape(self.r_pad, self.b)).to(
            self.device)

    def from_blocks(self, xb: torch.Tensor) -> np.ndarray:
        """(r_pad, B) block layout → (n,) values in OLD ids (one download)."""
        flat = xb.detach().cpu().numpy().reshape(-1)
        return flat[self.perm]


_PREPARED_DEVICE_FIELDS = (
    "vals", "cols", "nnz", "valid", "dangling",
    "group_tiles", "group_edges", "group_ext_tiles",
    "row_edges", "row_ext")


# ---------------------------------------------------------------------------
# Prepared (de)serialization — the JAX package's plan format, byte for byte
# ---------------------------------------------------------------------------
#
# A serialized plan is one .npz payload: the device tile image pulled back
# to host, the clustering/permutation, and a JSON metadata record, framed
# as MAGIC + blake2b-128(payload) + payload.  Plans written by either
# package load in the other.

PREPARED_FORMAT_VERSION = 2  # v2: + row_edges/row_ext (fused-path counters)

_PLAN_MAGIC = b"RPLN\x01\x00"
_PLAN_DIGEST_SIZE = 16


class PlanIntegrityError(ValueError):
    """A framed plan payload failed its checksum — the bytes on disk are
    not the bytes that were written (bit rot, truncation, torn write)."""


def _frame_payload(payload: bytes) -> bytes:
    digest = hashlib.blake2b(payload,
                             digest_size=_PLAN_DIGEST_SIZE).digest()
    return _PLAN_MAGIC + digest + payload


def _unframe_payload(data: bytes) -> bytes:
    if not data.startswith(_PLAN_MAGIC):
        return data  # legacy unframed payload
    head = len(_PLAN_MAGIC)
    digest = data[head:head + _PLAN_DIGEST_SIZE]
    payload = data[head + _PLAN_DIGEST_SIZE:]
    want = hashlib.blake2b(payload,
                           digest_size=_PLAN_DIGEST_SIZE).digest()
    if digest != want:
        raise PlanIntegrityError(
            f"plan payload checksum mismatch ({len(payload)} bytes); "
            "the disk entry is corrupt — rebuild the plan")
    return payload


def serialize_prepared(p: Prepared) -> bytes:
    """Pack a ``Prepared`` into a self-describing bytes payload."""
    c = p.clustering
    meta = dict(
        version=PREPARED_FORMAT_VERSION, n=p.n, b=p.b, r_pad=p.r_pad,
        k_max=p.k_max, gb=p.gb, s=p.s, semiring=p.semiring,
        tiles_total=p.tiles_total, edges_total=p.edges_total,
        c_num_clusters=c.num_clusters, c_internal=c.internal_edges,
        c_cut=c.cut_edges)
    arrays = {f: getattr(p, f).cpu().numpy()
              for f in _PREPARED_DEVICE_FIELDS}
    arrays.update(perm=p.perm, inv_perm=p.inv_perm, c_assign=c.assign,
                  c_perm=c.perm, c_sizes=c.sizes, c_schedule=c.schedule)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    return _frame_payload(buf.getvalue())


def prepared_from_numpy(arrays: dict, meta: dict, device=None) -> Prepared:
    """Build a ``Prepared`` from host arrays (the npz keys of the plan
    format) and its metadata record, uploading the device half."""
    dev = resolve_device(device)
    clustering = Clustering(
        num_clusters=int(meta["c_num_clusters"]),
        assign=arrays["c_assign"], perm=arrays["c_perm"],
        sizes=arrays["c_sizes"], schedule=arrays["c_schedule"],
        internal_edges=int(meta["c_internal"]),
        cut_edges=int(meta["c_cut"]))
    return Prepared(
        **{f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(dev)
           for f in _PREPARED_DEVICE_FIELDS},
        n=int(meta["n"]), b=int(meta["b"]), r_pad=int(meta["r_pad"]),
        k_max=int(meta["k_max"]), gb=int(meta["gb"]), s=int(meta["s"]),
        semiring=meta["semiring"], perm=arrays["perm"],
        inv_perm=arrays["inv_perm"], clustering=clustering,
        tiles_total=float(meta["tiles_total"]),
        edges_total=float(meta["edges_total"]))


def deserialize_prepared(data: bytes, device=None) -> Prepared:
    """Rebuild a ``Prepared`` from a payload produced by either package's
    ``serialize_prepared``.  Raises ``PlanIntegrityError`` when a framed
    payload fails its checksum."""
    data = _unframe_payload(data)
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        meta = json.loads(z["__meta__"].tobytes().decode())
        if meta["version"] != PREPARED_FORMAT_VERSION:
            raise ValueError(
                f"plan payload version {meta['version']} != "
                f"{PREPARED_FORMAT_VERSION}; rebuild the plan")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return prepared_from_numpy(arrays, meta, device)


def prepare(g: Graph, semiring_name: str, b: int = 32,
            num_clusters: Optional[int] = None, pull: bool = True,
            clustered: bool = True, normalize: Optional[str] = None,
            seed: int = 0, device=None) -> Prepared:
    """Paper Fig. 4 steps 1–5: profile/extract → cluster → analyze →
    place → build the device BSR image (host numpy, then one upload).

    pull=True computes over in-edges (y_i = ⊕_j A[j→i] ⊗ x_j), the natural
    direction for relaxation/propagation algorithms.
    normalize="out_stochastic": edge j→i gets weight 1/outdeg(j) (PageRank).
    """
    dev = resolve_device(device)
    ring = sr.get(semiring_name)
    n = g.n
    if normalize == "out_stochastic":
        outdeg = np.maximum(np.diff(g.indptr), 1)
        w = (1.0 / outdeg)[np.repeat(np.arange(n), np.diff(g.indptr))]
        g = Graph(n=n, indptr=g.indptr, indices=g.indices,
                  weights=w.astype(np.float32))
    num_clusters = num_clusters or max(1, min(64, n // max(b, 1)))
    c = (cluster_graph(g, num_clusters, seed=seed) if clustered
         else identity_clustering(g, num_clusters))
    g2 = g.permute(c.perm.astype(np.int32))
    gm = g2.transpose() if pull else g2
    bsr = to_bsr(gm, b, pad_value=float(ring.zero))
    del gm

    # group (engine-level cluster) geometry: contiguous row-block ranges
    s = min(c.num_clusters, bsr.r)
    gb = (bsr.r + s - 1) // s
    r_pad = s * gb
    k = bsr.k_max
    vals = np.full((r_pad, k, b, b), float(ring.zero), dtype=np.float32)
    cols = np.zeros((r_pad, k), dtype=np.int32)
    nnz = np.zeros(r_pad, dtype=np.int32)
    vals[: bsr.r] = bsr.block_vals
    bsr.block_vals = None  # the tile image is the big one: hold one copy
    cols[: bsr.r] = bsr.block_cols
    nnz[: bsr.r] = bsr.block_nnz

    valid = np.zeros((r_pad, b), dtype=bool)
    valid.reshape(-1)[: n] = True  # permuted ids are 0..n-1
    outdeg0 = np.zeros(r_pad * b, dtype=np.int64)
    outdeg0[: n] = np.diff(g2.indptr)
    dangling = valid & (outdeg0.reshape(r_pad, b) == 0)

    grp = np.arange(r_pad) // gb
    group_tiles = np.zeros(s, dtype=np.float64)
    np.add.at(group_tiles, grp, nnz)
    group_edges = np.zeros(s, dtype=np.float64)
    edge_nnz = np.zeros(r_pad, dtype=np.float64)
    edge_nnz[: bsr.r] = bsr.edge_nnz
    np.add.at(group_edges, grp, edge_nnz)
    # halo: tiles whose source col-block lives outside the group row range
    ext = ((cols // gb) != grp[:, None]) & \
          (np.arange(k)[None, :] < nnz[:, None])
    group_ext_tiles = np.zeros(s, dtype=np.float64)
    np.add.at(group_ext_tiles, grp, ext.sum(axis=1))
    row_ext = ext.sum(axis=1).astype(np.float64)

    def up(a, dtype=None):
        a = a if dtype is None else a.astype(dtype)
        return torch.from_numpy(a).to(dev)

    vals_t = up(vals)
    del vals
    return Prepared(
        vals=vals_t, cols=up(cols), nnz=up(nnz), valid=up(valid),
        dangling=up(dangling),
        group_tiles=up(group_tiles, np.float32),
        group_edges=up(group_edges, np.float32),
        group_ext_tiles=up(group_ext_tiles, np.float32),
        row_edges=up(edge_nnz, np.float32),
        row_ext=up(row_ext, np.float32),
        n=n, b=b, r_pad=r_pad, k_max=k, gb=gb, s=s,
        semiring=semiring_name, perm=np.asarray(c.perm),
        inv_perm=np.argsort(np.asarray(c.perm)), clustering=c,
        tiles_total=float(nnz.sum()), edges_total=float(edge_nnz.sum()))


# ---------------------------------------------------------------------------
# apply / convergence rules
# ---------------------------------------------------------------------------


def _damped(y, damping, inv_n):
    """(1-d)·inv_n + d·y with the final multiply-add rounded once.

    XLA on the CPU contracts the JAX package's expression into one fused
    multiply-add, fma(d, y, (1-d)·inv_n), and the CUDA kernel does the
    same (``__fmaf_rn``).  Here d·y is exact in float64 (two 24-bit
    significands) and the sum is rounded to float64 then to float32,
    which equals the single rounding of an FMA except when the first
    rounding lands on a float32 tie (about once in 2^28 values)."""
    base = (1.0 - damping) * inv_n  # float32, as in the reference
    return (base.double() + damping.double() * y.double()).float()


def _apply(apply_kind: str, ring: sr.Semiring, y, xg, valid_g, damping,
           inv_n, tol):
    """Returns (x_new, improved) for a block of rows; ``valid_g`` (R, B)
    broadcasts over a leading query axis.

    ``damping``/``tol``/``inv_n`` are 0-d float32 tensors, so scalar
    arithmetic such as ``1 - damping`` rounds in float32 as in the JAX
    package.  PageRank uses dangling-drop semantics (no global dangling-
    mass redistribution; the caller L1-renormalizes), which keeps the
    update edge-local as the asynchronous model requires.
    """
    if apply_kind == "relax":
        x_new = ring.add(y, xg)
        imp = ring.improves(x_new, xg)
    elif apply_kind == "pagerank":
        x_new = _damped(y, damping, inv_n)
        x_new = torch.where(valid_g, x_new, 0.0)
        imp = torch.abs(x_new - xg) > tol
    elif apply_kind == "pagerank_delta":
        # ranks only RISE (by > tol) from the (1-d)/n floor toward the
        # fixpoint — conditional assignment makes the rule idempotent +
        # monotone, so it is safe under every self-timed schedule
        cand = _damped(y, damping, inv_n)
        imp = (cand - xg) > tol
        x_new = torch.where(imp, cand, xg)
    elif apply_kind == "kcore":
        # membership peeling: y counts live neighbours; k rides the
        # damping scalar slot
        alive = (xg > 0.0) & (y >= damping)
        x_new = torch.where(alive, xg, 0.0)
        imp = x_new < xg
    elif apply_kind == "identity":
        x_new = torch.where(valid_g, y, xg)
        imp = ring.improves(x_new, xg)
    else:
        raise ValueError(apply_kind)
    x_new = torch.where(valid_g, x_new, xg)
    imp = imp & valid_g
    return x_new, imp


@dataclasses.dataclass
class RunStats:
    sweeps: int
    converged: bool
    tile_work: float          # tiles actually combined
    edge_work: float          # true edges behind those tiles
    crit_tiles: float         # Σ_sweeps max_cluster(active tiles) — NALE critical path
    active_group_sweeps: float
    halo_tiles: float         # inter-cluster tile reads (FIFO/ICI traffic)
    total_groups: int
    mode: str
    # device→host reads the Python loops made to decide control flow (not
    # a field of the JAX package's RunStats, whose loops stay on device)
    host_syncs: int = dataclasses.field(default=0, compare=False)
    # seconds the async engine spent capturing its sweep as a CUDA graph
    # (0 on the CPU and for runs of one sweep)
    capture_s: float = dataclasses.field(default=0.0, compare=False)


def bsp_stats(p: Prepared, sweeps: int, converged: bool, mode: str,
              work_sweeps: Optional[int] = None,
              host_syncs: int = 0) -> RunStats:
    """Work counters for bulk-synchronous execution: every sweep touches
    every tile.  ``work_sweeps`` (default ``sweeps``) lets batched runs
    charge total work across the query axis while ``sweeps`` (and the
    critical path) reflect the straggler query."""
    w = sweeps if work_sweeps is None else work_sweeps
    return RunStats(
        sweeps=sweeps, converged=converged,
        tile_work=p.tiles_total * w,
        edge_work=p.edges_total * w,
        crit_tiles=float(np.max(p.group_tiles.cpu().numpy())) * sweeps,
        active_group_sweeps=float(p.s * w),
        halo_tiles=float(p.group_ext_tiles.cpu().numpy().sum()) * w,
        total_groups=p.s, mode=mode, host_syncs=host_syncs)


def dist_run_stats(p: Prepared, dist, mode: str = "distributed"
                   ) -> RunStats:
    """Work counters for a distributed run described by a
    ``placement.DistStats``.  Compute work follows the sweep counts as in
    :func:`bsp_stats`, but halo traffic is charged per *exchange*: the
    self-timed flavor's point is ``halo_exchanges < sweeps`` when
    ``local_sweeps > 1``, and the modeled boundary traffic must show it.
    """
    qs = dist.query_sweeps
    w = int(qs.sum()) if qs is not None else int(dist.sweeps)
    return RunStats(
        sweeps=dist.sweeps, converged=dist.converged,
        tile_work=p.tiles_total * w,
        edge_work=p.edges_total * w,
        crit_tiles=float(np.max(p.group_tiles.cpu().numpy())) * dist.sweeps,
        active_group_sweeps=float(p.s * w),
        halo_tiles=float(p.group_ext_tiles.cpu().numpy().sum())
        * dist.halo_exchanges,
        total_groups=p.s, mode=mode, host_syncs=dist.host_syncs)


def _counter_stats(p: Prepared, sweeps: int, converged: bool, c: dict,
                   mode: str, host_syncs: int = 0,
                   capture_s: float = 0.0) -> RunStats:
    """RunStats from measured per-query float32 counters (fused and async
    paths): totals over the query axis, summed as float32 by numpy as in
    the JAX package."""
    c = {k: v.cpu().numpy() for k, v in c.items()}
    return RunStats(
        sweeps=sweeps, converged=converged,
        tile_work=float(c["tile_work"].sum()),
        edge_work=float(c["edge_work"].sum()),
        crit_tiles=float(c["crit"].max(initial=0.0)),
        active_group_sweeps=float(c["active"].sum()),
        halo_tiles=float(c["halo"].sum()),
        total_groups=p.s, mode=mode, host_syncs=host_syncs,
        capture_s=capture_s)


# ---------------------------------------------------------------------------
# the loops — one query axis Q, converged queries frozen
# ---------------------------------------------------------------------------


def _resolve_kernel(kernel, impl: str) -> KernelSpec:
    """Resolve the runner-level ``kernel=``/legacy ``impl=`` pair into
    one KernelSpec (``kernel`` wins when given)."""
    if kernel is not None:
        return as_kernel_spec(kernel)
    return KernelSpec(impl=impl)


@dataclasses.dataclass
class _Loop:
    """Per-run state shared by the loops: scalars, per-query sweep
    counts and done flags (host), and the sync count."""

    p: Prepared
    x0: torch.Tensor          # (Q, r_pad, B)
    damping: torch.Tensor     # 0-d f32 on the CPU (see _apply)
    tol: torch.Tensor
    inv_n: torch.Tensor
    max_sweeps: int
    sweeps: np.ndarray = dataclasses.field(init=False)
    done: np.ndarray = dataclasses.field(init=False)
    syncs: int = 0

    def __post_init__(self):
        q = self.x0.shape[0]
        self.sweeps = np.zeros(q, dtype=np.int64)
        self.done = np.zeros(q, dtype=bool)

    def live(self) -> np.ndarray:
        return ~self.done & (self.sweeps < self.max_sweeps)

    def read(self, t: torch.Tensor) -> np.ndarray:
        self.syncs += 1
        return t.cpu().numpy()

    def finish_sweep(self, live: np.ndarray, converged: np.ndarray):
        self.done |= live & converged
        self.sweeps += live


def _scalars(p: Prepared, damping, tol):
    f32 = torch.float32
    return (torch.tensor(damping, dtype=f32), torch.tensor(tol, dtype=f32),
            torch.tensor(1.0 / max(p.n, 1), dtype=f32))


def _new_counters(q: int, device) -> dict:
    """Per-query float32 work counters, accumulated on the device."""
    return {k: torch.zeros(q, dtype=torch.float32, device=device)
            for k in ("tile_work", "edge_work", "halo", "active", "crit")}


def _frontier_setup(p: Prepared):
    """(R, K) long source col-blocks and (R, K) live-tile mask."""
    lane = torch.arange(p.cols.shape[1], device=p.device)
    return p.cols.long(), lane[None, :] < p.nnz[:, None]


def _sync_loop(st: _Loop, semiring_name: str, apply_kind: str, spec):
    p = st.p
    ring = sr.get(semiring_name)
    spmv = ops.select_kernel("bsr_spmv", spec)
    index = p.compact_index()
    x = st.x0.clone()
    while True:
        live = st.live()
        if not live.any():
            break
        y = spmv(p.vals, p.cols, p.nnz, x, semiring=semiring_name,
                 index=index)
        x_new, imp = _apply(apply_kind, ring, y, x, p.valid, st.damping,
                            st.inv_n, st.tol)
        lq = torch.from_numpy(live).to(p.device)
        x = torch.where(lq[:, None, None], x_new, x)
        st.finish_sweep(live, ~st.read(imp.flatten(1).any(dim=1)))
    return x


def _sync_loop_fused(st: _Loop, changed0: torch.Tensor, semiring_name: str,
                     apply_kind: str, spec):
    """Jacobi sweep via the fused kernel: each sweep builds the active
    row-block set from the change flags (a row is live iff one of its
    live input tiles changed last sweep) and consumes the kernel's own
    convergence flag.  Skipped rows provably cannot improve, so values
    AND sweep counts match the unfused path.  Bias rules touch every
    valid row on a query's sweep 0."""
    p = st.p
    spmv = ops.select_kernel("bsr_spmv", spec)
    cols_l, live_t = _frontier_setup(p)
    nnz_f = p.nnz.float()
    bias = sr.rule(apply_kind).bias
    valid_rows = p.valid.any(dim=1)
    index = p.compact_index()
    q = st.x0.shape[0]
    c = _new_counters(q, p.device)
    x, ch = st.x0.clone(), changed0.clone()
    while True:
        live = st.live()
        if not live.any():
            break
        lq = torch.from_numpy(live).to(p.device)
        act = (ch[:, cols_l] & live_t).any(dim=2)          # (Q, R)
        if bias:
            first = torch.from_numpy(st.sweeps == 0).to(p.device)
            act = act | (first[:, None] & valid_rows)
        act = act & lq[:, None]
        x, ch, imp_any = spmv(p.vals, p.cols, p.nnz, x, x, p.valid, act,
                              st.damping, st.tol, st.inv_n,
                              semiring=semiring_name, apply_kind=apply_kind,
                              index=index)
        af = act.float()
        row_tiles = af * nnz_f
        c["tile_work"] += row_tiles.sum(dim=1)
        c["edge_work"] += (af * p.row_edges).sum(dim=1)
        c["halo"] += (af * p.row_ext).sum(dim=1)
        c["active"] += act.reshape(q, p.s, p.gb).any(dim=2).float().sum(
            dim=1)
        c["crit"] += row_tiles.reshape(q, p.s, p.gb).sum(dim=2).amax(dim=1)
        st.finish_sweep(live, ~st.read(imp_any))
    return x, c


# Captures run one at a time in the process, each on a side stream of its
# device, in thread-local mode: CUDA then forbids the capturing thread
# alone any call that would break the capture, so other threads (a plan
# upload, a sync wave of the serving layer) go on working on their own
# streams while a sweep is captured.  In the default, global mode such a
# call from another thread fails and invalidates the capture.  No mode
# admits a device-wide synchronize (``torch.cuda.synchronize``) while a
# stream captures: one from any thread invalidates the capture, which
# then raises.  The engines never make one; ``torch.cuda.graph`` makes
# one as it opens a capture, under the lock.
_CAPTURE_LOCK = threading.Lock()


class _CapturedSweep:
    """One async sweep captured as a CUDA graph, replayed for each later
    sweep.  The kernel wrappers count their launches in Python, which
    runs once, at the capture, where nothing is launched: the capture
    records this thread's counts apart and adds them at every replay, so
    ``bsr_spmv.launch_counts`` stays exact while other threads launch.
    A failed capture or replay raises; nothing carries on eagerly."""

    def __init__(self, sweep, device: torch.device):
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            with bsr_spmv.capture_launches() as self.launches:
                with torch.cuda.graph(self.graph,
                                      stream=torch.cuda.Stream(device),
                                      capture_error_mode="thread_local"):
                    self.flags = sweep()
            self.seconds = time.perf_counter() - t0

    def __call__(self) -> torch.Tensor:
        self.graph.replay()
        bsr_spmv.add_launches(self.launches)
        return self.flags


def _async_loop(st: _Loop, changed0: torch.Tensor, semiring_name: str,
                apply_kind: str, spec):
    """Gauss-Seidel over the groups in index order (0..s-1).  A group is
    ready for a query when one of its live input tiles reads a block that
    changed last sweep or earlier this sweep; bias rules also run every
    group once (first touch).  With the fused kernel only the ready rows
    (and, on first touch, the valid rows) are walked and charged.

    Readiness is decided on the device, as the JAX package's ``lax.cond``
    decides it: every group is launched, the fused kernel walks none of
    an idle group's rows, and the unfused path computes an idle group's
    SpMV and discards it (a few microseconds of device time), so values,
    sweeps and every counter are those of a loop that skips the group.
    The sweep reads and writes only buffers allocated before it (x, the
    change flags, ``ran``, the counters, ``sweep_max`` and ``lq``, the
    device copy of the host's live mask), so on the card sweep 0 runs
    eagerly and the later sweeps replay its CUDA graph; on the CPU every
    sweep runs eagerly."""
    p = st.p
    ring = sr.get(semiring_name)
    spmv = ops.select_kernel("bsr_spmv", spec)
    fused = spec.fuse_frontier
    cols_l, live_t = _frontier_setup(p)
    nnz_f = p.nnz.float()
    valid_rows = p.valid.any(dim=1)
    first_touch = sr.rule(apply_kind).bias
    q, gb = st.x0.shape[0], p.gb
    index = p.compact_index()
    group_index = [None if index is None
                   else index.rows(slice(g * gb, (g + 1) * gb))
                   for g in range(p.s)]
    c = _new_counters(q, p.device)
    x, ch_prev = st.x0.clone(), changed0.clone()
    ch_next = torch.zeros_like(ch_prev)
    ran = torch.zeros((q, p.s), dtype=torch.bool, device=p.device)
    sweep_max = torch.zeros(q, dtype=torch.float32, device=p.device)
    lq = torch.zeros(q, dtype=torch.bool, device=p.device)

    def sweep() -> torch.Tensor:
        ch_next.zero_()
        sweep_max.zero_()
        for g in range(p.s):
            sl = slice(g * gb, (g + 1) * gb)
            ch = ch_prev | ch_next
            ready = (ch[:, cols_l[sl]] & live_t[sl]).any(dim=2)   # (Q, gb)
            active = ready.any(dim=1)
            if first_touch:
                active = active | ~ran[:, g]
            active = active & lq
            xg = x[:, sl].contiguous()
            vg = p.valid[sl]
            if fused:
                act_rows = ready
                if first_touch:
                    act_rows = act_rows | (~ran[:, g, None] &
                                           valid_rows[sl])
                act_rows = act_rows & lq[:, None]
                x_new, imp_rows, _ = spmv(
                    p.vals[sl], p.cols[sl], p.nnz[sl], x, xg, vg, act_rows,
                    st.damping, st.tol, st.inv_n, semiring=semiring_name,
                    apply_kind=apply_kind, index=group_index[g])
                arf = act_rows.float()
                g_tiles = (arf * nnz_f[sl]).sum(dim=1)
                g_edges = (arf * p.row_edges[sl]).sum(dim=1)
                g_halo = (arf * p.row_ext[sl]).sum(dim=1)
            else:
                y = spmv(p.vals[sl], p.cols[sl], p.nnz[sl], x,
                         semiring=semiring_name, index=group_index[g])
                x_new, imp = _apply(apply_kind, ring, y, xg, vg,
                                    st.damping, st.inv_n, st.tol)
                x_new = torch.where(active[:, None, None], x_new, xg)
                imp_rows = imp.any(dim=2) & active[:, None]
                af = active.float()
                g_tiles = af * p.group_tiles[g]
                g_edges = af * p.group_edges[g]
                g_halo = af * p.group_ext_tiles[g]
            x[:, sl] = x_new
            ch_next[:, sl] = imp_rows
            ran[:, g] |= active
            c["tile_work"] += g_tiles
            c["edge_work"] += g_edges
            c["halo"] += g_halo
            c["active"] += active.float()
            torch.maximum(sweep_max, g_tiles, out=sweep_max)
        c["crit"] += sweep_max
        ch_prev.copy_(ch_next)
        return ch_next.any(dim=1)

    replay, eager = None, True
    while True:
        live = st.live()
        if not live.any():
            break
        lq.copy_(torch.from_numpy(live))
        if eager:
            flags = sweep()
            eager = p.device.type != "cuda"  # on the card: capture next
        else:
            replay = replay or _CapturedSweep(sweep, p.device)
            flags = replay()
        st.finish_sweep(live, ~st.read(flags))
    return x, c, (replay.seconds if replay else 0.0)


def _run(p: Prepared, x0, changed0, apply_kind, damping, tol, max_sweeps,
         spec: KernelSpec, mode: str, batched: bool):
    """Shared body of the four runners; x0 is (Q, r_pad, B)."""
    resilience.fire("engine.run", mode=mode, impl=spec.impl,
                    fused=spec.fuse_frontier, batched=batched)
    if x0.device != p.device:
        raise ValueError(f"x0 is on {x0.device}, the plan on {p.device}")
    st = _Loop(p, x0.to(torch.float32), *_scalars(p, damping, tol),
               max_sweeps=max_sweeps)
    q = x0.shape[0]
    if changed0 is None and (mode == "async" or spec.fuse_frontier):
        changed0 = torch.ones((q, p.r_pad), dtype=torch.bool,
                              device=p.device)
    capture_s = 0.0
    if mode == "async":
        x, c, capture_s = _async_loop(st, changed0, p.semiring, apply_kind,
                                      spec)
    elif spec.fuse_frontier:
        x, c = _sync_loop_fused(st, changed0, p.semiring, apply_kind, spec)
    else:
        x = _sync_loop(st, p.semiring, apply_kind, spec)
        stats = bsp_stats(p, int(st.sweeps.max(initial=0)),
                          bool(st.done.all()), mode,
                          work_sweeps=int(st.sweeps.sum()),
                          host_syncs=st.syncs)
        return x, stats
    stats = _counter_stats(p, int(st.sweeps.max(initial=0)),
                           bool(st.done.all()), c, mode,
                           host_syncs=st.syncs, capture_s=capture_s)
    return x, stats


def run_sync(p: Prepared, x0: torch.Tensor, apply_kind: str = "relax",
             damping: float = 0.85, tol: float = 1e-6,
             max_sweeps: int = 10_000, impl: str = "ref", kernel=None,
             changed0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, RunStats]:
    """x0: (r_pad, B) — returns ((r_pad, B), RunStats)."""
    spec = _resolve_kernel(kernel, impl)
    x, stats = _run(p, x0[None], None if changed0 is None else changed0[None],
                    apply_kind, damping, tol, max_sweeps, spec, "sync",
                    batched=False)
    return x[0], stats


def run_async(p: Prepared, x0: torch.Tensor, apply_kind: str = "relax",
              damping: float = 0.85, tol: float = 1e-6,
              max_sweeps: int = 10_000,
              changed0: Optional[torch.Tensor] = None, impl: str = "ref",
              kernel=None) -> Tuple[torch.Tensor, RunStats]:
    """x0: (r_pad, B) — returns ((r_pad, B), RunStats)."""
    spec = _resolve_kernel(kernel, impl)
    x, stats = _run(p, x0[None], None if changed0 is None else changed0[None],
                    apply_kind, damping, tol, max_sweeps, spec, "async",
                    batched=False)
    return x[0], stats


def run_sync_batched(p: Prepared, x0: torch.Tensor,
                     apply_kind: str = "relax", damping: float = 0.85,
                     tol: float = 1e-6, max_sweeps: int = 10_000,
                     impl: str = "ref", kernel=None,
                     changed0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, RunStats]:
    """x0: (Q, r_pad, B) — returns ((Q, r_pad, B), aggregate RunStats):
    ``sweeps`` is the straggler's, work counters total the query axis."""
    spec = _resolve_kernel(kernel, impl)
    return _run(p, x0, changed0, apply_kind, damping, tol, max_sweeps,
                spec, "sync", batched=True)


def run_async_batched(p: Prepared, x0: torch.Tensor,
                      apply_kind: str = "relax", damping: float = 0.85,
                      tol: float = 1e-6, max_sweeps: int = 10_000,
                      changed0: Optional[torch.Tensor] = None,
                      impl: str = "ref", kernel=None
                      ) -> Tuple[torch.Tensor, RunStats]:
    """x0: (Q, r_pad, B); changed0: optional (Q, r_pad) per-query frontier."""
    spec = _resolve_kernel(kernel, impl)
    return _run(p, x0, changed0, apply_kind, damping, tol, max_sweeps,
                spec, "async", batched=True)
