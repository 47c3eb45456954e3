"""Graph containers and synthetic workload generators.

Host-side (numpy) preprocessing mirrors the paper's compile-time flow: the
application graph is profiled/extracted once, then clustered, placed and
compiled (see ``cluster.py`` / ``compile.py``).  Device-side formats are
static-shape and accelerator-friendly:

  * ``EllGraph``  — padded adjacency (row-major ELL), for neighbour-list
    algorithms (MiniTri intersections, DFS).
  * ``BsrGraph``  — ELL-of-dense-tiles block-sparse format produced by the
    clustering/reorder pass; the unit of NALE work is one BxB tile.

The paper evaluates on three graphs: CA road network, Facebook, LiveJournal.
Those datasets are not available offline, so ``road_network`` (grid +
shortcuts, avg degree ~1.4 directed) and ``rmat`` (power-law, FB/LJ-like)
generate stand-ins with matched vertex/edge statistics at configurable
scale.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from . import semiring as sr


@dataclasses.dataclass
class Graph:
    """Host-side CSR graph.  ``indptr``/``indices`` int64/int32 numpy."""

    n: int
    indptr: np.ndarray  # (n+1,)
    indices: np.ndarray  # (nnz,)
    weights: np.ndarray  # (nnz,) float32

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def avg_degree(self) -> float:
        return self.nnz / max(self.n, 1)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   weights: Optional[np.ndarray] = None,
                   dedup: bool = True) -> "Graph":
        if weights is None:
            weights = np.ones_like(src, dtype=np.float32)
        if dedup and len(src):
            key = src.astype(np.int64) * n + dst.astype(np.int64)
            _, keep = np.unique(key, return_index=True)
            src, dst, weights = src[keep], dst[keep], weights[keep]
        order = np.lexsort((dst, src))
        src, dst, weights = src[order], dst[order], weights[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return Graph(n=n, indptr=indptr, indices=dst.astype(np.int32),
                     weights=weights.astype(np.float32))

    def transpose(self) -> "Graph":
        src = np.repeat(np.arange(self.n, dtype=np.int32),
                        np.diff(self.indptr))
        return Graph.from_edges(self.n, self.indices.astype(np.int32),
                                src, self.weights, dedup=False)

    def to_undirected(self) -> "Graph":
        src = np.repeat(np.arange(self.n, dtype=np.int32),
                        np.diff(self.indptr))
        dst = self.indices.astype(np.int32)
        s = np.concatenate([src, dst])
        d = np.concatenate([dst, src])
        w = np.concatenate([self.weights, self.weights])
        return Graph.from_edges(self.n, s, d, w, dedup=True)

    def permute(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: new id of old vertex v is perm[v]."""
        src = np.repeat(np.arange(self.n, dtype=np.int32),
                        np.diff(self.indptr))
        return Graph.from_edges(self.n, perm[src].astype(np.int32),
                                perm[self.indices].astype(np.int32),
                                self.weights, dedup=False)

    def fingerprint(self) -> str:
        """Stable content hash of the graph (topology + weights).

        Used as the graph half of cross-process plan-store keys
        (``serve.graph.PlanStore``): two Graph objects with identical
        structure hash identically, so a restarted service can find the
        plans a previous process persisted.  Graphs are treated as
        immutable after construction; the digest is cached.
        """
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(np.int64(self.n).tobytes())
            h.update(np.ascontiguousarray(self.indptr,
                                          dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(self.indices,
                                          dtype=np.int32).tobytes())
            h.update(np.ascontiguousarray(self.weights,
                                          dtype=np.float32).tobytes())
            fp = self.__dict__["_fingerprint"] = h.hexdigest()
        return fp


# ---------------------------------------------------------------------------
# Device-side formats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EllGraph:
    """Padded neighbour lists: (n, k_max) arrays; pad col = n (sentinel)."""

    n: int
    k_max: int
    cols: np.ndarray    # (n, k_max) int32, padded with n
    vals: np.ndarray    # (n, k_max) float32, padded with pad_val
    deg: np.ndarray     # (n,) int32


def to_ell(g: Graph, pad_val: float = 0.0,
           k_max: Optional[int] = None) -> EllGraph:
    deg = np.diff(g.indptr).astype(np.int32)
    k = int(deg.max()) if k_max is None and g.n else (k_max or 1)
    k = max(k, 1)
    cols = np.full((g.n, k), g.n, dtype=np.int32)
    vals = np.full((g.n, k), pad_val, dtype=np.float32)
    for i in range(g.n):  # host-side, one-time preprocessing
        s, e = g.indptr[i], g.indptr[i + 1]
        cols[i, : e - s] = g.indices[s:e]
        vals[i, : e - s] = g.weights[s:e]
    return EllGraph(n=g.n, k_max=k, cols=cols, vals=vals, deg=deg)


def to_ell_fast(g: Graph, pad_val: float = 0.0) -> EllGraph:
    """Vectorized ELL conversion (no per-row python loop)."""
    deg = np.diff(g.indptr).astype(np.int32)
    k = max(int(deg.max()) if g.n else 1, 1)
    cols = np.full((g.n, k), g.n, dtype=np.int32)
    vals = np.full((g.n, k), pad_val, dtype=np.float32)
    rows = np.repeat(np.arange(g.n), deg)
    offs = np.arange(g.nnz) - np.repeat(g.indptr[:-1], deg)
    cols[rows, offs] = g.indices
    vals[rows, offs] = g.weights
    return EllGraph(n=g.n, k_max=k, cols=cols, vals=vals, deg=deg)


@dataclasses.dataclass
class BsrGraph:
    """ELL-of-tiles block-sparse matrix (the NALE work-unit container).

    Row-blocks of size ``b``; for row-block r, up to ``k_max`` nonempty
    column tiles.  Padding tiles point at col-block 0 and hold the
    semiring's ⊕-identity so they are arithmetic no-ops (the hardware
    analogue: an empty FIFO slot).
    """

    n: int              # logical vertex count (pre-padding)
    b: int              # tile edge size
    r: int              # number of row/col blocks  (n_pad / b)
    k_max: int          # max nonempty tiles per row-block
    block_cols: np.ndarray   # (r, k_max) int32
    block_vals: np.ndarray   # (r, k_max, b, b) float32
    block_nnz: np.ndarray    # (r,) int32 — nonempty tile count per row-block
    edge_nnz: np.ndarray     # (r,) int64 — true edge count per row-block
    pad_value: float

    @property
    def n_pad(self) -> int:
        return self.r * self.b

    @property
    def tiles(self) -> int:
        return int(self.block_nnz.sum())

    def density_stats(self) -> dict:
        """Tile fill statistics — measures how well clustering densified."""
        edges = float(self.edge_nnz.sum())
        tiles = max(self.tiles, 1)
        return {
            "tiles": self.tiles,
            "edges": edges,
            "fill": edges / (tiles * self.b * self.b),
            "tiles_per_rowblock_max": int(self.block_nnz.max()) if self.r else 0,
            "tiles_per_rowblock_mean": float(self.block_nnz.mean()) if self.r else 0.0,
        }


def to_bsr(g: Graph, b: int, pad_value: float = 0.0,
           semiring_name: str = "plus_times") -> BsrGraph:
    """Convert CSR → block-sparse tiles.  Use after cluster-reordering.

    ``pad_value`` must be the ⊕-identity of the target semiring so that
    padded tiles / absent intra-tile edges contribute nothing (for
    plus_times: 0; min_plus: +inf; max_min: 0).
    """
    pad_value = float(sr.get(semiring_name).zero) if pad_value is None else pad_value
    r = (g.n + b - 1) // b
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    rb, cb = src // b, dst // b
    tile_key = rb * r + cb
    uniq, tile_of_edge = np.unique(tile_key, return_inverse=True)
    u_rb, u_cb = uniq // r, uniq % r
    # tiles per row-block
    block_nnz = np.zeros(r, dtype=np.int32)
    np.add.at(block_nnz, u_rb, 1)
    k_max = max(int(block_nnz.max()) if len(uniq) else 1, 1)
    block_cols = np.zeros((r, k_max), dtype=np.int32)
    block_vals = np.full((r, k_max, b, b), pad_value, dtype=np.float32)
    # slot of each unique tile within its row-block (uniq is sorted by key,
    # hence grouped by rb in order)
    first_idx = np.searchsorted(u_rb, np.arange(r))
    slot = np.arange(len(uniq)) - first_idx[u_rb]
    block_cols[u_rb, slot] = u_cb.astype(np.int32)
    # scatter edge values into their tile
    e_slot = slot[tile_of_edge]
    block_vals[rb, e_slot, src % b, dst % b] = g.weights
    edge_nnz = np.zeros(r, dtype=np.int64)
    np.add.at(edge_nnz, rb, 1)
    return BsrGraph(n=g.n, b=b, r=r, k_max=k_max, block_cols=block_cols,
                    block_vals=block_vals, block_nnz=block_nnz,
                    edge_nnz=edge_nnz, pad_value=pad_value)


def bsr_to_dense(bsr: BsrGraph) -> np.ndarray:
    """Oracle-side densification (small graphs only)."""
    a = np.full((bsr.n_pad, bsr.n_pad), bsr.pad_value, dtype=np.float32)
    for rb in range(bsr.r):
        for k in range(int(bsr.block_nnz[rb])):
            cb = int(bsr.block_cols[rb, k])
            tile = bsr.block_vals[rb, k]
            cur = a[rb * bsr.b:(rb + 1) * bsr.b, cb * bsr.b:(cb + 1) * bsr.b]
            if bsr.pad_value == 0.0:
                a[rb * bsr.b:(rb + 1) * bsr.b,
                  cb * bsr.b:(cb + 1) * bsr.b] = cur + tile
            else:
                a[rb * bsr.b:(rb + 1) * bsr.b,
                  cb * bsr.b:(cb + 1) * bsr.b] = np.minimum(cur, tile)
    return a


# ---------------------------------------------------------------------------
# Synthetic workloads (paper §III stand-ins)
# ---------------------------------------------------------------------------


def rmat(n: int, nnz: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         weighted: bool = True) -> Graph:
    """R-MAT power-law generator — Facebook/LiveJournal-like topology."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    n_pow = 1 << scale
    m = int(nnz * 1.15) + 16  # oversample; dedup trims
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        quad = np.select(
            [r < a, r < a + b, r < a + b + c],
            [0, 1, 2], default=3)
        src = src * 2 + (quad >> 1)
        dst = dst * 2 + (quad & 1)
    keep = (src < n) & (dst < n) & (src != dst)
    src, dst = src[keep][:nnz], dst[keep][:nnz]
    w = (rng.random(len(src)).astype(np.float32) * 9 + 1) if weighted \
        else np.ones(len(src), dtype=np.float32)
    g = Graph.from_edges(n, src.astype(np.int32), dst.astype(np.int32), w)
    _ = n_pow
    return g


def road_network(side: int, seed: int = 0, extra_frac: float = 0.05,
                 weighted: bool = True) -> Graph:
    """Grid road network with sparse shortcuts — CA-road-like topology.

    A side×side lattice: avg out-degree ≈ 2 with lattice edges made
    directional at random (≈1.4 like CA road), plus a few long shortcuts
    (highways).
    """
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).ravel()
    right = vid.reshape(side, side)[:, :-1].ravel()
    down = vid.reshape(side, side)[:-1, :].ravel()
    src = np.concatenate([right, down])
    dst = np.concatenate([right + 1, down + side])
    # make ~70% of lattice edges one-way (matches CA avg degree ~1.4)
    fwd = rng.random(len(src)) < 0.7
    s = np.concatenate([src, dst[~fwd]])
    d = np.concatenate([dst, src[~fwd]])
    n_extra = int(extra_frac * n)
    es = rng.integers(0, n, n_extra)
    ed = rng.integers(0, n, n_extra)
    s = np.concatenate([s, es])
    d = np.concatenate([d, ed])
    keep = s != d
    s, d = s[keep], d[keep]
    w = (rng.random(len(s)).astype(np.float32) * 9 + 1) if weighted \
        else np.ones(len(s), dtype=np.float32)
    return Graph.from_edges(n, s.astype(np.int32), d.astype(np.int32), w)


def ring(n: int, weighted: bool = False) -> Graph:
    src = np.arange(n, dtype=np.int32)
    dst = (src + 1) % n
    w = np.ones(n, dtype=np.float32)
    return Graph.from_edges(n, src, dst, w)


def erdos(n: int, p: float, seed: int = 0, weighted: bool = True) -> Graph:
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < p
    np.fill_diagonal(m, False)
    src, dst = np.nonzero(m)
    w = (rng.random(len(src)).astype(np.float32) * 9 + 1) if weighted \
        else np.ones(len(src), dtype=np.float32)
    return Graph.from_edges(n, src.astype(np.int32), dst.astype(np.int32), w)


# Paper workload registry: name -> (generator, full-scale stats for models)
# Full-scale numbers are the paper's:  (vertices, edges)
PAPER_GRAPHS = {
    "ca": dict(kind="road", vertices=1_965_206, edges=2_766_607, avg_deg=1.41),
    "fb": dict(kind="rmat", vertices=2_937_612, edges=41_919_708, avg_deg=14.3),
    "lj": dict(kind="rmat", vertices=4_847_571, edges=85_702_475, avg_deg=17.6),
}


def make_paper_graph(name: str, scale: float = 1.0 / 256, seed: int = 0) -> Graph:
    """Generate a stand-in for a paper graph at ``scale`` of full size."""
    spec = PAPER_GRAPHS[name]
    n = max(int(spec["vertices"] * scale), 64)
    e = max(int(spec["edges"] * scale), 64)
    if spec["kind"] == "road":
        side = int(np.sqrt(n))
        return road_network(side, seed=seed)
    return rmat(n, e, seed=seed)
