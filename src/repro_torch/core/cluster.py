"""Clustering, reordering, placement analysis — paper Fig. 4, steps 1–4.

The paper's compile flow: profile → extract topology → **cluster nodes** →
**cluster dependency analysis** → **placement** → compile.  Clustering is
what makes the architecture scale: a NALE executes either one node or a
whole node cluster, and load balance across NALEs comes from balanced
clusters with small cuts.

On the accelerator the same pass does double duty:
  * the cluster order is a vertex *permutation* that densifies edges into
    B×B tiles (BSR) so each tile is dense work for one thread block;
  * the cluster → device assignment is the graph-shard placement, and the
    inter-cluster dependency weights size the halo traffic.

Everything here is one-time host-side preprocessing (numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .graph import Graph


@dataclasses.dataclass
class Clustering:
    num_clusters: int
    assign: np.ndarray        # (n,) int32 — cluster id per (old) vertex
    perm: np.ndarray          # (n,) int32 — new id of old vertex v
    sizes: np.ndarray         # (num_clusters,) int32
    schedule: np.ndarray      # (num_clusters,) int32 — async sweep order
    internal_edges: int
    cut_edges: int

    @property
    def cut_fraction(self) -> float:
        total = self.internal_edges + self.cut_edges
        return self.cut_edges / max(total, 1)

    def balance(self) -> float:
        """max/mean cluster size — 1.0 is perfect."""
        return float(self.sizes.max() / max(self.sizes.mean(), 1e-9))


def _bfs_order(g: Graph, und: Optional[Graph] = None,
               seed: int = 0) -> np.ndarray:
    """BFS vertex order over the undirected graph (RCM-flavoured: restarts
    pick the lowest-degree unvisited vertex, which tends to start at graph
    peripheries and keep bandwidth low)."""
    und = und or g.to_undirected()
    n = g.n
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    deg = und.out_degrees()
    pos = 0
    deg_order = np.argsort(deg, kind="stable")
    ptr = 0
    while pos < n:
        while ptr < n and visited[deg_order[ptr]]:
            ptr += 1
        if ptr >= n:
            rest = np.nonzero(~visited)[0]
            order[pos: pos + len(rest)] = rest
            break
        root = deg_order[ptr]
        # vectorized BFS frontier expansion
        frontier = np.array([root], dtype=np.int64)
        visited[root] = True
        order[pos] = root
        pos += 1
        while len(frontier):
            # gather all neighbours of the frontier (in frontier order —
            # RCM-style: children adopt their parent's position, which is
            # what keeps grid/planar graphs banded after relabeling)
            starts = und.indptr[frontier]
            ends = und.indptr[frontier + 1]
            counts = ends - starts
            if counts.sum() == 0:
                break
            idx = np.concatenate(
                [und.indices[s:e] for s, e in zip(starts, ends)])
            uniq, first_pos = np.unique(idx, return_index=True)
            live = ~visited[uniq]
            nxt = uniq[live][np.argsort(first_pos[live], kind="stable")]
            if len(nxt) == 0:
                break
            visited[nxt] = True
            order[pos: pos + len(nxt)] = nxt
            pos += len(nxt)
            frontier = nxt
    return order


def cluster_graph(g: Graph, num_clusters: int, seed: int = 0) -> Clustering:
    """Balanced BFS clustering + dependency-driven schedule.

    1. BFS-order vertices (locality: neighbours get nearby new ids).
    2. Chop the order into `num_clusters` equal contiguous chunks — balanced
       by construction (the paper's load-balancing requirement).
    3. Dependency analysis: weight W[c,d] = edges c→d; schedule clusters by
       BFS over the cluster DAG from high-out-degree roots, so a
       Gauss-Seidel sweep follows the direction information flows.
    """
    n = g.n
    num_clusters = max(1, min(num_clusters, n))
    order = _bfs_order(g, seed=seed)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    csize = (n + num_clusters - 1) // num_clusters
    assign = (perm // csize).astype(np.int32)
    sizes = np.bincount(assign, minlength=num_clusters).astype(np.int32)

    # cluster dependency matrix
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    cs, cd = assign[src], assign[g.indices]
    internal = int((cs == cd).sum())
    cut = int((cs != cd).sum())
    w = np.zeros((num_clusters, num_clusters), dtype=np.int64)
    np.add.at(w, (cs, cd), 1)
    np.fill_diagonal(w, 0)

    # schedule: BFS over cluster graph from the cluster holding vertex
    # new-id 0 (a BFS root), following dependency edges.
    sched = []
    seen = np.zeros(num_clusters, dtype=bool)
    frontier = [0]
    seen[0] = True
    while frontier:
        sched.extend(frontier)
        nxt_mask = (w[frontier].sum(axis=0) > 0) & ~seen
        nxt = list(np.nonzero(nxt_mask)[0])
        seen[nxt] = True
        frontier = nxt
    rest = list(np.nonzero(~seen)[0])
    sched.extend(rest)
    schedule = np.array(sched, dtype=np.int32)

    return Clustering(num_clusters=num_clusters, assign=assign,
                      perm=perm.astype(np.int64), sizes=sizes,
                      schedule=schedule, internal_edges=internal,
                      cut_edges=cut)


def identity_clustering(g: Graph, num_clusters: int) -> Clustering:
    """No-reorder baseline (what a naive mapping would do)."""
    n = g.n
    num_clusters = max(1, min(num_clusters, n))
    csize = (n + num_clusters - 1) // num_clusters
    assign = (np.arange(n) // csize).astype(np.int32)
    sizes = np.bincount(assign, minlength=num_clusters).astype(np.int32)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    cs, cd = assign[src], assign[g.indices]
    return Clustering(num_clusters=num_clusters, assign=assign,
                      perm=np.arange(n, dtype=np.int64), sizes=sizes,
                      schedule=np.arange(num_clusters, dtype=np.int32),
                      internal_edges=int((cs == cd).sum()),
                      cut_edges=int((cs != cd).sum()))


def place_clusters(c: Clustering, num_devices: int) -> np.ndarray:
    """Placement (Fig. 4 step 4): clusters → devices, balancing vertex load
    greedily while keeping schedule-adjacent clusters together (adjacent
    clusters exchange the most halo traffic under BFS ordering)."""
    per = np.zeros(num_devices, dtype=np.int64)
    placement = np.zeros(c.num_clusters, dtype=np.int32)
    # contiguous chunks of the schedule, greedily balanced by size
    target = c.sizes.sum() / num_devices
    dev = 0
    for cid in c.schedule:
        if per[dev] >= target and dev < num_devices - 1:
            dev += 1
        placement[cid] = dev
        per[dev] += c.sizes[cid]
    return placement


def tile_stats_after(g: Graph, c: Clustering, b: int) -> dict:
    """How much does the clustering densify B×B tiles vs identity order?"""
    from .graph import to_bsr
    g2 = g.permute(c.perm.astype(np.int32))
    bsr0 = to_bsr(g, b)
    bsr1 = to_bsr(g2, b)
    return {
        "tiles_identity": bsr0.tiles,
        "tiles_clustered": bsr1.tiles,
        "fill_identity": bsr0.density_stats()["fill"],
        "fill_clustered": bsr1.density_stats()["fill"],
        "tile_reduction": bsr0.tiles / max(bsr1.tiles, 1),
    }
