"""Reference (numpy) implementations of the paper's algorithms — test
oracles, and the "conventional CPU execution" semantics for the models."""

from __future__ import annotations

import heapq

import numpy as np

from .graph import Graph


def pagerank_oracle(g: Graph, damping: float = 0.85, tol: float = 1e-8,
                    max_iter: int = 500,
                    dangling: str = "drop") -> np.ndarray:
    """Power iteration.  dangling="drop" matches the engine semantics
    (no dangling-mass redistribution, final L1 renormalization)."""
    n = g.n
    outdeg = np.diff(g.indptr)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    x = np.full(n, 1.0 / n)
    src = np.repeat(np.arange(n), outdeg)
    for _ in range(max_iter):
        contrib = x[src] * inv[src]
        y = np.zeros(n)
        np.add.at(y, g.indices, contrib)
        dm = x[outdeg == 0].sum() if dangling == "redistribute" else 0.0
        x_new = (1 - damping) / n + damping * (y + dm / n)
        if np.max(np.abs(x_new - x)) <= tol:
            x = x_new
            break
        x = x_new
    if dangling == "drop":
        x = x / x.sum()
    return x


def sssp_oracle(g: Graph, src: int) -> np.ndarray:
    dist = np.full(g.n, np.inf)
    dist[src] = 0.0
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for e in range(g.indptr[u], g.indptr[u + 1]):
            v, w = g.indices[e], g.weights[e]
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, int(v)))
    return dist


def bfs_oracle(g: Graph, src: int) -> np.ndarray:
    level = np.full(g.n, np.inf)
    level[src] = 0
    frontier = [src]
    d = 0
    while frontier:
        nxt = []
        for u in frontier:
            for e in range(g.indptr[u], g.indptr[u + 1]):
                v = g.indices[e]
                if level[v] == np.inf:
                    level[v] = d + 1
                    nxt.append(int(v))
        frontier = nxt
        d += 1
    return level


def cc_oracle(g: Graph) -> np.ndarray:
    """Union-find component labels (canonical: min vertex id in component)."""
    parent = np.arange(g.n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    for u, v in zip(src, g.indices):
        ru, rv = find(u), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(i) for i in range(g.n)])


def kcore_oracle(g: Graph, k: int) -> np.ndarray:
    """k-core membership (1.0 if the vertex survives peeling, else 0.0).

    Classic peeling on the undirected graph: repeatedly delete vertices
    with fewer than k live neighbours until a fixed point.
    """
    und = g.to_undirected()
    src = np.repeat(np.arange(und.n), np.diff(und.indptr))
    alive = np.ones(und.n, dtype=bool)
    while True:
        cnt = np.zeros(und.n, dtype=np.int64)
        live_edge = alive[src] & alive[und.indices]
        np.add.at(cnt, src[live_edge], 1)
        new = alive & (cnt >= k)
        if np.array_equal(new, alive):
            break
        alive = new
    return alive.astype(np.float32)


def tricount_oracle(g: Graph) -> np.ndarray:
    """Per-vertex triangle counts (dense adjacency; each triangle
    contributes 1 to each of its three corners)."""
    und = g.to_undirected()
    a = np.zeros((und.n, und.n), dtype=np.int64)
    src = np.repeat(np.arange(und.n), np.diff(und.indptr))
    a[src, und.indices] = 1
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0)
    return ((a @ a) * a).sum(axis=1) // 2


def triangles_oracle(g: Graph) -> int:
    und = g.to_undirected()
    a = np.zeros((und.n, und.n), dtype=np.int64)
    src = np.repeat(np.arange(und.n), np.diff(und.indptr))
    a[src, und.indices] = 1
    return int(np.trace(a @ a @ a) // 6)


def dfs_oracle(g: Graph, src: int):
    """Iterative DFS visiting lowest-id neighbour first (matches engine)."""
    visited = np.zeros(g.n, dtype=bool)
    order, parent = [], np.full(g.n, -1)
    stack = [(src, -1)]
    while stack:
        u, pu = stack.pop()
        if visited[u]:
            continue
        visited[u] = True
        parent[u] = pu
        order.append(u)
        nbrs = sorted(g.indices[g.indptr[u]:g.indptr[u + 1]].tolist())
        for v in reversed(nbrs):
            if not visited[v]:
                stack.append((int(v), u))
    return np.array(order), parent
