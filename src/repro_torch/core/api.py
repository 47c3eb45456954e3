"""Session API — prepare once, query many (paper Fig. 4 split).

``GraphProcessor`` builds the session; each query then runs against
cached ``Prepared`` images — the clustering/permutation and the
device-resident BSR tiles are shared by every algorithm that can use the
same plan (keyed by semiring, graph variant, direction, normalization and
tiling), so serving many queries on one graph pays the compile-time
pipeline once.

    proc = GraphProcessor(g, b=16, num_clusters=64)   # device="cuda"
    pr   = proc.pagerank()                       # prepares plus_times plan
    d    = proc.sssp(0)                          # prepares min_plus plan
    d2   = proc.sssp(5)                          # plan-cache hit: no rework
    dist = proc.sssp(sources=[0, 5, 9])          # batched: one query axis

The session runs on ``cuda`` unless ``device=`` names another device (the
tests pass ``device="cpu"``); without a card and without a device it
raises.  MiniTri intersects its sorted neighbour table on the session's
device; tricount and DFS run on the host in both packages (numpy, and a
Python stack machine: DFS is serial by nature).  ``mode="distributed"``
runs the engines of ``core/placement.py`` and ``core/async_dist.py`` on
the default mesh: every card when the session is on one, else one slot
on the session's device.  ``KernelSpec(impl="pallas", autotune=True)``
measures the compacted kernels' launch knobs on the plan
(``kernels/autotune.py``) once per (plan, spec), caches the record beside
the plan (in the ``PlanStore`` when the session has one, so it survives a
restart) and runs every query of that spec on the winner.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import async_dist
from . import engine as eng
from . import placement
from .algorithms import (AlgorithmSpec, get_algorithm,  # noqa: F401
                         register_algorithm, registered_algorithms)
from .engine import Prepared, RunStats, resolve_device
from .graph import Graph, to_ell_fast
from ..kernels.spec import KernelSpec, as_kernel_spec

MODES = ("sync", "async", "distributed")
DIST_FLAVORS = ("sync", "async")


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How a query executes — the same fields, normalization and
    validation as the JAX package's ``ExecutionPolicy``.

    mode:  "sync" (BSP/Jacobi baseline) | "async" (the paper's self-timed
           cluster-dataflow engine) | "distributed" (the engines over a
           (graph, query) mesh of devices, ``core/placement.py``).
    kernel:  a ``kernels.spec.KernelSpec``; None derives one from ``impl``.
    impl:  deprecated alias for ``kernel=KernelSpec(impl=...)``.  After
           construction ``impl`` always equals ``kernel.impl``.
    query_axis / dist_flavor / local_sweeps:  distributed-engine knobs,
           validated as in the JAX package.
    degrade:  graceful-degradation ladder (True by default): when an
           engine run fails, ``GraphProcessor.run`` retries one rung
           down (fused/pallas → ref), recording each step in
           ``Result.extra["degraded"]``.  ValueError/TypeError/KeyError/
           IndexError never degrade.  ``degrade=False`` fails fast.
    """

    mode: str = "async"
    impl: Optional[str] = None
    damping: float = 0.85
    tol: float = 1e-6
    max_sweeps: int = 10_000
    query_axis: Optional[int] = None
    dist_flavor: str = "sync"
    local_sweeps: int = 1
    kernel: Optional[KernelSpec] = None
    degrade: bool = True

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}: {self.mode!r}")
        if self.kernel is not None and not isinstance(self.kernel,
                                                      KernelSpec):
            object.__setattr__(self, "kernel", as_kernel_spec(self.kernel))
        if self.kernel is None:
            impl = self.impl if self.impl is not None else "ref"
            if impl == "pallas":
                warnings.warn(
                    "ExecutionPolicy(impl='pallas') is deprecated; pass "
                    "kernel=KernelSpec(impl='pallas', ...) to reach the "
                    "tiling/fusion/autotune surface",
                    DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "kernel", KernelSpec(impl=impl))
            object.__setattr__(self, "impl", impl)
        else:
            if self.impl is not None and self.impl != self.kernel.impl:
                raise ValueError(
                    f"impl={self.impl!r} conflicts with kernel.impl="
                    f"{self.kernel.impl!r}; set only kernel= (impl= is "
                    "the deprecated alias)")
            object.__setattr__(self, "impl", self.kernel.impl)
        if self.mode == "distributed" and self.kernel.impl != "ref":
            raise ValueError(
                "the distributed engine shard_maps the ref kernel; "
                "Pallas calls cannot be SPMD-partitioned — use "
                "mode='sync'/'async' for kernel.impl='pallas'")
        if self.query_axis is not None and self.query_axis < 0:
            raise ValueError(
                "query_axis must be None (auto), 0 (per-source "
                f"fallback) or a positive extent: {self.query_axis!r}")
        if self.dist_flavor not in DIST_FLAVORS:
            raise ValueError(
                f"dist_flavor must be one of {DIST_FLAVORS}: "
                f"{self.dist_flavor!r}")
        if self.local_sweeps < 1:
            raise ValueError(
                f"local_sweeps must be >= 1, got {self.local_sweeps!r}")
        if self.dist_flavor == "async" and self.mode != "distributed":
            raise ValueError(
                "dist_flavor='async' selects the self-timed distributed "
                f"engine and requires mode='distributed', not "
                f"{self.mode!r}")
        if self.local_sweeps != 1 and self.dist_flavor != "async":
            raise ValueError(
                f"local_sweeps={self.local_sweeps} needs "
                "dist_flavor='async'; the bulk-synchronous engine "
                "exchanges every sweep by construction")
        if self.dist_flavor == "async" and self.query_axis == 0:
            raise ValueError(
                "query_axis=0 (per-source sequential fallback) has no "
                "async flavor; use query_axis=None or a mesh extent")

    def but(self, **kw) -> "ExecutionPolicy":
        """Copy with overrides (policy objects are frozen).

        Overriding ``impl=`` or ``kernel=`` alone re-derives the other
        half of the normalized pair."""
        if "impl" in kw and "kernel" not in kw:
            kw["kernel"] = None
        elif "kernel" in kw and "impl" not in kw:
            kw["impl"] = None
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Everything that determines a ``Prepared`` image for one graph;
    with the graph's :meth:`Graph.fingerprint` it is globally unique."""

    semiring: str
    variant: str          # base | unit | undirected | unit_undirected
    pull: bool
    normalize: Optional[str]
    b: int
    num_clusters: Optional[int]
    clustered: bool
    seed: int = 0         # clustering seed (part of plan identity)
    # Prepared images are kernel-agnostic and keyed with kernel=None;
    # tuning records ride the same store under replace(key, kernel=spec)
    kernel: Optional[KernelSpec] = None


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One query against a session: algorithm + sources + policy.

    ``params`` are policy-field overrides applied over ``policy``; a
    plain dict is normalized to sorted tuples so the spec stays hashable.
    """

    algo: str
    sources: Tuple[int, ...] = ()
    batched: bool = False                       # sources is a query axis
    policy: Optional[ExecutionPolicy] = None    # None → session default
    params: Union[Mapping[str, float],
                  Tuple[Tuple[str, float], ...]] = ()

    def __post_init__(self):
        get_algorithm(self.algo)
        items = self.params.items() if isinstance(self.params, Mapping) \
            else ((str(k), v) for k, v in self.params)
        object.__setattr__(self, "params", tuple(sorted(items)))


@dataclasses.dataclass
class Result:
    """Uniform query result.  ``values`` is per-vertex output in ORIGINAL
    vertex ids — shape (n,) for single queries, (Q, n) for batched."""

    values: np.ndarray
    stats: RunStats
    prepared: Optional[Prepared]
    extra: dict
    policy: Optional[ExecutionPolicy] = None
    graph: Optional[Graph] = None

    def platform_models(self, sync_stats: Optional[RunStats] = None
                        ) -> dict:
        """Analytical NALE/CPU/GPU models (core/power.py) for this run:
        the paper's platforms, not the GPU the port runs on.

        The GPU model needs bulk-synchronous sweep counts; it is included
        when this result is already sync or when ``sync_stats`` is given.
        """
        from . import power as PW
        if self.prepared is None:
            raise ValueError(
                f"{self.extra.get('algo', 'this')} result has no BSR "
                "image; platform models need a prepared plan")
        rep = {"nale": PW.model_nale(self.prepared, self.stats),
               "cpu": PW.model_cpu(self.prepared, self.stats)}
        ss = sync_stats or (self.stats if self.stats.mode == "sync"
                            else None)
        if ss is not None and self.graph is not None:
            k_pad = max(float(np.diff(self.graph.indptr).max()), 1.0)
            rep["gpu"] = PW.model_gpu(self.prepared, ss, k_max_pad=k_pad,
                                      avg_degree=self.graph.avg_degree)
        return rep


def validate_spec(spec: QuerySpec) -> None:
    """Raise on specs that can never execute."""
    a = get_algorithm(spec.algo)
    if a.source_required and not spec.sources:
        raise ValueError(
            f"{spec.algo} requires at least one source vertex")
    given = dict(spec.params)
    missing = [k for k in a.required_params if k not in given]
    if missing:
        raise ValueError(
            f"{spec.algo} requires params={{{', '.join(repr(m) for m in missing)}: ...}}"
            f" (e.g. QuerySpec(algo={spec.algo!r}, "
            f"params={{{missing[0]!r}: 2}}))")
    if len(spec.sources) > 1 and not spec.batched:
        raise ValueError(
            f"{len(spec.sources)} sources with batched=False would "
            "silently run only the first; set batched=True (or submit "
            "one spec per source)")


def _policy_desc(pol: ExecutionPolicy) -> str:
    """Short human tag for a degradation step record."""
    tag = f"{pol.mode}/{pol.kernel.impl}"
    if pol.kernel.fuse_frontier:
        tag += "+fused"
    if pol.mode == "distributed":
        tag += f"/{pol.dist_flavor}"
    return tag


def degrade_policy(pol: ExecutionPolicy) -> Optional[ExecutionPolicy]:
    """One rung down the graceful-degradation ladder, or None at the
    bottom: a pallas/fused kernel → the ``ref`` kernel (same mode; same
    values), then ``mode="distributed"`` → ``mode="sync"``."""
    if pol.kernel is not None and pol.kernel.impl != "ref":
        return pol.but(kernel=KernelSpec(impl="ref"))
    if pol.mode == "distributed":
        return pol.but(mode="sync", dist_flavor="sync", local_sweeps=1,
                       query_axis=None)
    return None


class GraphProcessor:
    """Prepare-once / query-many session over one graph.

    Holds a plan cache of ``Prepared`` images keyed by ``PlanKey`` so
    repeated and cross-algorithm queries share the compile-time pipeline
    (clustering, permutation, BSR build, device upload), plus derived
    graph variants (unit-weight, undirected) built at most once.  Plans
    live on ``device`` (``cuda`` unless named).

    When ``store`` (a ``serve.graph.PlanStore``) is injected, plans are
    borrowed from it instead of owned: every ``prepare`` consults the
    shared store under ``(graph_fingerprint, PlanKey)``, so plans are
    shared across processors, across the graphs of one ``GraphService``
    and, through the store's disk tier, across process restarts.
    Eviction then lives in the store alone; the processor keeps no
    private copy.
    """

    def __init__(self, g: Graph, b: int = 32,
                 num_clusters: Optional[int] = None, clustered: bool = True,
                 seed: int = 0, policy: Optional[ExecutionPolicy] = None,
                 store=None, device=None):
        self.device = resolve_device(device)
        self.g = g
        self.b = b
        self.num_clusters = num_clusters
        self.clustered = clustered
        self.seed = seed
        self.policy = policy or ExecutionPolicy()
        self.store = store
        self._plans: Dict[PlanKey, Prepared] = {}
        self._tunings: Dict[PlanKey, dict] = {}  # session-local fallback
        self._variants: Dict[str, Graph] = {"base": g}
        self._prepare_calls = 0
        self._autotune_calls = 0
        # one tuning measured at a time: a key's record is looked up again
        # under the lock, so concurrent first queries measure it once
        self._tuning_lock = threading.Lock()

    # -- compile-time pipeline (cached) ---------------------------------

    def _variant(self, name: str) -> Graph:
        if name not in self._variants:
            g = self.g
            if name == "unit":
                self._variants[name] = Graph(
                    n=g.n, indptr=g.indptr, indices=g.indices,
                    weights=np.ones(g.nnz, dtype=np.float32))
            elif name == "undirected":
                self._variants[name] = g.to_undirected()
            elif name == "unit_undirected":
                und = self._variant("undirected")
                self._variants[name] = Graph(
                    n=und.n, indptr=und.indptr, indices=und.indices,
                    weights=np.ones(und.nnz, dtype=np.float32))
            else:
                raise ValueError(f"unknown graph variant {name!r}")
        return self._variants[name]

    def plan_key(self, semiring: str, variant: str = "base",
                 pull: bool = True, normalize: Optional[str] = None
                 ) -> PlanKey:
        return PlanKey(semiring, variant, pull, normalize, self.b,
                       self.num_clusters, self.clustered, self.seed)

    def prepare(self, semiring: str, variant: str = "base",
                pull: bool = True, normalize: Optional[str] = None,
                kernel: Optional[KernelSpec] = None) -> Prepared:
        """Fetch (or build and cache) the Prepared image for a plan.

        With an injected store the lookup (and the LRU and byte
        accounting) is delegated; without one, plans live in a
        session-local dict.  Passing a ``kernel`` with ``autotune=True``
        also runs (or fetches) the measured tuning sweep now, so the
        first query pays no calibration latency."""
        key = self.plan_key(semiring, variant, pull, normalize)
        if self.store is not None:
            p = self.store.get(self.g.fingerprint(), key)
            if p is None:
                self._prepare_calls += 1
                p = self._build(semiring, variant, pull, normalize)
                self.store.put(self.g.fingerprint(), key, p)
        else:
            p = self._plans.get(key)
            if p is None:
                self._prepare_calls += 1
                p = self._build(semiring, variant, pull, normalize)
                self._plans[key] = p
        if kernel is not None and kernel.autotune:
            self._ensure_tuning(p, key, kernel)
        return p

    def _build(self, semiring: str, variant: str, pull: bool,
               normalize: Optional[str]) -> Prepared:
        return eng.prepare(self._variant(variant), semiring, b=self.b,
                           num_clusters=self.num_clusters, pull=pull,
                           clustered=self.clustered, normalize=normalize,
                           seed=self.seed, device=self.device)

    def cache_info(self) -> dict:
        info = {"plans": len(self._plans),
                "prepare_calls": self._prepare_calls,
                "autotune_calls": self._autotune_calls,
                "tunings": len(self._tunings),
                "keys": list(self._plans)}
        if self.store is not None:
            info["store"] = self.store.stats()
        return info

    # -- measured kernel tunings (cached beside the plan) ----------------

    def _ensure_tuning(self, p: Prepared, key: PlanKey,
                       spec: KernelSpec) -> dict:
        """Fetch-or-measure the tuning record for (plan, spec).  Records
        ride the plan store's ``(fingerprint, PlanKey)`` scheme under
        ``replace(base_key, kernel=spec)`` so warm restarts reuse them;
        without a store they live for the session.  Measured once per
        key: the lookup is repeated under the store's (or the session's)
        tuning lock before measuring."""
        from ..kernels import autotune as at
        tkey = dataclasses.replace(key, kernel=spec)
        store = self.store
        fp = None if store is None else self.g.fingerprint()
        lock = self._tuning_lock if store is None else store.tuning_lock

        def get():
            return (self._tunings.get(tkey) if store is None
                    else store.get_tuning(fp, tkey))

        rec = get()
        if rec is None:
            with lock:
                rec = get()
                if rec is None:
                    self._autotune_calls += 1
                    rec = at.autotune_spmv(p, spec, seed=self.seed)
                    if store is None:
                        self._tunings[tkey] = rec
                    else:
                        store.put_tuning(fp, tkey, rec)
        return rec

    def _kernel_for_run(self, p: Prepared, key: PlanKey,
                        spec: KernelSpec) -> KernelSpec:
        """The concrete spec a query executes: autotuned knobs filled in
        from the cached (or freshly measured) tuning record."""
        if spec.impl != "pallas" or not spec.autotune:
            return spec
        return spec.concrete(self._ensure_tuning(p, key, spec))

    # -- unified run entry point ----------------------------------------

    def resolve_policy(self, spec: QuerySpec) -> ExecutionPolicy:
        """The effective policy for a spec: explicit policy (or session
        default merged with the algorithm's registered defaults), then
        ``params`` overrides translated through the algorithm's
        ``param_map``."""
        a = get_algorithm(spec.algo)
        pol = spec.policy or self.policy.but(**dict(a.default_policy))
        if spec.params:
            pm = dict(a.param_map)
            pol = pol.but(**{pm.get(k, k): v
                             for k, v in dict(spec.params).items()})
        return pol

    def run(self, spec: QuerySpec) -> Result:
        """Execute one QuerySpec.  All algorithm methods route here.

        Run-time engine failures walk the graceful-degradation ladder
        (see :func:`degrade_policy`) while ``policy.degrade`` is set;
        ValueError/TypeError/KeyError/IndexError always propagate.
        """
        validate_spec(spec)
        a = get_algorithm(spec.algo)
        pol = self.resolve_policy(spec)
        if a.runner is not None:
            return getattr(self, a.runner)(spec, pol)
        steps: list = []
        while True:
            try:
                res = self._execute(spec, pol)
            except (ValueError, TypeError, KeyError, IndexError):
                raise
            except Exception as e:
                nxt = degrade_policy(pol) if pol.degrade else None
                if nxt is None:
                    raise
                steps.append({"from": _policy_desc(pol),
                              "to": _policy_desc(nxt),
                              "error": f"{type(e).__name__}: {e}"})
                pol = nxt
                continue
            if steps:
                res.extra["degraded"] = steps
            return res

    def _execute(self, spec: QuerySpec, pol: ExecutionPolicy) -> Result:
        """One engine attempt at (spec, pol)."""
        p, key, x0f, pad, apply_kind, post = self._relaxation_setup(
            spec, pol)
        kern = self._kernel_for_run(p, key, pol.kernel)
        if spec.batched:
            return self._run_batched(spec, pol, p, x0f, pad, apply_kind,
                                     post, kern)
        src = spec.sources[0] if spec.sources else None
        x0 = p.to_blocks(x0f(src), pad)
        x, stats, extra = self._dispatch(pol, p, x0, apply_kind, src, kern)
        values = post(p.from_blocks(x))
        extra = dict(extra, algo=spec.algo,
                     **({"src": src} if src is not None else {}))
        return Result(values, stats, p, extra, policy=pol, graph=self.g)

    def _relaxation_setup(self, spec: QuerySpec, pol: ExecutionPolicy):
        """Returns (Prepared, PlanKey, x0_builder(src), pad, apply_kind,
        post) — all read off the algorithm's registered
        ``AlgorithmSpec``."""
        a = get_algorithm(spec.algo)
        key = self.plan_key(a.semiring, variant=a.variant, pull=a.pull,
                            normalize=a.normalize)
        p = self.prepare(a.semiring, variant=a.variant, pull=a.pull,
                         normalize=a.normalize)
        pad = float(a.ring.zero) if a.pad is None else a.pad
        post = a.post if a.post is not None else (lambda v: v)
        return p, key, (lambda src: a.init(p, src, pol)), pad, a.update, \
            post

    def _frontier(self, p: Prepared, src: Optional[int]) -> torch.Tensor:
        """Initial changed-set: just the source's row-block when there is
        a point source, else everything (built on the host)."""
        ch = np.zeros(p.r_pad, dtype=bool)
        if src is None:
            ch[:] = True
        else:
            ch[int(p.perm[src]) // p.b] = True
        return torch.from_numpy(ch).to(p.device)

    def _dispatch(self, pol: ExecutionPolicy, p: Prepared, x0,
                  apply_kind: str, src: Optional[int],
                  kern: Optional[KernelSpec] = None):
        """One single-source engine run: (x, RunStats, extra); ``kern``
        is the concrete spec (``_kernel_for_run``), else the policy's."""
        kern = kern if kern is not None else pol.kernel
        kw = dict(apply_kind=apply_kind, damping=pol.damping, tol=pol.tol,
                  max_sweeps=pol.max_sweeps)
        if pol.mode == "sync":
            ch0 = self._frontier(p, src) if kern.fuse_frontier else None
            x, stats = eng.run_sync(p, x0, kernel=kern, changed0=ch0, **kw)
            return x, stats, {}
        if pol.mode == "async":
            x, stats = eng.run_async(p, x0, kernel=kern,
                                     changed0=self._frontier(p, src), **kw)
            return x, stats, {}
        # distributed: the mesh engines run the ref kernel's registration
        # (core/placement.py), the compacted hand kernel on the card at its
        # default knobs, as repro's shard_map runs its ref kernel; the
        # policy requires impl="ref", so no tuning applies.  dist_flavor
        # picks the exchange schedule: "sync" = bulk-synchronous (one
        # exchange per sweep), "async" = self-timed k-local-sweep engine.
        if pol.dist_flavor == "async":
            x, dist = async_dist.distributed_async_run(
                p, x0, local_sweeps=pol.local_sweeps, **kw)
            return x, eng.dist_run_stats(p, dist), {"dist": dist}
        x, dist = placement.distributed_sync_run(p, x0, **kw)
        stats = eng.bsp_stats(p, dist.sweeps, dist.converged, "distributed",
                              host_syncs=dist.host_syncs)
        return x, stats, {"dist": dist}

    def _run_batched(self, spec: QuerySpec, pol: ExecutionPolicy,
                     p: Prepared, x0f, pad, apply_kind, post,
                     kern: Optional[KernelSpec] = None) -> Result:
        kern = kern if kern is not None else pol.kernel
        sources = list(spec.sources)
        if not sources:
            raise ValueError("batched query needs at least one source")
        if pol.mode == "distributed" and pol.query_axis == 0:
            return self._run_batched_dist_fallback(
                spec, pol, p, x0f, pad, apply_kind, post, sources)
        x0 = torch.stack([p.to_blocks(x0f(s), pad) for s in sources])
        extra = {"algo": spec.algo, "sources": sources}
        kw = dict(apply_kind=apply_kind, damping=pol.damping, tol=pol.tol,
                  max_sweeps=pol.max_sweeps)
        if pol.mode == "distributed":
            # one round loop over the 2-D mesh: rows over "graph", the
            # query axis over "query".  Bit-identical to the per-source
            # path; `sweeps` is the straggler's, work counters total the
            # query axis.
            if pol.dist_flavor == "async":
                x, dist = async_dist.distributed_async_run_batched(
                    p, x0, query_axis=pol.query_axis,
                    local_sweeps=pol.local_sweeps, **kw)
                stats = eng.dist_run_stats(p, dist)
            else:
                x, dist = placement.distributed_sync_run_batched(
                    p, x0, query_axis=pol.query_axis, **kw)
                stats = eng.bsp_stats(
                    p, dist.sweeps, dist.converged, "distributed",
                    work_sweeps=int(dist.query_sweeps.sum()),
                    host_syncs=dist.host_syncs)
            extra["dist"] = dist
        elif pol.mode == "async":
            ch0 = torch.stack([self._frontier(p, s) for s in sources])
            x, stats = eng.run_async_batched(p, x0, kernel=kern,
                                             changed0=ch0, **kw)
        else:
            ch0 = (torch.stack([self._frontier(p, s) for s in sources])
                   if kern.fuse_frontier else None)
            x, stats = eng.run_sync_batched(p, x0, kernel=kern,
                                            changed0=ch0, **kw)
        values = np.stack([post(p.from_blocks(x[q]))
                           for q in range(len(sources))])
        return Result(values, stats, p, extra, policy=pol, graph=self.g)

    def _run_batched_dist_fallback(self, spec, pol, p, x0f, pad,
                                   apply_kind, post, sources) -> Result:
        """``query_axis=0`` escape hatch: the per-source loop through the
        single-source distributed engine, kept for debugging mesh
        factorizations against a known-serial reference — the default
        batched path is one 2-D round loop."""
        xs, sweeps, conv, syncs = [], [], [], 0
        for s in sources:
            x0q = p.to_blocks(x0f(s), pad)
            xq, st, _ = self._dispatch(pol, p, x0q, apply_kind, s)
            xs.append(xq)
            sweeps.append(st.sweeps)
            conv.append(st.converged)
            syncs += st.host_syncs
        stats = eng.bsp_stats(p, max(sweeps), all(conv),
                              "distributed", work_sweeps=sum(sweeps),
                              host_syncs=syncs)
        values = np.stack([post(p.from_blocks(xq)) for xq in xs])
        extra = {"algo": spec.algo, "sources": sources,
                 "batched_fallback": "per-source sequential"}
        return Result(values, stats, p, extra, policy=pol,
                      graph=self.g)

    # -- the algorithm catalog (registry-backed convenience methods) -----

    def _spec(self, algo: str, sources, policy, **params) -> QuerySpec:
        batched = sources is not None and not np.isscalar(sources)
        srcs = (tuple(int(s) for s in sources) if batched
                else ((int(sources),) if sources is not None else ()))
        params = {k: v for k, v in params.items() if v is not None}
        if params:
            base = policy or self.policy.but(
                **dict(get_algorithm(algo).default_policy))
            policy = base.but(**params)
        return QuerySpec(algo=algo, sources=srcs, batched=batched,
                         policy=policy)

    def pagerank(self, damping: Optional[float] = None,
                 tol: Optional[float] = None,
                 max_sweeps: Optional[int] = None,
                 policy: Optional[ExecutionPolicy] = None) -> Result:
        """Convergence kwargs override the (given or session) policy;
        defaults are damping=0.85, tol=1e-8, max_sweeps=500."""
        return self.run(self._spec("pagerank", None, policy,
                                   damping=damping, tol=tol,
                                   max_sweeps=max_sweeps))

    def pagerank_delta(self, damping: Optional[float] = None,
                       tol: Optional[float] = None,
                       max_sweeps: Optional[int] = None,
                       policy: Optional[ExecutionPolicy] = None) -> Result:
        """Delta-accumulating PageRank: ranks only rise from the
        (1-damping)/n floor, so the update is async-eligible."""
        return self.run(self._spec("pagerank_delta", None, policy,
                                   damping=damping, tol=tol,
                                   max_sweeps=max_sweeps))

    def sssp(self, sources: Union[int, Sequence[int]],
             policy: Optional[ExecutionPolicy] = None) -> Result:
        """Single-source (int) or batched multi-source (sequence)."""
        return self.run(self._spec("sssp", sources, policy))

    def bfs(self, sources: Union[int, Sequence[int]],
            policy: Optional[ExecutionPolicy] = None) -> Result:
        res = self.run(self._spec("bfs", sources, policy))
        res.extra["levels"] = res.values
        return res

    def connected_components(
            self, policy: Optional[ExecutionPolicy] = None) -> Result:
        return self.run(self._spec("cc", None, policy))

    def kcore(self, k: float,
              policy: Optional[ExecutionPolicy] = None) -> Result:
        """k-core membership: values[v] is 1.0 iff v survives peeling."""
        return self.run(QuerySpec(algo="kcore", policy=policy,
                                  params={"k": float(k)}))

    def reachability(self, src: int,
                     policy: Optional[ExecutionPolicy] = None) -> Result:
        return self.run(self._spec("reachability", src, policy))

    def minitri(self, policy: Optional[ExecutionPolicy] = None,
                chunk: int = 65536) -> Result:
        del policy  # one-shot data-parallel: engine policy does not apply
        return self._minitri(chunk)

    def tricount(self, policy: Optional[ExecutionPolicy] = None,
                 chunk: int = 65536) -> Result:
        """Per-vertex triangle counts (each triangle credits its three
        corners once)."""
        del policy  # one-shot data-parallel: engine policy does not apply
        return self._tricount(chunk)

    def dfs(self, src: int,
            policy: Optional[ExecutionPolicy] = None) -> Result:
        return self.run(QuerySpec(algo="dfs", sources=(int(src),),
                                  policy=policy))

    # -- runner hooks: registry dispatch for non-relaxation workloads ----

    def _minitri_runner(self, spec: QuerySpec,
                        pol: ExecutionPolicy) -> Result:
        return self._minitri()

    def _tricount_runner(self, spec: QuerySpec,
                         pol: ExecutionPolicy) -> Result:
        return self._tricount()

    def _dfs_runner(self, spec: QuerySpec,
                    pol: ExecutionPolicy) -> Result:
        return self._dfs(spec.sources[0])

    # -- triangle workloads: one-shot data-parallel intersections --------

    def _oriented_edges(self):
        """Shared compile-time step for the triangle workloads: orient
        the undirected graph low→high by (degree, id) — a DAG with small
        max out-degree — and return (und, k_max, rows, eu, ev) where
        ``rows`` is the (n+1, k_max) sorted ELL neighbour table padded
        with the sentinel row ``n`` and (eu, ev) are the oriented edges.
        Each triangle appears exactly once: as its lowest edge (u, v)
        with the third corner in N+(u) ∩ N+(v)."""
        und = self._variant("undirected")
        deg = und.out_degrees()
        src = np.repeat(np.arange(und.n, dtype=np.int64),
                        np.diff(und.indptr))
        dst = und.indices.astype(np.int64)
        key_s = deg[src] * (und.n + 1) + src
        key_d = deg[dst] * (und.n + 1) + dst
        keep = key_s < key_d
        s2, d2 = src[keep], dst[keep]
        g_plus = Graph.from_edges(und.n, s2.astype(np.int32),
                                  d2.astype(np.int32),
                                  np.ones(len(s2), dtype=np.float32))
        ell = to_ell_fast(g_plus)
        rows = np.vstack([ell.cols, np.full((1, ell.k_max), und.n,
                                            dtype=np.int32)])
        eu = np.repeat(np.arange(und.n, dtype=np.int32),
                       np.diff(g_plus.indptr))
        ev = g_plus.indices.astype(np.int32)
        return und, ell.k_max, rows, eu, ev

    @staticmethod
    def _oneshot_stats(e_plus: int, k_max: int) -> RunStats:
        # one-shot data-parallel workload: intersections distribute evenly
        # over the NALE array (no dependency chain), so the critical path
        # is total work / array width, not the serial stream
        nales = 256.0
        return RunStats(
            sweeps=1, converged=True,
            tile_work=float(e_plus * k_max),
            edge_work=float(e_plus * max(k_max, 1)),
            crit_tiles=float(e_plus * k_max) / nales,
            active_group_sweeps=nales, halo_tiles=0.0, total_groups=1,
            mode="oneshot")

    def _minitri(self, chunk: int = 65536) -> Result:
        """Total triangles: for each oriented edge (u, v), the sorted
        rows of u and v intersected by ``torch.searchsorted`` on the
        session's device, ``chunk`` edges at a time, into an int64 total
        read to the host once."""
        und, k_max, rows, eu, ev = self._oriented_edges()
        rows_t = torch.from_numpy(rows).to(self.device)
        eu_t = torch.from_numpy(eu).to(self.device).long()
        ev_t = torch.from_numpy(ev).to(self.device).long()
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, len(eu), chunk):
            a, bb = rows_t[eu_t[i:i + chunk]], rows_t[ev_t[i:i + chunk]]
            pos = torch.searchsorted(bb, a).clamp_(0, k_max - 1)
            hit = (bb.gather(1, pos) == a) & (a != und.n)
            total += hit.sum()
        total = int(total)
        e_plus = len(eu)
        return Result(np.array([total]), self._oneshot_stats(e_plus, k_max),
                      None, {"algo": "minitri", "triangles": total,
                             "oriented_edges": e_plus, "k_max": k_max},
                      policy=None, graph=self.g)

    def _tricount(self, chunk: int = 65536) -> Result:
        """Per-vertex triangle counts over the same oriented-edge table
        as MiniTri: for each oriented edge (u, v), every common
        out-neighbour w closes one triangle — credit u, v, and w.  Runs
        on the host in numpy, as in the JAX package."""
        und, k_max, rows, eu, ev = self._oriented_edges()
        counts = np.zeros(und.n, dtype=np.int64)
        # numpy all-pairs matching per edge chunk; K*K comparisons per
        # edge, chunk sized to bound the (chunk, K, K) mask at ~4M cells
        kk = max(k_max * k_max, 1)
        step = max(1, min(chunk, (1 << 22) // kk))
        for i in range(0, len(eu), step):
            u, v = eu[i:i + step], ev[i:i + step]
            a, b = rows[u], rows[v]               # (E, K) neighbour ids
            m = (a[:, :, None] == b[:, None, :]) & \
                (a[:, :, None] != und.n)
            per_edge = m.sum(axis=(1, 2))
            np.add.at(counts, u, per_edge)
            np.add.at(counts, v, per_edge)
            e_idx, i_idx, _ = np.nonzero(m)
            np.add.at(counts, a[e_idx, i_idx], 1)
        total = int(counts.sum() // 3)
        e_plus = len(eu)
        return Result(counts.astype(np.float32),
                      self._oneshot_stats(e_plus, k_max), None,
                      {"algo": "tricount", "triangles": total,
                       "oriented_edges": e_plus, "k_max": k_max},
                      policy=None, graph=self.g)

    # -- DFS: sequential stack machine (worst-case-serial) ---------------

    def _dfs(self, src: int) -> Result:
        """Depth-first order from ``src``, lowest neighbour first: a
        stack machine on the host over the CSR graph.  The JAX package
        runs the same machine as one jitted ``while_loop``; eager torch
        on the card would launch kernels once per vertex, so the port
        walks the host CSR, and the result is a host array in both."""
        g = self.g
        n = g.n
        k = max(int(np.diff(g.indptr).max()) if n else 1, 1)
        indptr, indices = g.indptr.tolist(), g.indices.tolist()
        visited = bytearray(n)
        order = np.full(n, -1, dtype=np.int32)
        parent = np.full(n, -1, dtype=np.int32)
        stack, cnt = [(int(src), -1)], 0
        while stack:
            u, pu = stack.pop()
            if visited[u]:
                continue
            visited[u] = 1
            order[cnt] = u
            parent[u] = pu
            cnt += 1
            # push neighbours in reverse so the lowest pops first
            for v in reversed(indices[indptr[u]:indptr[u + 1]]):
                if not visited[v]:
                    stack.append((v, u))
        stats = RunStats(
            sweeps=cnt, converged=True,
            tile_work=float(cnt * k), edge_work=float(g.nnz),
            crit_tiles=float(cnt * k), active_group_sweeps=float(cnt),
            halo_tiles=0.0, total_groups=1, mode="sequential")
        return Result(order, stats, None,
                      {"algo": "dfs", "src": src, "parent": parent,
                       "visited_count": cnt},
                      policy=None, graph=self.g)
