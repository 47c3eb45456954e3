"""First-class algorithm registry + back-compat free functions.

An :class:`AlgorithmSpec` is the single record of an algorithm's
identity: which semiring runs the MAC datapath, which graph variant /
normalization the plan is built over, which update rule the engines
apply (and therefore — via the rule's ``monotone``/``bias`` properties —
which schedules the algorithm is eligible for), how the frontier vector
is initialized, how raw converged values are post-processed, and which
numpy oracle certifies it.  Every consumer dispatches through the
registry — ``GraphProcessor.run``, the distributed engines, the serving
layer's wave coalescing — so adding an algorithm is one
:func:`register_algorithm` call, not a five-layer edit.

    from repro_torch.core.algorithms import AlgorithmSpec, register_algorithm
    register_algorithm(AlgorithmSpec(
        name="widest_path", semiring="max_min", source_required=True,
        init=lambda p, src, pol: ...))
    proc.run(QuerySpec(algo="widest_path", sources=(0,)))

The free functions below (``pagerank(g)``, ``sssp(g, 0)``, ...) are the
historical one-shot API: thin wrappers that build a single-query
``GraphProcessor`` session.  Code issuing many queries against one graph
should construct the processor directly so the compile-time pipeline
(cluster → permute → BSR build → upload) is paid once:

    from repro_torch import api
    proc = api.GraphProcessor(g, b=16, num_clusters=64)
    proc.pagerank(); proc.sssp(0); proc.sssp(sources=[1, 2, 3])

Every entry point runs on ``cuda`` unless ``device=`` names another
device.  The registry holds all ten algorithms; the three runners
(minitri, tricount, dfs) bypass the engines through the session's runner
hooks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np

from . import oracles, semiring as sr
from .graph import Graph


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """One algorithm's complete identity on the NALE datapath.

    Attributes:
      name:        registry key; ``QuerySpec.algo`` strings resolve here.
      semiring:    ⊕/⊗ pair the sweeps run on (``semiring.get`` name).
      update:      apply rule name (``semiring.rule``); its
                   ``monotone``/``bias``/``exact`` properties drive
                   schedule eligibility in every engine flavor.
      variant:     graph transform the plan is built over — "base",
                   "unit" (unit weights), "undirected", or
                   "unit_undirected" (both).
      pull / normalize:  remaining plan-key fields (see ``PlanKey``).
      source_required:   query must carry at least one source vertex.
      coalescible: the serving layer may merge same-plan single-source
                   queries of this algorithm into one batched wave.
      default_policy:    per-algorithm ``ExecutionPolicy`` field
                   defaults, applied over the session policy when the
                   query does not pin an explicit policy.
      param_map:   QuerySpec.params name → ExecutionPolicy field; lets
                   an algorithm parameter (k-core's ``k``) ride an
                   existing scalar slot (``damping``) through engines
                   and kernels without widening every signature.
      required_params:   params that must be present (checked by
                   ``validate_spec`` before any plan work).
      init:        ``(prepared, src, policy) -> (n,) float32`` initial
                   state in ORIGINAL vertex ids.
      post:        converged values → user values (None = identity).
      pad:         padding value for absent/padded rows; None uses the
                   semiring's ⊕-identity (correct whenever init respects
                   the carrier set).
      oracle:      numpy reference implementation (signature varies per
                   algorithm; see ``core/oracles.py``).
      runner:      name of a ``GraphProcessor`` method implementing a
                   non-relaxation algorithm (one-shot/sequential
                   workloads: minitri, tricount, dfs).  When set, the
                   relaxation fields above are unused.
    """

    name: str
    semiring: str = "plus_times"
    update: str = "relax"
    variant: str = "base"
    pull: bool = True
    normalize: Optional[str] = None
    source_required: bool = False
    coalescible: bool = False
    default_policy: Tuple[Tuple[str, Any], ...] = ()
    param_map: Tuple[Tuple[str, str], ...] = ()
    required_params: Tuple[str, ...] = ()
    init: Optional[Callable] = None
    post: Optional[Callable] = None
    pad: Optional[float] = None
    oracle: Optional[Callable] = None
    runner: Optional[str] = None

    @property
    def rule(self) -> sr.UpdateRule:
        """Scheduling properties of this algorithm's update rule."""
        return sr.rule(self.update)

    @property
    def ring(self) -> sr.Semiring:
        return sr.get(self.semiring)


ALGORITHMS: dict = {}


def register_algorithm(spec: AlgorithmSpec,
                       overwrite: bool = False) -> AlgorithmSpec:
    """Register an algorithm for ``QuerySpec``/engine/serving dispatch."""
    sr.rule(spec.update)        # fail fast on unknown rule names
    if spec.runner is None:
        sr.get(spec.semiring)   # ... and unknown semirings
    if spec.name in ALGORITHMS and not overwrite:
        raise ValueError(
            f"algorithm {spec.name!r} is already registered; pass "
            "overwrite=True to replace it")
    ALGORITHMS[spec.name] = spec
    return spec


def get_algorithm(name: str) -> AlgorithmSpec:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: {registered_algorithms()}")


def registered_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(ALGORITHMS))


# ---------------------------------------------------------------------------
# built-in registrations — the paper's suite + the later families
# ---------------------------------------------------------------------------


def _init_source_inf(p, src, pol):
    x = np.full(p.n, np.inf, dtype=np.float32)
    x[src] = 0.0
    return x


def _init_source_one(p, src, pol):
    x = np.zeros(p.n, dtype=np.float32)
    x[src] = 1.0
    return x


def _init_uniform(p, src, pol):
    return np.full(p.n, 1.0 / p.n, dtype=np.float32)


def _init_delta_floor(p, src, pol):
    # the fixpoint is approached monotonically from below; (1-d)/n is
    # every vertex's rank floor (its bias term), so in-degree-0 vertices
    # start already converged — no first-touch bias sweep needed.
    return np.full(p.n, (1.0 - pol.damping) / p.n, dtype=np.float32)


def _init_perm_labels(p, src, pol):
    return p.perm.astype(np.float32)


def _init_ones(p, src, pol):
    return np.ones(p.n, dtype=np.float32)


def _renorm(v):
    return v / max(v.sum(), 1e-30)  # dangling-drop: L1 renormalization


register_algorithm(AlgorithmSpec(
    name="sssp", semiring="min_plus", source_required=True,
    coalescible=True, default_policy=(("max_sweeps", 100_000),),
    init=_init_source_inf, oracle=oracles.sssp_oracle))

register_algorithm(AlgorithmSpec(
    name="bfs", semiring="min_plus", variant="unit", source_required=True,
    coalescible=True, default_policy=(("max_sweeps", 100_000),),
    init=_init_source_inf, oracle=oracles.bfs_oracle))

register_algorithm(AlgorithmSpec(
    name="pagerank", semiring="plus_times", update="pagerank",
    normalize="out_stochastic",
    default_policy=(("tol", 1e-8), ("max_sweeps", 500)),
    init=_init_uniform, post=_renorm, oracle=oracles.pagerank_oracle))

# GraphScale's delta-accumulating PageRank: same plan (plus_times /
# out_stochastic — plan-cache shared with classic pagerank), but the
# update only *raises* ranks from the (1-d)/n floor, by more than tol at
# a time.  That makes it idempotent and monotone, hence eligible for the
# async engine and the self-timed distributed flavor that refuse the
# classic sweep; the price is a tolerance-bounded (not exact) fixpoint:
# ||x - x*||_inf <= tol / (1 - damping) before the final renorm.
register_algorithm(AlgorithmSpec(
    name="pagerank_delta", semiring="plus_times", update="pagerank_delta",
    normalize="out_stochastic",
    default_policy=(("tol", 1e-8), ("max_sweeps", 500)),
    init=_init_delta_floor, post=_renorm, oracle=oracles.pagerank_oracle))

register_algorithm(AlgorithmSpec(
    name="cc", semiring="min_select", variant="undirected",
    default_policy=(("max_sweeps", 100_000),),
    init=_init_perm_labels, oracle=oracles.cc_oracle))

register_algorithm(AlgorithmSpec(
    name="reachability", semiring="max_min", variant="unit",
    source_required=True,
    default_policy=(("max_sweeps", 100_000), ("mode", "sync")),
    init=_init_source_one, oracle=None))

# k-core membership peeling: plus_times over the unit-weight undirected
# graph makes each sweep's y a live-neighbour count; the "kcore" rule
# kills vertices with y < k.  k rides the damping scalar slot (the one
# per-rule float threshold the engines/kernels already plumb).
register_algorithm(AlgorithmSpec(
    name="kcore", semiring="plus_times", update="kcore",
    variant="unit_undirected",
    default_policy=(("max_sweeps", 100_000),),
    param_map=(("k", "damping"),), required_params=("k",),
    init=_init_ones, oracle=oracles.kcore_oracle))

register_algorithm(AlgorithmSpec(
    name="minitri", runner="_minitri_runner",
    oracle=oracles.triangles_oracle))

# per-vertex triangle counting on the minitri oriented-edge machinery
register_algorithm(AlgorithmSpec(
    name="tricount", runner="_tricount_runner",
    oracle=oracles.tricount_oracle))

register_algorithm(AlgorithmSpec(
    name="dfs", runner="_dfs_runner", source_required=True,
    oracle=oracles.dfs_oracle))


# ---------------------------------------------------------------------------
# back-compat free functions (lazy session construction)
# ---------------------------------------------------------------------------


def __getattr__(name):
    # AlgoResult/Result re-export without importing api at module load
    # (core/__init__ imports algorithms before api).
    if name in ("AlgoResult", "Result", "ExecutionPolicy"):
        from . import api as _api
        return {"AlgoResult": _api.Result, "Result": _api.Result,
                "ExecutionPolicy": _api.ExecutionPolicy}[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _proc(g: Graph, b: int = 32, num_clusters=None, clustered: bool = True,
          device=None):
    from . import api as _api
    return _api.GraphProcessor(g, b=b, num_clusters=num_clusters,
                               clustered=clustered, device=device)


def _policy(mode, impl, **kw):
    from . import api as _api
    return _api.ExecutionPolicy(mode=mode, impl=impl, **kw)


def pagerank(g: Graph, damping: float = 0.85, tol: float = 1e-8,
             mode: str = "async", b: int = 32,
             num_clusters: Optional[int] = None, clustered: bool = True,
             max_sweeps: int = 500, impl: str = "ref", device=None):
    pol = _policy(mode, impl, damping=damping, tol=tol,
                  max_sweeps=max_sweeps)
    return _proc(g, b, num_clusters, clustered, device).pagerank(policy=pol)


def pagerank_delta(g: Graph, damping: float = 0.85, tol: float = 1e-8,
                   mode: str = "async", b: int = 32,
                   num_clusters: Optional[int] = None,
                   clustered: bool = True, max_sweeps: int = 500,
                   impl: str = "ref", device=None):
    """Delta-accumulating PageRank — async/dist_async-eligible."""
    pol = _policy(mode, impl, damping=damping, tol=tol,
                  max_sweeps=max_sweeps)
    return _proc(g, b, num_clusters, clustered, device).pagerank_delta(policy=pol)


def sssp(g: Graph, src: int, mode: str = "async", b: int = 32,
         num_clusters: Optional[int] = None, clustered: bool = True,
         max_sweeps: int = 100_000, impl: str = "ref", device=None):
    pol = _policy(mode, impl, max_sweeps=max_sweeps)
    return _proc(g, b, num_clusters, clustered, device).sssp(src, policy=pol)


def bfs(g: Graph, src: int, mode: str = "async", b: int = 32,
        num_clusters: Optional[int] = None, clustered: bool = True,
        max_sweeps: int = 100_000, impl: str = "ref", device=None):
    pol = _policy(mode, impl, max_sweeps=max_sweeps)
    return _proc(g, b, num_clusters, clustered, device).bfs(src, policy=pol)


def connected_components(g: Graph, mode: str = "async", b: int = 32,
                         num_clusters: Optional[int] = None,
                         clustered: bool = True,
                         max_sweeps: int = 100_000, impl: str = "ref", device=None):
    pol = _policy(mode, impl, max_sweeps=max_sweeps)
    return _proc(g, b, num_clusters, clustered,
                 device).connected_components(policy=pol)


def kcore(g: Graph, k: int, mode: str = "async", b: int = 32,
          num_clusters: Optional[int] = None, clustered: bool = True,
          max_sweeps: int = 100_000, impl: str = "ref", device=None):
    """k-core membership: 1.0 for vertices in the k-core, else 0.0."""
    pol = _policy(mode, impl, max_sweeps=max_sweeps)
    return _proc(g, b, num_clusters, clustered, device).kcore(k, policy=pol)


def reachability(g: Graph, src: int, mode: str = "sync", b: int = 32,
                 num_clusters: Optional[int] = None,
                 clustered: bool = True, max_sweeps: int = 100_000,
                 impl: str = "ref", device=None):
    """Boolean or_and reachability from src (max_min on {0,1})."""
    pol = _policy(mode, impl, max_sweeps=max_sweeps)
    return _proc(g, b, num_clusters, clustered, device).reachability(src,
                                                             policy=pol)


def minitri(g: Graph, chunk: int = 65536, device=None):
    return _proc(g, device=device).minitri(chunk=chunk)


def tricount(g: Graph, chunk: int = 65536, device=None):
    """Per-vertex triangle counts (values[v] = triangles at corner v)."""
    return _proc(g, device=device).tricount(chunk=chunk)


def dfs(g: Graph, src: int, device=None):
    return _proc(g, device=device).dfs(src)
