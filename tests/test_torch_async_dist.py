"""The port's self-timed distributed engine (``core/async_dist.py``)
against the JAX package.

The contract of tests/test_async_dist.py: ``dist_flavor="async"`` reaches
the SAME fixpoint as the bulk-synchronous engine — values bit-identical
to ``repro.core.engine.run_sync_batched`` (impl ``ref``) on every mesh
factorization and every k ∈ {1, 2, 4} for min_plus and max_min — while
``DistStats.halo_exchanges`` strictly drops for k > 1 on multi-sweep
fixpoints.  The JAX package's own distributed engines do not run on this
tree's JAX, so its single-device sync engine is the reference; for
``pagerank_delta`` (an accumulation rule) the async flavor stays within
``2 · tol / (1 - damping)`` of its sync fixpoint, the sum of the two
schedules' distances to the true one.

On the CPU: ``road_network(10, seed=1)`` at b 8 and 8 clusters, every
mesh slot on ``"cpu"``; also the launch schedule the card is held to
(k + 1 SpMVs a slot a round), the engine guards, the session policy and
a service wave.  On the card (``-m cuda``, skipped here): a run on a mesh
of ``cuda:0`` slots equals the single-device engine with exactly that
launch count.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core import async_dist as AD  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import placement as PL  # noqa: E402
from repro_torch.kernels import bsr_spmv as tk  # noqa: E402

CPU = "cpu"
# (num_devices, query_axis) — the factorizations of the JAX package's tests
FACTORIZATIONS = [(1, 1), (4, 2), (8, 1), (8, 8)]
KS = [1, 2, 4]
SOURCES = [0, 5, 9, 13, 17]


@pytest.fixture(scope="module")
def ref():
    """The JAX package, for the parity tests; they skip where JAX is
    absent (the card's machine runs only the ``-m cuda`` tests)."""
    pytest.importorskip("jax")
    from repro import api as japi
    from repro.core import engine, graph
    return types.SimpleNamespace(api=japi, engine=engine, graph=graph)


def _x0(p, n, semiring):
    rows = []
    for s in SOURCES:
        if semiring == "max_min":
            x = np.zeros(n, dtype=np.float32)
            x[s] = 1.0
            rows.append(p.to_blocks(x, 0.0))
        else:
            x = np.full(n, np.inf, dtype=np.float32)
            x[s] = 0.0
            rows.append(p.to_blocks(x, np.inf))
    return rows


_CASES = {}


def batched_case(ref, semiring):
    """(port plan, port x0, repro's run_sync_batched values), built once."""
    if semiring not in _CASES:
        g = G.road_network(10, seed=1)
        p = eng.prepare(g, semiring, b=8, num_clusters=8, device=CPU)
        rp = ref.engine.prepare(ref.graph.road_network(10, seed=1),
                                semiring, b=8, num_clusters=8)
        np.testing.assert_array_equal(p.perm, rp.perm)
        x0 = torch.stack(_x0(p, g.n, semiring))
        rx0 = np.stack([np.asarray(r) for r in _x0(rp, g.n, semiring)])
        want, _ = ref.engine.run_sync_batched(rp, rx0, max_sweeps=100_000)
        _CASES[semiring] = (p, x0, np.asarray(want))
    return _CASES[semiring]


def cpu_mesh(ndev, qaxis=1):
    return PL.make_graph_mesh(ndev, qaxis, device=CPU)


# -- parity + exchange reduction ----------------------------------------------


@pytest.mark.parametrize("semiring", ["min_plus", "max_min"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("ndev,qaxis", FACTORIZATIONS)
def test_async_parity_across_factorizations(ref, semiring, k, ndev, qaxis):
    """Async == repro's run_sync_batched, BIT-identical, on every
    factorization × k."""
    p, x0, want = batched_case(ref, semiring)
    x, ds = AD.distributed_async_run_batched(
        p, x0, max_sweeps=100_000, mesh=cpu_mesh(ndev, qaxis),
        local_sweeps=k)
    assert np.array_equal(x.numpy(), want)
    assert ds.converged
    assert ds.mesh_shape == (ndev // qaxis, qaxis)
    assert ds.local_sweeps == k
    assert ds.query_sweeps.shape == (x0.shape[0],)
    assert ds.sweeps == int(ds.query_sweeps.max())
    # per-shard self-timed sweep counters, one per "graph" shard
    assert ds.shard_sweeps.shape == (ndev // qaxis,)
    assert int(ds.shard_sweeps.max()) >= ds.sweeps
    # one exchange and one host read a round, k sweeps at most a round
    assert ds.host_syncs == ds.halo_exchanges
    assert ds.halo_exchanges * k >= ds.sweeps


@pytest.mark.parametrize("semiring", ["min_plus", "max_min"])
def test_k_strictly_reduces_halo_exchanges(ref, semiring):
    """k > 1 reaches the same fixpoint with STRICTLY fewer halo exchanges
    than the bulk-synchronous engine (which exchanges once per sweep)."""
    p, x0, want = batched_case(ref, semiring)
    _, ds_sync = PL.distributed_sync_run_batched(p, x0, "relax",
                                                 max_sweeps=100_000)
    assert ds_sync.halo_exchanges == ds_sync.sweeps  # BSP: 1 per sweep
    assert ds_sync.sweeps >= 3, "fixture too shallow to show reduction"
    exchanges = {}
    for k in KS:
        x, ds = AD.distributed_async_run_batched(
            p, x0, max_sweeps=100_000, local_sweeps=k)
        assert np.array_equal(x.numpy(), want)
        assert ds.converged
        if k > 1:
            assert ds.halo_exchanges < ds_sync.halo_exchanges
        exchanges[k] = ds.halo_exchanges
    # more local sweeps never needs more exchanges
    assert exchanges[4] <= exchanges[2] <= exchanges[1]


def test_single_source_wrapper_parity():
    """Exchange reduction needs intra-shard propagation to dominate, so a
    modest "graph" extent: 2 shards."""
    g = G.rmat(200, 900, seed=6)
    p = eng.prepare(g, "min_plus", b=8, num_clusters=8, device=CPU)
    x0 = np.full(g.n, np.inf, dtype=np.float32)
    x0[3] = 0.0
    xb = p.to_blocks(x0, np.inf)
    mesh = cpu_mesh(2)
    xs, ds_sync = PL.distributed_sync_run(p, xb, "relax",
                                          max_sweeps=100_000, mesh=mesh)
    xa, ds = AD.distributed_async_run(p, xb, max_sweeps=100_000,
                                      mesh=mesh, local_sweeps=4)
    assert torch.equal(xa, xs)
    assert ds.converged
    assert ds.halo_exchanges < ds_sync.halo_exchanges


@pytest.mark.parametrize("flavor,k", [("sync", 1), ("async", 1),
                                      ("async", 2), ("async", 4)])
def test_launch_schedule(ref, flavor, k, monkeypatch):
    """The launches the card is held to: one SpMV a slot a sweep (sync);
    two in a round's first sweep (interior, then boundary) and one in
    each of the k - 1 later ones (async), whether or not a query or shard
    idles."""
    p, x0, want = batched_case(ref, "min_plus")
    calls = []
    real = PL._spmv_ref

    def counting(*a, **kw):
        calls.append(kw["index"].row_base)
        return real(*a, **kw)

    monkeypatch.setattr(PL, "_spmv_ref", counting)
    mesh = cpu_mesh(8, 2)      # 4 graph shards × 2 query shards
    if flavor == "sync":
        x, ds = PL.distributed_sync_run_batched(p, x0, mesh=mesh,
                                                max_sweeps=100_000)
        assert len(calls) == ds.sweeps * 8
    else:
        x, ds = AD.distributed_async_run_batched(
            p, x0, mesh=mesh, max_sweeps=100_000, local_sweeps=k)
        assert len(calls) == ds.halo_exchanges * 8 * (k + 1)
    assert np.array_equal(x.numpy(), want)
    # each graph shard's index view starts at its own rows: 4 row-blocks
    # of 8 vertices a shard
    assert sorted(set(calls)) == [0, 32, 64, 96]


# -- engine guards ------------------------------------------------------------


def test_async_engine_rejects_non_relax(ref):
    """PageRank's damped affine update is not idempotent — the k-local-
    sweep schedule would change its fixpoint, so the engine refuses."""
    p, x0, _ = batched_case(ref, "min_plus")
    with pytest.raises(ValueError, match="relax"):
        AD.distributed_async_run_batched(p, x0, apply_kind="pagerank")


def test_async_engine_rejects_bad_k(ref):
    p, x0, _ = batched_case(ref, "min_plus")
    with pytest.raises(ValueError, match="local_sweeps"):
        AD.distributed_async_run_batched(p, x0, local_sweeps=0)


# -- policy plumbing (API level) ----------------------------------------------


@pytest.fixture(scope="module")
def rmat():
    return G.rmat(150, 600, seed=3)


def test_policy_routes_async_flavor(rmat):
    """End-to-end through GraphProcessor: async flavor is bit-identical
    to the sync flavor and DistStats lands in Result.extra."""
    proc = api.GraphProcessor(rmat, b=8, num_clusters=8, device=CPU)
    pol_s = api.ExecutionPolicy(mode="distributed")
    pol_a = pol_s.but(dist_flavor="async", local_sweeps=4)
    for sources in (0, [0, 3, 7]):
        rs = proc.sssp(sources, policy=pol_s)
        ra = proc.sssp(sources, policy=pol_a)
        assert np.array_equal(rs.values, ra.values)
        ds = ra.extra["dist"]
        assert ds.local_sweeps == 4
        assert ds.halo_exchanges <= rs.extra["dist"].halo_exchanges
        # halo accounting follows exchanges, not sweeps, for the async
        # flavor (engine.dist_run_stats)
        if ds.halo_exchanges < rs.extra["dist"].halo_exchanges:
            assert ra.stats.halo_tiles < rs.stats.halo_tiles
        assert ra.stats.host_syncs == ds.halo_exchanges


def test_policy_async_pagerank_raises(rmat):
    proc = api.GraphProcessor(rmat, b=8, num_clusters=8, device=CPU)
    pol = api.ExecutionPolicy(mode="distributed", dist_flavor="async",
                              local_sweeps=2)
    with pytest.raises(ValueError, match="relax"):
        proc.pagerank(policy=pol)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_pagerank_delta_async_within_tolerance(ref, rmat, k):
    """pagerank_delta's fixpoint depends on the schedule within
    tol/(1-d) of the true one, so the async flavor stays within
    2·tol/(1-d) of repro's sync pagerank_delta."""
    tol, d = 1e-9, 0.85
    proc = api.GraphProcessor(rmat, b=8, num_clusters=8, device=CPU)
    pol = api.ExecutionPolicy(mode="distributed", dist_flavor="async",
                              local_sweeps=k, tol=tol)
    got = proc.pagerank_delta(policy=pol)
    jproc = ref.api.GraphProcessor(ref.graph.rmat(150, 600, seed=3), b=8,
                                   num_clusters=8)
    want = jproc.pagerank_delta(policy=ref.api.ExecutionPolicy(
        mode="sync", tol=tol))
    assert got.stats.converged and got.stats.mode == "distributed"
    np.testing.assert_allclose(got.values, want.values, rtol=0,
                               atol=2 * tol / (1 - d))


def test_service_wave_uses_async_engine(rmat):
    """Coalesced GraphService waves dispatch through the async engine
    when the policy asks for it, bit-identical to sequential runs."""
    pol = api.ExecutionPolicy(mode="distributed", dist_flavor="async",
                              local_sweeps=4, max_sweeps=100_000)
    svc = api.GraphService(device=CPU)
    svc.register("g", rmat, b=8, num_clusters=8)
    sources = (0, 3, 7)
    tickets = [svc.submit("g", api.QuerySpec(algo="sssp", sources=(s,),
                                             policy=pol))
               for s in sources]
    out = svc.gather()
    proc = api.GraphProcessor(rmat, b=8, num_clusters=8, device=CPU)
    for t, s in zip(tickets, sources):
        res = out[t]
        assert not isinstance(res, Exception), res
        assert res.extra["coalesced"] == len(sources)
        assert res.extra["dist_flavor"] == "async"
        assert res.extra["dist"].local_sweeps == 4
        seq = proc.sssp(s, policy=pol)
        assert np.array_equal(res.values, seq.values)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("ndev,qaxis", FACTORIZATIONS)
def test_cuda_async_matches_single_device(ndev, qaxis, k, cuda):
    g = G.road_network(24, seed=3)
    p = eng.prepare(g, "min_plus", b=8, num_clusters=8, device=cuda)
    x0 = torch.stack(_x0(p, g.n, "min_plus"))
    want, _ = eng.run_sync_batched(p, x0, max_sweeps=100_000)
    before = tk.launch_counts["bsr_spmv_compact"]
    x, ds = AD.distributed_async_run_batched(
        p, x0, mesh=PL.make_graph_mesh(ndev, qaxis, device=cuda),
        max_sweeps=100_000, local_sweeps=k)
    launched = tk.launch_counts["bsr_spmv_compact"] - before
    assert torch.equal(x, want) and ds.converged
    assert ds.host_syncs == ds.halo_exchanges
    assert launched == ds.halo_exchanges * ndev * (k + 1)
