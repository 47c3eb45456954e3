"""The port's bulk-synchronous distributed engine (``core/placement.py``)
against the JAX package.

The JAX package's own distributed engines do not run on this tree's JAX
(their ``shard_map`` call passes ``check_rep``), so the port is held to
what its tests assert of them: values **bit-identical** to
``repro.core.engine.run_sync_batched`` (impl ``ref``) and per-query
sweeps equal to ``repro``'s ``run_sync`` of each source, on the same
numpy inputs, at the mesh factorizations (devices, query axis) ∈ {(1, 1),
(4, 2), (8, 1), (8, 8)} of tests/test_distribution.py.  Also held to
``repro``'s pure functions: ``factor_query_axis``, ``shard_batched_
inputs``'s layout, ``ShardedBatch.halo_bytes_per_exchange``, and
``RunStats`` from ``engine.bsp_stats``/``dist_run_stats`` given the same
``DistStats``.

On the CPU: ``road_network(10, seed=1)`` at b 8 and 8 clusters (r_pad
16), and at 5 clusters (r_pad 15: the mesh pads the last shard), every
mesh slot on ``"cpu"``.  Counterparts of tests/test_distribution.py:66-
160, tests/test_api.py's distributed-policy tests, tests/test_graph_
service.py's distributed wave, and the fault sites of both engines.

On the card (``-m cuda``, skipped here): each slot's compacted SpMV over
``CompactIndex.rows`` of its shard equals its plain version bit for bit,
the padded last shard included; a run on a mesh of ``cuda:0`` slots
equals the single-device engine with one launch per slot and sweep; on
a host of two or more cards, a mesh across them does too.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch import resilience as rz  # noqa: E402
from repro_torch.core import async_dist as AD  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import oracles as O  # noqa: E402
from repro_torch.core import placement as PL  # noqa: E402
from repro_torch.kernels import bsr_spmv as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

CPU = "cpu"
# (num_devices, query_axis) — the factorizations of the JAX package's tests
FACTORIZATIONS = [(1, 1), (4, 2), (8, 1), (8, 8)]
SOURCES = [0, 5, 9, 13, 17]


@pytest.fixture(scope="module")
def ref():
    """The JAX package, for the parity tests; they skip where JAX is
    absent (the card's machine runs only the ``-m cuda`` tests)."""
    pytest.importorskip("jax")
    from repro import api as japi
    from repro.core import engine, graph, placement
    return types.SimpleNamespace(api=japi, engine=engine, graph=graph,
                                 placement=placement)


def _x0_flat(n, s, semiring):
    if semiring == "max_min":
        x = np.zeros(n, dtype=np.float32)
        x[s] = 1.0
        return x, 0.0
    x = np.full(n, np.inf, dtype=np.float32)
    x[s] = 0.0
    return x, np.inf


_CASES = {}


def batched_case(ref, semiring, num_clusters=8):
    """(port plan, port x0 (Q, r_pad, B), repro's run_sync_batched values,
    repro's per-source run_sync sweeps) for one semiring, built once."""
    key = (semiring, num_clusters)
    if key not in _CASES:
        g = G.road_network(10, seed=1)
        p = eng.prepare(g, semiring, b=8, num_clusters=num_clusters,
                        device=CPU)
        rp = ref.engine.prepare(ref.graph.road_network(10, seed=1),
                                semiring, b=8, num_clusters=num_clusters)
        np.testing.assert_array_equal(p.perm, rp.perm)
        flats = [_x0_flat(g.n, s, semiring) for s in SOURCES]
        x0 = torch.stack([p.to_blocks(x, pad) for x, pad in flats])
        rx0 = np.stack([np.asarray(rp.to_blocks(x, pad)) for x, pad in flats])
        want, _ = ref.engine.run_sync_batched(rp, rx0, max_sweeps=100_000)
        sweeps = [ref.engine.run_sync(rp, rx0[q], max_sweeps=100_000)[1]
                  .sweeps for q in range(len(SOURCES))]
        _CASES[key] = (p, x0, np.asarray(want), np.asarray(sweeps))
    return _CASES[key]


def cpu_mesh(ndev, qaxis=1):
    return PL.make_graph_mesh(ndev, qaxis, device=CPU)


# -- the mesh and the pure functions -----------------------------------------


def test_make_graph_mesh_is_2d_and_degenerates():
    mesh = PL.make_graph_mesh(1, device=CPU)
    assert dict(mesh.shape) == {"graph": 1, "query": 1}
    mesh = PL.make_graph_mesh(8, 2, device=CPU)
    assert mesh.shape == {"graph": 4, "query": 2}
    assert {d for row in mesh.devices for d in row} == {torch.device(CPU)}
    with pytest.raises(ValueError):
        PL.make_graph_mesh(1, 0, device=CPU)
    with pytest.raises(ValueError):
        PL.make_graph_mesh(4, 3, device=CPU)   # 3 does not divide 4


def test_make_graph_mesh_defaults_to_the_cards():
    if torch.cuda.is_available():
        mesh = PL.make_graph_mesh()
        n = torch.cuda.device_count()
        assert mesh.shape == {"graph": n, "query": 1}
        assert mesh.devices[-1][0] == torch.device("cuda", n - 1)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PL.make_graph_mesh()


def test_factor_query_axis():
    assert PL.factor_query_axis(8, 1) == 1
    assert PL.factor_query_axis(8, 3) == 2    # largest divisor <= 3
    assert PL.factor_query_axis(8, 5) == 4
    assert PL.factor_query_axis(8, 64) == 8
    assert PL.factor_query_axis(1, 64) == 1
    assert PL.factor_query_axis(6, 4) == 3


def test_factor_query_axis_matches_reference(ref):
    for ndev in range(1, 17):
        for nq in range(0, 70):
            assert PL.factor_query_axis(ndev, nq) == \
                ref.placement.factor_query_axis(ndev, nq), (ndev, nq)


@pytest.mark.parametrize("num_clusters", [8, 5])
@pytest.mark.parametrize("ndev,qaxis", FACTORIZATIONS)
def test_sharded_batch_matches_reference_layout(ref, ndev, qaxis,
                                                num_clusters):
    """``shard_batched_inputs``' padding — rows to a multiple of "graph"
    holding the ⊕-identity, queries to a multiple of "query", dead
    padding queries — equals the JAX package's (its mesh is read only
    through ``mesh.shape``)."""
    p, x0, _, _ = batched_case(ref, "min_plus", num_clusters)
    rp = ref.engine.prepare(ref.graph.road_network(10, seed=1), "min_plus",
                            b=8, num_clusters=num_clusters)
    mesh = cpu_mesh(ndev, qaxis)
    sb = PL.shard_batched_inputs(p, x0, mesh=mesh)
    rsb = ref.placement.shard_batched_inputs(
        rp, x0.numpy(), mesh=types.SimpleNamespace(shape=mesh.shape))
    for f in ("d_g", "d_q", "r_pad", "q_pad", "q"):
        assert getattr(sb, f) == getattr(rsb, f), f
    np.testing.assert_array_equal(sb.x0.numpy(), rsb.x0)
    np.testing.assert_array_equal(sb.valid.numpy(), rsb.valid)
    np.testing.assert_array_equal(sb.qlive, rsb.qlive)
    assert sb.halo_bytes_per_exchange(p.b) == \
        rsb.halo_bytes_per_exchange(rp.b)


def test_halo_bytes_formula_matches_reference(ref):
    for d_g, d_q, r_pad, q_pad in [(1, 1, 16, 5), (4, 2, 16, 6),
                                   (8, 1, 24, 5), (1, 8, 15, 8),
                                   (3, 4, 122_688, 64)]:
        kw = dict(mesh=None, d_g=d_g, d_q=d_q, r_pad=r_pad, q_pad=q_pad,
                  q=q_pad, valid=None, x0=None, qlive=None)
        got = PL.ShardedBatch(**kw).halo_bytes_per_exchange(16)
        want = ref.placement.ShardedBatch(
            vals=None, cols=None, nnz=None, **kw).halo_bytes_per_exchange(16)
        assert got == want


@pytest.mark.parametrize("flavor", ["sync", "async"])
def test_run_stats_match_reference_formulas(ref, flavor):
    """``bsp_stats``/``dist_run_stats`` of one ``DistStats`` equal the JAX
    package's, field by field (halo traffic per exchange, compute work
    per sweep)."""
    p, x0, _, _ = batched_case(ref, "min_plus")
    rp = ref.engine.prepare(ref.graph.road_network(10, seed=1), "min_plus",
                            b=8, num_clusters=8)
    if flavor == "sync":
        _, ds = PL.distributed_sync_run_batched(p, x0, mesh=cpu_mesh(4, 2),
                                                max_sweeps=100_000)
    else:
        _, ds = AD.distributed_async_run_batched(
            p, x0, mesh=cpu_mesh(4, 2), max_sweeps=100_000, local_sweeps=4)
    rds = ref.placement.DistStats(**{
        f.name: getattr(ds, f.name)
        for f in dataclasses.fields(ref.placement.DistStats)})
    pairs = [(eng.dist_run_stats(p, ds), ref.engine.dist_run_stats(rp, rds)),
             (eng.bsp_stats(p, ds.sweeps, ds.converged, "distributed",
                            work_sweeps=int(ds.query_sweeps.sum())),
              ref.engine.bsp_stats(rp, ds.sweeps, ds.converged,
                                   "distributed",
                                   work_sweeps=int(ds.query_sweeps.sum())))]
    for got, want in pairs:
        for k, v in dataclasses.asdict(want).items():
            assert getattr(got, k) == v, k
    assert eng.dist_run_stats(p, ds).host_syncs == ds.host_syncs


# -- the engines --------------------------------------------------------------


def test_distributed_graph_engine_single_device(ref):
    g = G.rmat(300, 1500, seed=5)
    p = eng.prepare(g, "min_plus", b=16, num_clusters=8, device=CPU)
    x0f = np.full(g.n, np.inf, dtype=np.float32)
    x0f[0] = 0
    x, ds = PL.distributed_sync_run(p, p.to_blocks(x0f, np.inf), "relax")
    np.testing.assert_allclose(x.numpy().reshape(-1)[p.perm],
                               O.sssp_oracle(g, 0), rtol=1e-5, atol=1e-4)
    assert ds.converged and ds.mesh_shape == (1, 1)
    assert ds.halo_exchanges == ds.sweeps == ds.host_syncs
    rp = ref.engine.prepare(ref.graph.rmat(300, 1500, seed=5), "min_plus",
                            b=16, num_clusters=8)
    want, rs = ref.engine.run_sync(rp, rp.to_blocks(x0f, np.inf))
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))
    assert ds.sweeps == rs.sweeps


def test_batched_engine_rejects_query_axis_0(ref):
    """The query_axis=0 per-source escape hatch is the session API's —
    the engine must refuse it rather than silently auto-factor."""
    p, x0, _, _ = batched_case(ref, "min_plus")
    with pytest.raises(ValueError, match="query_axis"):
        PL.distributed_sync_run_batched(p, x0, query_axis=0)


@pytest.mark.parametrize("semiring", ["min_plus", "max_min"])
@pytest.mark.parametrize("ndev,qaxis", FACTORIZATIONS)
def test_batched_distributed_parity_across_factorizations(
        ref, semiring, ndev, qaxis):
    """Batched-distributed == repro's run_sync_batched, BIT-identical, on
    every mesh factorization, with repro's per-source sweeps."""
    p, x0, want, sweeps = batched_case(ref, semiring)
    x, ds = PL.distributed_sync_run_batched(
        p, x0, "relax", max_sweeps=100_000, mesh=cpu_mesh(ndev, qaxis))
    assert np.array_equal(x.numpy(), want)
    assert ds.converged
    assert ds.mesh_shape == (ndev // qaxis, qaxis)
    assert ds.query_sweeps.shape == (x0.shape[0],)
    np.testing.assert_array_equal(ds.query_sweeps, sweeps)
    assert ds.sweeps == int(ds.query_sweeps.max())
    assert ds.halo_exchanges == ds.sweeps == ds.host_syncs
    assert ds.local_sweeps == 1 and ds.shard_sweeps is None


@pytest.mark.parametrize("flavor", ["sync", "async"])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_padded_last_shard_parity(ref, ndev, flavor):
    """At 5 clusters r_pad is 15, so every mesh here pads its last shard
    (at 8 devices the last shard holds 1 row of 2): the padded rows are
    never read, never written, and the values stay bit-identical."""
    p, x0, want, _ = batched_case(ref, "min_plus", num_clusters=5)
    assert p.r_pad % ndev
    mesh = cpu_mesh(ndev, 1)
    if flavor == "sync":
        x, ds = PL.distributed_sync_run_batched(p, x0, mesh=mesh,
                                                max_sweeps=100_000)
    else:
        x, ds = AD.distributed_async_run_batched(p, x0, mesh=mesh,
                                                 max_sweeps=100_000,
                                                 local_sweeps=2)
    assert x.shape == x0.shape
    assert np.array_equal(x.numpy(), want) and ds.converged


@pytest.fixture
def custom_ring():
    """min_plus under another name: a registered ring the kernels do not
    know, so plans carry no compacted index and every slot runs the
    plain version over its rows of the tile image."""
    from repro_torch.core import semiring as sr
    ring = sr.register(dataclasses.replace(sr.get("min_plus"),
                                           name="min_plus_custom"))
    yield ring.name
    del sr.SEMIRINGS[ring.name]


@pytest.mark.parametrize("flavor", ["sync", "async"])
def test_custom_semiring_runs_the_plain_version_per_shard(custom_ring,
                                                          flavor):
    g = G.road_network(10, seed=1)
    p = eng.prepare(g, custom_ring, b=8, num_clusters=5, device=CPU)
    assert p.compact_index() is None
    x0 = torch.stack([p.to_blocks(_x0_flat(g.n, s, "min_plus")[0], np.inf)
                      for s in SOURCES])
    want, _ = eng.run_sync_batched(p, x0, max_sweeps=100_000)
    mesh = cpu_mesh(4, 2)
    if flavor == "sync":
        x, ds = PL.distributed_sync_run_batched(p, x0, mesh=mesh,
                                                max_sweeps=100_000)
    else:
        x, ds = AD.distributed_async_run_batched(p, x0, mesh=mesh,
                                                 max_sweeps=100_000)
    assert torch.equal(x, want) and ds.converged


def test_empty_shards_launch_nothing(ref, monkeypatch):
    """A mesh wider than the plan's rows leaves shards with none: they
    vote, launch no SpMV and hold no state; every other slot launches
    once a sweep."""
    p, x0, want, _ = batched_case(ref, "min_plus", num_clusters=5)
    calls = []
    real = PL._spmv_ref

    def counting(*a, **kw):
        calls.append(kw["index"].r)
        return real(*a, **kw)

    monkeypatch.setattr(PL, "_spmv_ref", counting)
    x, ds = PL.distributed_sync_run_batched(p, x0, mesh=cpu_mesh(16),
                                            max_sweeps=100_000)
    # r_pad 15 over 16 shards: one row-block each, the last one empty
    assert np.array_equal(x.numpy(), want)
    assert len(calls) == ds.sweeps * 15 and set(calls) == {1}


# -- the session and the service ----------------------------------------------


@pytest.fixture(scope="module")
def road():
    return G.road_network(8, seed=1)


@pytest.fixture(scope="module")
def proc(road):
    return api.GraphProcessor(road, b=16, num_clusters=8, device=CPU)


def test_distributed_policy(road, proc, ref):
    pol = api.ExecutionPolicy(mode="distributed")
    d = proc.sssp(0, policy=pol)
    np.testing.assert_allclose(d.values, O.sssp_oracle(road, 0),
                               rtol=1e-5, atol=1e-4)
    assert d.stats.mode == "distributed"
    assert d.extra["dist"].converged
    jproc = ref.api.GraphProcessor(ref.graph.road_network(8, seed=1), b=16,
                                   num_clusters=8)
    want = jproc.sssp(0, policy=ref.api.ExecutionPolicy(mode="sync"))
    np.testing.assert_array_equal(d.values, want.values)
    assert d.stats.sweeps == want.stats.sweeps
    for k in ("tile_work", "edge_work", "crit_tiles", "halo_tiles"):
        assert getattr(d.stats, k) == getattr(want.stats, k), k


def test_batched_distributed_is_single_2d_dispatch(proc):
    """Batched mode='distributed' runs as ONE 2-D round loop (no
    per-source Python loop) and matches the sync batched engine."""
    sources = [0, 3, 7]
    pol = api.ExecutionPolicy(mode="distributed", max_sweeps=100_000)
    r = proc.sssp(sources=sources, policy=pol)
    assert r.values.shape == (len(sources), proc.g.n)
    assert "batched_fallback" not in r.extra
    dist = r.extra["dist"]
    assert dist.query_sweeps.shape == (len(sources),)
    assert r.stats.sweeps == int(dist.query_sweeps.max())
    assert r.stats.mode == "distributed" and r.stats.converged
    assert r.stats.host_syncs == r.stats.sweeps
    oracle = proc.sssp(sources=sources,
                       policy=api.ExecutionPolicy(mode="sync",
                                                  max_sweeps=100_000))
    np.testing.assert_array_equal(r.values, oracle.values)
    assert r.stats.tile_work == oracle.stats.tile_work


def test_batched_distributed_query_axis_0_escape_hatch(proc):
    """query_axis=0 keeps the per-source sequential loop as an explicit
    escape hatch, bit-identical to the 2-D dispatch."""
    sources = [0, 3, 7]
    pol = api.ExecutionPolicy(mode="distributed", max_sweeps=100_000,
                              query_axis=0)
    r = proc.sssp(sources=sources, policy=pol)
    assert r.extra["batched_fallback"] == "per-source sequential"
    batched = proc.sssp(sources=sources, policy=pol.but(query_axis=None))
    np.testing.assert_array_equal(r.values, batched.values)
    assert r.stats.sweeps == batched.stats.sweeps
    with pytest.raises(ValueError, match="query_axis"):
        api.ExecutionPolicy(query_axis=-1)


@pytest.mark.parametrize("query_axis", [None, 1])
def test_explicit_query_axis_beyond_the_devices_raises(proc, query_axis):
    """The default mesh on the CPU is one slot, as the JAX package's on
    one host device: an extent of 1 runs, 2 does not divide it."""
    pol = api.ExecutionPolicy(mode="distributed", query_axis=query_axis)
    assert proc.sssp(sources=[0, 3], policy=pol).extra["dist"].mesh_shape \
        == (1, 1)
    with pytest.raises(ValueError, match="query_axis=2"):
        proc.sssp(sources=[0, 3], policy=pol.but(query_axis=2))


def test_gather_coalesces_distributed_policy_into_2d_batched_engine(road):
    """A wave whose resolved policy is mode='distributed' runs as ONE
    batched 2-D round loop — not the per-source loop — and each ticket
    surfaces the engine's mesh/per-query sweeps."""
    dist = api.ExecutionPolicy(mode="distributed", max_sweeps=100_000)
    svc = api.GraphService(policy=dist, device=CPU)
    svc.register("roads", road, b=16, num_clusters=8)
    sources = (0, 3, 7)
    tickets = [svc.submit("roads", api.QuerySpec(algo="sssp",
                                                 sources=(s,)))
               for s in sources]
    out = svc.gather()
    for t, s in zip(tickets, sources):
        r = out[t]
        assert not isinstance(r, Exception), r
        assert r.extra["coalesced"] == len(sources)
        assert "batched_fallback" not in r.extra
        assert r.extra["dist"].query_sweeps.shape == (len(sources),)
        assert r.extra["dist_flavor"] == "sync"
        solo = svc.run("roads", api.QuerySpec(algo="sssp", sources=(s,)))
        np.testing.assert_array_equal(r.values, solo.values)
    st = svc.stats()
    assert st["batched_runs"] == 1
    assert st["coalesced_queries"] == len(sources)


# -- fault sites --------------------------------------------------------------


ENTRIES = {
    ("sync", False): lambda p, x0: PL.distributed_sync_run(p, x0[0]),
    ("sync", True): lambda p, x0: PL.distributed_sync_run_batched(p, x0),
    ("async", True): lambda p, x0: AD.distributed_async_run_batched(p, x0),
}


@pytest.mark.parametrize("flavor,batched", list(ENTRIES))
def test_fault_sites_fire_at_each_engine_entry(ref, flavor, batched):
    """``dist.dispatch`` raises and ``dist.straggler`` sleeps at each
    engine's host entry, with the flavor and batching in their context,
    as in the JAX package."""
    p, x0, _, _ = batched_case(ref, "min_plus")
    where = {"flavor": flavor, "batched": batched}
    run = ENTRIES[flavor, batched]
    with rz.inject(rz.FaultPlan([rz.FaultSpec("dist.dispatch",
                                              where=where)], seed=0)):
        with pytest.raises(rz.FaultInjected, match="dist.dispatch"):
            run(p, x0)
    plan = rz.FaultPlan([rz.FaultSpec("dist.straggler", mode="delay",
                                      delay_s=0.001, where=where)], seed=0)
    with rz.inject(plan):
        _, ds = run(p, x0)
    assert ds.converged
    assert plan.stats()["dist.straggler"]["injected"] == 1


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_plan(semiring, num_clusters, dev):
    g = G.road_network(24, seed=3)
    return g, eng.prepare(g, semiring, b=8, num_clusters=num_clusters,
                          device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("semiring", ["min_plus", "max_min", "plus_times"])
def test_cuda_slot_spmv_matches_plain(semiring, ndev, cuda):
    """Each slot's compacted SpMV over ``CompactIndex.rows`` of its shard
    (global columns, the gathered buffer as x) equals the plain version
    and the whole plan's SpMV rows, bit for bit; 5 clusters pad the last
    shard."""
    _, p = _card_plan(semiring, 5, cuda)
    index = p.compact_index()
    x = torch.rand((3, p.r_pad, p.b), generator=torch.Generator()
                   .manual_seed(ndev)).to(cuda)
    whole = tk.bsr_spmv(p.vals, p.cols, p.nnz, x, semiring, index=index)
    rl = -(-p.r_pad // ndev)
    for s in range(ndev):
        lo, hi = min(s * rl, p.r_pad), min((s + 1) * rl, p.r_pad)
        if hi == lo:
            continue
        rows = index.rows(slice(lo, hi))
        got = tk.bsr_spmv(None, None, None, x, semiring, index=rows)
        plain = tref.bsr_spmv_compact_ref(rows, x, semiring)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), s
        assert torch.equal(got, whole[:, lo:hi]), s


@pytest.mark.cuda
@pytest.mark.parametrize("ndev,qaxis", FACTORIZATIONS)
def test_cuda_distributed_matches_single_device(ndev, qaxis, cuda):
    g, p = _card_plan("min_plus", 5, cuda)
    x0 = torch.stack([p.to_blocks(_x0_flat(g.n, s, "min_plus")[0], np.inf)
                      for s in SOURCES])
    want, st = eng.run_sync_batched(p, x0, max_sweeps=100_000)
    mesh = PL.make_graph_mesh(ndev, qaxis, device=cuda)
    before = tk.launch_counts["bsr_spmv_compact"]
    x, ds = PL.distributed_sync_run_batched(p, x0, mesh=mesh,
                                            max_sweeps=100_000)
    launched = tk.launch_counts["bsr_spmv_compact"] - before
    assert torch.equal(x, want)
    assert ds.sweeps == st.sweeps and ds.host_syncs == ds.sweeps
    rl = -(-p.r_pad // (ndev // qaxis))
    filled = sum(1 for s in range(ndev // qaxis) if s * rl < p.r_pad)
    assert launched == ds.sweeps * filled * qaxis


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs (a mesh across cards)")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["sync", "async"])
def test_cuda_mesh_across_cards(cards, flavor):
    """Slots on separate cards: each shard's index rows copied to its card,
    the halo exchanged by peer copies, the vote reduced on the first card;
    values equal the single-device engine's at every query extent, and
    the session's default mesh spans every card."""
    dev0 = torch.device("cuda", 0)
    g, p = _card_plan("min_plus", 5, dev0)
    x0 = torch.stack([p.to_blocks(_x0_flat(g.n, s, "min_plus")[0], np.inf)
                      for s in SOURCES])
    want, _ = eng.run_sync_batched(p, x0, max_sweeps=100_000)
    for qaxis in [q for q in range(1, cards + 1) if cards % q == 0]:
        mesh = PL.make_graph_mesh(cards, qaxis)
        assert len({d for row in mesh.devices for d in row}) == cards
        if flavor == "sync":
            x, ds = PL.distributed_sync_run_batched(p, x0, mesh=mesh,
                                                    max_sweeps=100_000)
        else:
            x, ds = AD.distributed_async_run_batched(
                p, x0, mesh=mesh, max_sweeps=100_000, local_sweeps=2)
        assert x.device == dev0 and torch.equal(x, want), qaxis
        assert ds.converged and ds.host_syncs == ds.halo_exchanges
    proc = api.GraphProcessor(g, b=8, num_clusters=5)
    pol = api.ExecutionPolicy(mode="distributed", max_sweeps=100_000)
    if flavor == "async":
        pol = pol.but(dist_flavor="async", local_sweeps=2)
    r = proc.sssp(SOURCES, policy=pol)
    q = PL.factor_query_axis(cards, len(SOURCES))
    assert r.extra["dist"].mesh_shape == (cards // q, q)
    np.testing.assert_array_equal(
        r.values, proc.sssp(SOURCES, policy=api.ExecutionPolicy(
            mode="sync", max_sweeps=100_000)).values)
