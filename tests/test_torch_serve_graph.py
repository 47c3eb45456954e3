"""The port's plan store and ``GraphService`` against the JAX package's.

On the CPU (``device="cpu"``), on ``road_network(10, seed=1)`` at b 16
and 8 clusters: every behaviour that tests/test_graph_service.py and the
plan-store half of tests/test_resilience.py pin (the LRU byte budget,
the disk tier with its quarantine, warm restarts, the coalescing
``submit``/``gather`` front door), and parity with ``repro``: a gather's
per-ticket values bit for bit with the same wave counters, PageRank
within rtol 2e-6, ``Prepared.nbytes`` and so the LRU eviction order, and
a plan directory written by the JAX package's store read by the port's.
Also the thread safety the serving layer needs from the core: the
compacted index built once under concurrent first queries, and launch
counts exact under concurrent captures.

On the card (``-m cuda``, skipped here): an evicted plan's device bytes
are freed, a plan loaded from disk rebuilds its compacted index on the
card, and launch counts stay exact with two threads launching.

Without counterpart: ``test_prepared_is_a_pytree`` (a JAX pytree).  The
counterpart of ``test_gather_coalesces_distributed_policy_into_2d_
batched_engine`` is in tests/test_torch_placement.py, with the
distributed engines; ``test_distributed_runs_at_submit`` here takes
``mode="distributed"`` from the service, the spec and its params.
"""

import gc
import io
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch import resilience as rz  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import oracles as O  # noqa: E402
from repro_torch.kernels import bsr_spmv as tk  # noqa: E402
from repro_torch.serve import graph as sg  # noqa: E402
from repro_torch.serve.graph import QUARANTINE_DIR, TUNINGS_LOG  # noqa: E402

CPU = "cpu"
SEED = int(os.environ.get("REPRO_FAULT_SEED", "1234"))


@pytest.fixture(scope="module")
def road():
    return G.road_network(10, seed=1)


@pytest.fixture(scope="module")
def ref():
    """The JAX package, for the parity tests; they skip where JAX is
    absent (the card's machine runs only the ``-m cuda`` tests)."""
    pytest.importorskip("jax")
    from repro import api
    from repro.core import graph
    from repro.serve import graph as serve_graph
    return types.SimpleNamespace(api=api, graph=graph, serve_graph=serve_graph)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    rz.uninstall()   # a test that fails mid-``inject`` must not leak


def proc_of(g, **kw):
    return api.GraphProcessor(g, b=16, num_clusters=8, device=CPU, **kw)


def service(**kw):
    return api.GraphService(device=CPU, **kw)


def sssp(s):
    return api.QuerySpec(algo="sssp", sources=(s,))


def _plan_key(i: int) -> api.PlanKey:
    return api.PlanKey("min_plus", "base", True, None, 16, 4 + i, True)


def fplan(*specs):
    return rz.FaultPlan(specs, seed=SEED)


# -- fingerprint + Prepared round trip ---------------------------------------


def test_graph_fingerprint_content_based(road, ref):
    same = G.Graph(n=road.n, indptr=road.indptr.copy(),
                   indices=road.indices.copy(), weights=road.weights.copy())
    assert road.fingerprint() == same.fingerprint()
    other = G.Graph(n=road.n, indptr=road.indptr, indices=road.indices,
                    weights=road.weights + 1.0)
    assert road.fingerprint() != other.fingerprint()
    # the store key's graph half is the JAX package's, so plan files match
    assert road.fingerprint() == \
        ref.graph.road_network(10, seed=1).fingerprint()


def test_prepared_serialize_roundtrip(road):
    p = proc_of(road).prepare("min_plus")
    p2 = api.deserialize_prepared(api.serialize_prepared(p), CPU)
    for f in eng._PREPARED_DEVICE_FIELDS:
        assert torch.equal(getattr(p2, f), getattr(p, f)), f
    for f in ("n", "b", "r_pad", "k_max", "gb", "s", "semiring",
              "tiles_total", "edges_total"):
        assert getattr(p2, f) == getattr(p, f), f
    np.testing.assert_array_equal(p2.perm, p.perm)
    np.testing.assert_array_equal(p2.inv_perm, p.inv_perm)
    np.testing.assert_array_equal(p2.clustering.schedule,
                                  p.clustering.schedule)
    np.testing.assert_array_equal(p2.clustering.assign, p.clustering.assign)
    assert p2.nbytes == p.nbytes
    x0 = p2.to_blocks(np.where(np.arange(road.n) == 0, 0.0,
                               np.inf).astype(np.float32), np.inf)
    x, stats = eng.run_async(p2, x0)
    np.testing.assert_allclose(p2.from_blocks(x), O.sssp_oracle(road, 0),
                               rtol=1e-5, atol=1e-4)
    assert stats.converged


def test_deserialize_rejects_future_versions(road):
    p = proc_of(road).prepare("min_plus")
    payload = eng._unframe_payload(api.serialize_prepared(p))
    with np.load(io.BytesIO(payload)) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(arrays["__meta__"].tobytes().decode())
    meta["version"] = 99
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with pytest.raises(ValueError, match="version"):
        api.deserialize_prepared(buf.getvalue(), CPU)


def test_serialized_plan_roundtrip_and_checksum(road):
    p = eng.prepare(road, "min_plus", b=16, device=CPU)
    blob = api.serialize_prepared(p)
    assert torch.equal(api.deserialize_prepared(blob, CPU).cols, p.cols)
    pos = len(blob) // 2
    bad = blob[:pos] + bytes([blob[pos] ^ 0xFF]) + blob[pos + 1:]
    with pytest.raises(eng.PlanIntegrityError, match="checksum"):
        api.deserialize_prepared(bad, CPU)


def test_legacy_unframed_payloads_still_load(road):
    p = eng.prepare(road, "min_plus", b=16, device=CPU)
    framed = api.serialize_prepared(p)
    legacy = framed[len(eng._PLAN_MAGIC) + eng._PLAN_DIGEST_SIZE:]
    assert torch.equal(api.deserialize_prepared(legacy, CPU).vals, p.vals)


# -- PlanStore: LRU byte budget + disk tier ----------------------------------


def test_plan_store_lru_eviction_order(road):
    p = proc_of(road).prepare("min_plus")
    store = api.PlanStore(max_bytes=int(p.nbytes * 2.5), device=CPU)
    fp = road.fingerprint()
    store.put(fp, _plan_key(0), p)
    store.put(fp, _plan_key(1), p)
    assert (fp, _plan_key(0)) in store and (fp, _plan_key(1)) in store
    store.get(fp, _plan_key(0))          # touch 0: now 1 is the LRU
    store.put(fp, _plan_key(2), p)       # over budget → evicts 1, not 0
    assert (fp, _plan_key(1)) not in store
    assert (fp, _plan_key(0)) in store and (fp, _plan_key(2)) in store
    st = store.stats()
    assert st["evictions"] == 1 and st["plans"] == 2
    assert st["bytes"] <= store.max_bytes
    assert store.get(fp, _plan_key(1)) is None  # no disk tier: gone


def test_plan_store_disk_tier_backfills_eviction(road, tmp_path):
    p = proc_of(road).prepare("min_plus")
    store = api.PlanStore(max_bytes=int(p.nbytes * 1.5),
                          cache_dir=str(tmp_path), device=CPU)
    fp = road.fingerprint()
    store.put(fp, _plan_key(0), p)
    store.put(fp, _plan_key(1), p)       # evicts 0 from memory
    assert (fp, _plan_key(0)) not in store
    p0 = store.get(fp, _plan_key(0))     # ... but disk still has it
    assert p0 is not None and p0 is not p
    assert torch.equal(p0.vals, p.vals)
    assert p0.compact is None            # rebuilt at its first query
    assert store.stats()["disk_hits"] == 1


def test_processor_borrows_plans_from_injected_store(road, tmp_path):
    store = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    a = proc_of(road, store=store)
    b = proc_of(road, store=store)
    assert a.prepare("min_plus") is b.prepare("min_plus")
    assert a._prepare_calls == 1 and b._prepare_calls == 0
    assert store.stats()["mem_hits"] == 1
    assert a.cache_info()["store"] == store.stats()
    assert a.cache_info()["plans"] == 0   # no private copy
    assert "store" not in proc_of(road).cache_info()


def test_plan_store_stats_split_memory_vs_disk_tiers(road, tmp_path):
    p = proc_of(road).prepare("min_plus")
    store = api.PlanStore(max_bytes=int(p.nbytes * 1.5),
                          cache_dir=str(tmp_path), device=CPU)
    fp = road.fingerprint()
    store.put(fp, _plan_key(0), p)
    store.get(fp, _plan_key(0))          # memory hit
    store.put(fp, _plan_key(1), p)       # evicts 0 to disk-only
    store.get(fp, _plan_key(0))          # disk hit
    store.get(fp, _plan_key(9))          # miss
    st = store.stats()
    assert st["mem_hits"] == 1 and st["disk_hits"] == 1
    assert st["misses"] == 1
    assert st["mem_hit_rate"] == pytest.approx(1 / 3)
    assert st["disk_hit_rate"] == pytest.approx(1 / 3)
    assert st["hit_rate"] == pytest.approx(2 / 3)


@pytest.mark.parametrize("garbage", ["empty", "not-a-zip", "truncated"])
def test_plan_store_recovers_from_corrupt_disk_entries(road, tmp_path,
                                                       garbage):
    p = proc_of(road).prepare("min_plus")
    store = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    fp = road.fingerprint()
    store.put(fp, _plan_key(0), p)
    (path,) = [tmp_path / f for f in os.listdir(tmp_path)]
    path.write_bytes({"empty": b"", "not-a-zip": b"not a zip",
                      "truncated": path.read_bytes()[:100]}[garbage])
    fresh = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    assert fresh.get(fp, _plan_key(0)) is None   # dropped, no raise
    assert not path.exists()


@pytest.mark.parametrize("how", ["enospc", "fault-plan"])
def test_plan_store_disk_write_failure_is_best_effort(road, tmp_path,
                                                      monkeypatch, how):
    """A full/read-only cache dir must not fail a query whose plan is
    already good in memory (an ``open`` that raises ENOSPC, or the
    ``planstore.disk_write`` site)."""
    if how == "enospc":
        p = proc_of(road).prepare("min_plus")
        store = api.PlanStore(cache_dir=str(tmp_path), device=CPU)

        def enospc(*a, **kw):
            raise OSError(28, "No space left on device")
        monkeypatch.setattr("builtins.open", enospc)
        store.put(road.fingerprint(), _plan_key(0), p)   # no raise
        monkeypatch.undo()
        assert store.get(road.fingerprint(), _plan_key(0)) is p
        assert store.stats()["disk_errors"] == 1
        return
    svc = service(cache_dir=str(tmp_path))
    svc.register("g", road, b=16, num_clusters=8)
    with rz.inject(fplan(rz.FaultSpec("planstore.disk_write",
                                      exc="oserror"))):
        r = svc.run("g", sssp(0))        # the query succeeds anyway
    assert r.values.shape == (road.n,)
    assert svc.stats()["plan_store"]["disk_errors"] >= 1


def test_plan_store_keeps_an_oversized_plan(road):
    p = proc_of(road).prepare("min_plus")
    store = api.PlanStore(max_bytes=1, device=CPU)
    fp = road.fingerprint()
    store.put(fp, _plan_key(0), p)
    assert store.get(fp, _plan_key(0)) is p
    store.put(fp, _plan_key(1), p)       # newest survives, LRU evicted
    assert store.get(fp, _plan_key(1)) is p
    assert (fp, _plan_key(0)) not in store


def test_corrupt_disk_plan_quarantined_and_rebuilt(road, tmp_path):
    d = str(tmp_path)
    svc = service(cache_dir=d)
    svc.register("g", road, b=16, num_clusters=8)
    base = svc.run("g", sssp(0))
    svc2 = service(cache_dir=d)          # cold restart, corrupt read
    svc2.register("g", road, b=16, num_clusters=8)
    plan = fplan(rz.FaultSpec("planstore.disk_read", mode="corrupt"))
    with rz.inject(plan):
        r = svc2.run("g", sssp(0))
    assert plan.stats()["planstore.disk_read"]["injected"] >= 1
    np.testing.assert_array_equal(r.values, base.values)
    assert svc2.stats()["plan_store"]["quarantined"] >= 1
    qdir = os.path.join(d, QUARANTINE_DIR)
    assert os.path.isdir(qdir) and len(os.listdir(qdir)) >= 1


def test_corrupt_sidecar_logs_warn_quarantine_start_fresh(road, tmp_path):
    d = str(tmp_path)
    (tmp_path / TUNINGS_LOG).write_text('{"version": 2, "tunings": [[')
    (tmp_path / sg.ACCESS_LOG).write_text("garbage{{{")
    with pytest.warns(RuntimeWarning, match="quarantined corrupt"):
        svc = service(cache_dir=d)       # must NOT raise
    svc.register("g", road, b=16, num_clusters=8)
    assert svc.run("g", sssp(0)).values.shape == (road.n,)
    assert svc.stats()["plan_store"]["quarantined"] == 2
    assert len(os.listdir(os.path.join(d, QUARANTINE_DIR))) == 2


def test_tampered_checksum_detected(road, tmp_path):
    d = str(tmp_path)
    svc = service(cache_dir=d)
    svc.register("g", road, b=16, num_clusters=8)
    svc.run("g", sssp(0))
    svc.store._flush_tunings()
    path = tmp_path / TUNINGS_LOG
    doc = json.loads(path.read_text())
    assert doc["version"] == 2 and "checksum" in doc
    doc["checksum"] = "0" * 32
    path.write_text(json.dumps(doc))
    with pytest.warns(RuntimeWarning, match="checksum mismatch"):
        service(cache_dir=d)


def test_tuning_records_survive_a_store_restart(road, tmp_path):
    """The tunings sidecar as storage: records written by one store are
    read by the next (tests/test_torch_autotune.py's ``test_tunings_
    survive_plan_store_restart`` measures them with the autotuner)."""
    store = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    fp = road.fingerprint()
    key = api.PlanKey("min_plus", "base", True, None, 16, 8, True,
                      kernel=api.KernelSpec(impl="pallas"))
    assert store.get_tuning(fp, key) is None
    store.put_tuning(fp, key, {"block_rows": 8, "ms": 0.5})
    again = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    assert again.get_tuning(fp, key) == {"block_rows": 8, "ms": 0.5}
    assert again.stats()["tunings"] == 1


# -- GraphService: registry, warm restart, coalescing ------------------------


def test_service_registry_lifecycle(road):
    svc = service()
    svc.register("roads", road, b=16, num_clusters=8)
    assert "roads" in svc and svc.graphs() == ["roads"]
    assert svc.register("roads", road, b=16, num_clusters=8) is \
        svc.get("roads")
    assert svc.get("roads").device == torch.device(CPU)
    with pytest.raises(ValueError, match="evict"):
        svc.register("roads", G.road_network(6, seed=3))
    with pytest.raises(KeyError, match="no graph registered"):
        svc.get("nope")
    svc.evict("roads")
    assert "roads" not in svc


@pytest.mark.parametrize("change", [dict(b=32, num_clusters=8),
                                    dict(b=16, num_clusters=4)],
                         ids=["b", "clusters"])
def test_register_rejects_changed_session_parameters(road, change):
    svc = service()
    svc.register("roads", road, b=16, num_clusters=8)
    with pytest.raises(ValueError, match="evict"):
        svc.register("roads", road, **change)


def test_service_warm_restart_skips_compile_pipeline(road, tmp_path,
                                                     monkeypatch):
    cache = str(tmp_path / "plans")
    svc = service(cache_dir=cache)
    svc.register("roads", road, b=16, num_clusters=8)
    r1 = svc.run("roads", sssp(0))

    def boom(*a, **kw):
        raise AssertionError("compile pipeline ran on a warm restart")
    monkeypatch.setattr(eng, "prepare", boom)
    svc2 = service(cache_dir=cache)
    proc2 = svc2.register("roads", road, b=16, num_clusters=8)
    r2 = svc2.run("roads", sssp(0))
    assert proc2._prepare_calls == 0
    assert svc2.store.stats()["disk_hits"] == 1
    np.testing.assert_array_equal(r1.values, r2.values)
    np.testing.assert_allclose(r2.values, O.sssp_oracle(road, 0),
                               rtol=1e-5, atol=1e-4)


def test_gather_coalesces_and_matches_sequential_runs(road):
    svc = service()
    svc.register("roads", road, b=16, num_clusters=8)
    sssp_srcs, bfs_srcs = [0, 3, 7, 11], [0, 9]
    tickets = {("sssp", s): svc.submit("roads", sssp(s)) for s in sssp_srcs}
    for s in bfs_srcs:
        tickets[("bfs", s)] = svc.submit(
            "roads", api.QuerySpec(algo="bfs", sources=(s,)))
    t_pr = svc.submit("roads", api.QuerySpec(algo="pagerank"))
    out = svc.gather()
    assert set(out) == set(tickets.values()) | {t_pr}
    for (algo, s), t in tickets.items():
        solo = svc.run("roads", api.QuerySpec(algo=algo, sources=(s,)))
        np.testing.assert_array_equal(out[t].values, solo.values)
        assert out[t].extra["coalesced"] == \
            {"sssp": len(sssp_srcs), "bfs": len(bfs_srcs)}[algo]
        assert out[t].extra["src"] == s
    np.testing.assert_allclose(
        out[t_pr].values, O.pagerank_oracle(road, tol=1e-12), atol=1e-5)
    st = svc.stats()
    assert st["coalesced_queries"] == len(sssp_srcs) + len(bfs_srcs)
    assert st["batched_runs"] == 2        # one wave per algorithm
    assert st["pending"] == 0


def test_gather_respects_max_wave_and_policy_grouping(road):
    svc = service(max_wave=2)
    svc.register("roads", road, b=16, num_clusters=8)
    sync = api.ExecutionPolicy(mode="sync", max_sweeps=100_000)
    t = [svc.submit("roads", sssp(s)) for s in (0, 3, 7)]  # 2 then 1
    t_sync = svc.submit("roads", api.QuerySpec(algo="sssp", sources=(5,),
                                               policy=sync))
    out = svc.gather()
    for ti, s in zip(t, (0, 3, 7)):
        np.testing.assert_allclose(out[ti].values, O.sssp_oracle(road, s),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out[t_sync].values, O.sssp_oracle(road, 5),
                               rtol=1e-5, atol=1e-4)
    assert out[t_sync].stats.mode == "sync"
    assert svc.stats()["coalesced_queries"] == 2  # only the first wave


def test_submit_unknown_graph_fails_fast(road):
    svc = service()
    svc.register("roads", road, b=16, num_clusters=8)
    with pytest.raises(KeyError, match="no graph registered as 'ghost'"):
        svc.submit("ghost", sssp(0))
    assert svc.stats()["pending"] == 0
    assert svc.gather() == {}


@pytest.mark.parametrize("spec,exc,match", [
    (dict(algo="sssp"), ValueError, "source"),
    (dict(algo="warp", sources=(0,)), ValueError, "unknown algorithm"),
    (dict(algo="sssp", sources=(0,), params={"warp_speed": 9}), TypeError,
     None),
], ids=["no-source", "unknown-algo", "unknown-field"])
def test_submit_validates_spec_so_bad_requests_cannot_poison_a_batch(
        road, spec, exc, match):
    svc = service()
    svc.register("roads", road, b=16, num_clusters=8)
    with pytest.raises(exc, match=match):
        svc.submit("roads", api.QuerySpec(**spec))
    assert svc.stats()["pending"] == 0


@pytest.mark.parametrize("where", ["service", "spec", "params"])
def test_distributed_runs_at_submit(road, where):
    """``mode="distributed"`` from the service's policy, the spec's or its
    params is taken at submit, queued, and served with the sync engine's
    values; the ticket carries the distributed engine's stats."""
    dist = api.ExecutionPolicy(mode="distributed", max_sweeps=100_000)
    svc = service(policy=dist if where == "service" else None)
    svc.register("roads", road, b=16, num_clusters=8)
    spec = {"service": sssp(0),
            "spec": api.QuerySpec(algo="sssp", sources=(0,), policy=dist),
            "params": api.QuerySpec(algo="sssp", sources=(0,),
                                    params={"mode": "distributed"})}[where]
    t = svc.submit("roads", spec)
    assert svc.stats()["pending"] == 1
    res = svc.gather()[t]
    assert not isinstance(res, Exception), res
    assert res.stats.mode == "distributed" and res.extra["dist"].converged
    want = proc_of(road).sssp(0, policy=api.ExecutionPolicy(
        mode="sync", max_sweeps=100_000))
    np.testing.assert_array_equal(res.values, want.values)


def test_gather_isolates_runtime_failures_per_ticket(road, monkeypatch):
    svc = service()
    proc = svc.register("roads", road, b=16, num_clusters=8)
    t_ok = svc.submit("roads", api.QuerySpec(algo="pagerank"))
    t_bad = svc.submit("roads", api.QuerySpec(algo="cc"))
    real_run = proc.run

    def flaky(spec):
        if spec.algo == "cc":
            raise RuntimeError("engine fell over")
        return real_run(spec)
    monkeypatch.setattr(proc, "run", flaky)
    out = svc.gather()
    assert isinstance(out[t_bad], RuntimeError)
    np.testing.assert_allclose(
        out[t_ok].values, O.pagerank_oracle(road, tol=1e-12), atol=1e-5)


def test_evict_resolves_pending_tickets_instead_of_dropping_them(road):
    svc = service()
    svc.register("roads", road, b=16, num_clusters=8)
    svc.register("keep", G.road_network(6, seed=3), b=16, num_clusters=4)
    t_gone = svc.submit("roads", sssp(0))
    t_kept = svc.submit("keep", sssp(0))
    svc.evict("roads")
    out = svc.gather()
    assert isinstance(out[t_gone], KeyError)
    assert out[t_kept].stats.converged


def test_service_shares_plans_across_graph_names(road):
    svc = service()
    a = svc.register("a", road, b=16, num_clusters=8)
    b = svc.register("b", road, b=16, num_clusters=8)
    assert a.prepare("min_plus") is b.prepare("min_plus")
    assert svc.store.stats()["puts"] == 1


def test_service_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None selects it")
    for make in (api.GraphService, api.PlanStore):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# -- parity with the JAX package ---------------------------------------------


@pytest.fixture(scope="module")
def pair(ref):
    """The same graph served by both packages."""
    js = ref.api.GraphService()
    js.register("roads", ref.graph.road_network(10, seed=1), b=16,
                num_clusters=8)
    ts = service()
    ts.register("roads", G.road_network(10, seed=1), b=16, num_clusters=8)
    return js, ts


def test_gather_parity_with_reference(pair, ref):
    """Five sssp tickets coalesce into one wave in both packages: the
    same per-ticket values bit for bit, and the same wave counters."""
    js, ts = pair
    srcs = (0, 13, 42, 77, 99)
    out = {}
    for name, svc, qs in (("jax", js, ref.api.QuerySpec),
                          ("torch", ts, api.QuerySpec)):
        tickets = [svc.submit("roads", qs(algo="sssp", sources=(s,)))
                   for s in srcs]
        res = svc.gather()
        out[name] = [res[t] for t in tickets]
    for j, t, s in zip(out["jax"], out["torch"], srcs):
        np.testing.assert_array_equal(t.values, np.asarray(j.values))
        assert t.extra["coalesced"] == j.extra["coalesced"] == len(srcs)
        assert t.extra["src"] == j.extra["src"] == s
        assert t.stats.sweeps == j.stats.sweeps
        assert t.stats.tile_work == j.stats.tile_work
    assert ts.stats()["batched_runs"] == js.stats()["batched_runs"]


def test_pagerank_parity_with_reference(pair, ref):
    js, ts = pair
    j = js.run("roads", ref.api.QuerySpec(algo="pagerank"))
    t = ts.run("roads", api.QuerySpec(algo="pagerank"))
    np.testing.assert_allclose(t.values, np.asarray(j.values), rtol=2e-6)
    assert abs(t.stats.sweeps - j.stats.sweeps) <= 2


PLANS = [("min_plus", "base", None), ("min_plus", "unit", None),
         ("plus_times", "base", "out_stochastic"),
         ("min_select", "undirected", None), ("max_min", "unit", None),
         ("plus_times", "unit_undirected", None)]


def test_nbytes_and_eviction_order_equal_reference(road, ref):
    jp = ref.api.GraphProcessor(ref.graph.road_network(10, seed=1), b=16,
                             num_clusters=8)
    tp = proc_of(road)
    sizes = []
    for semiring, variant, normalize in PLANS:
        a = jp.prepare(semiring, variant=variant, normalize=normalize)
        b = tp.prepare(semiring, variant=variant, normalize=normalize)
        assert b.nbytes == a.nbytes, (semiring, variant)
        sizes.append(b.nbytes)
    # one LRU over both packages' plans, the same accesses: same evictions
    budget = int(sum(sizes) * 0.55)
    stores = {"jax": ref.api.PlanStore(max_bytes=budget),
              "torch": api.PlanStore(max_bytes=budget, device=CPU)}
    fp = road.fingerprint()
    seen = {}
    for name, store, proc in (("jax", stores["jax"], jp),
                              ("torch", stores["torch"], tp)):
        order = []
        for i, (semiring, variant, normalize) in enumerate(PLANS * 2):
            key = proc.plan_key(semiring, variant, normalize=normalize)
            if i % 3 == 2:
                store.get(fp, proc.plan_key(*PLANS[0][:2]))
            store.put(fp, key, proc.prepare(semiring, variant=variant,
                                            normalize=normalize))
            order.append([repr(k) for _, k in store.keys()])
        seen[name] = (order, store.stats()["evictions"],
                      store.stats()["bytes"])
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][1] > 0


def test_reads_a_plan_directory_written_by_the_reference(road, ref,
                                                         tmp_path,
                                                         monkeypatch):
    d = str(tmp_path)
    js = ref.api.GraphService(cache_dir=d)
    js.register("roads", ref.graph.road_network(10, seed=1), b=16,
                num_clusters=8)
    want = np.asarray(js.run("roads", ref.api.QuerySpec(
        algo="sssp", sources=(5,))).values)
    jproc = js.get("roads")
    key = jproc.plan_key("min_plus")
    name = ref.serve_graph._plan_filename(road.fingerprint(), key)
    assert sg._plan_filename(road.fingerprint(),
                             proc_of(road).plan_key("min_plus")) == name
    assert os.path.exists(os.path.join(d, name))

    def boom(*a, **kw):
        raise AssertionError("the port rebuilt a plan it could read")
    monkeypatch.setattr(eng, "prepare", boom)
    ts = service(cache_dir=d)
    proc = ts.register("roads", road, b=16, num_clusters=8)
    got = ts.run("roads", sssp(5))
    assert proc._prepare_calls == 0
    assert ts.store.stats()["disk_hits"] == 1
    np.testing.assert_array_equal(got.values, want)
    # the reference's access log names the plan for the port's warming
    js.store.flush_access_log()
    assert key.semiring in [k.semiring for k in api.PlanStore(
        cache_dir=d, device=CPU).hot_keys(road.fingerprint())]


# -- what the serving layer needs from the core, under threads ---------------


def test_compact_index_built_once_under_concurrent_first_queries(
        road, monkeypatch):
    p = eng.prepare(road, "min_plus", b=16, num_clusters=8, device=CPU)
    calls = []
    real = tk.build_compact_index

    def slow_build(*a, **k):
        calls.append(1)
        time.sleep(0.05)             # widen the race window
        return real(*a, **k)
    monkeypatch.setattr(tk, "build_compact_index", slow_build)
    got = [None] * 8
    barrier = threading.Barrier(len(got))

    def first_query(i):
        barrier.wait(timeout=30)
        got[i] = p.compact_index()
    threads = [threading.Thread(target=first_query, args=(i,))
               for i in range(len(got))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert all(ix is got[0] for ix in got) and got[0] is not None


def test_launch_counts_exact_under_concurrent_captures():
    """Threads counting launches, some inside their own capture: every
    eager launch reaches ``launch_counts`` once, every captured one only
    through ``add_launches``, and no update is lost (more threads than
    cores, a short switch interval)."""
    tk.reset_launch_counts()
    n_threads, n_iter = 16, 200
    barrier = threading.Barrier(n_threads)
    records = []
    lock = threading.Lock()

    def worker(i):
        barrier.wait(timeout=30)
        for k in range(n_iter):
            if i % 2:
                with tk.capture_launches() as rec:
                    tk.count_launch("bsr_spmv_compact")
                    tk.count_launch("bsr_spmv_fused_compact")
                with lock:
                    records.append(rec)
            else:
                tk.count_launch("bsr_spmv_compact")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    eager = (n_threads // 2) * n_iter
    assert tk.launch_counts["bsr_spmv_compact"] == eager
    assert tk.launch_counts["bsr_spmv_fused_compact"] == 0
    assert all(r["bsr_spmv_compact"] == 1 and r["bsr_spmv_fused_compact"]
               == 1 for r in records) and len(records) == eager
    for r in records:                    # one replay of each capture
        tk.add_launches(r)
    assert tk.launch_counts["bsr_spmv_compact"] == 2 * eager
    assert tk.launch_counts["bsr_spmv_fused_compact"] == eager
    tk.reset_launch_counts()


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (device memory, CUDA graphs and "
                    "the kernels have no CPU mode)")
    return torch.device("cuda")


def _device_bytes(p):
    """A plan's bytes on its device (``nbytes`` also counts the
    permutations, which live on the host)."""
    return sum(getattr(p, f).numel() * getattr(p, f).element_size()
               for f in eng._PREPARED_DEVICE_FIELDS)


def _ca(scale=0.002):
    return G.make_paper_graph("ca", scale=scale, seed=0)


@pytest.mark.cuda
def test_cuda_evicted_plan_frees_device_bytes(cuda):
    g = _ca()
    svc = api.GraphService(device=cuda)
    proc = svc.register("ca", g, b=16, num_clusters=8)
    p = proc.prepare("min_plus")
    svc.store.max_bytes = p.nbytes        # room for this plan alone
    values = svc.run("ca", sssp(0)).values    # builds the compacted index
    plan_bytes = _device_bytes(p) + p.compact.nbytes
    del p
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    proc.prepare("min_plus", variant="unit")  # evicts the min_plus plan
    assert svc.store.stats()["evictions"] == 1
    unit = svc.store.peek(g.fingerprint(), proc.plan_key("min_plus",
                                                         "unit"))
    gc.collect()
    torch.cuda.synchronize()
    freed = before + _device_bytes(unit) - torch.cuda.memory_allocated()
    assert freed >= plan_bytes * 0.99, (freed, plan_bytes)
    np.testing.assert_allclose(values, O.sssp_oracle(g, 0), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_disk_loaded_plan_rebuilds_index_on_card(cuda, tmp_path):
    g = _ca()
    first = api.GraphService(cache_dir=str(tmp_path), device=cuda)
    first.register("ca", g, b=16, num_clusters=8)
    fused = api.ExecutionPolicy(mode="async", kernel=api.KernelSpec(
        impl="pallas", fuse_frontier=True))
    spec = api.QuerySpec(algo="sssp", sources=(7,), policy=fused)
    want = first.run("ca", spec).values
    again = api.GraphService(cache_dir=str(tmp_path), device=cuda)
    proc = again.register("ca", g, b=16, num_clusters=8)
    p = proc.prepare("min_plus")
    assert proc._prepare_calls == 0 and p.compact is None
    assert p.vals.is_cuda
    tk.reset_launch_counts()
    got = again.run("ca", spec)
    assert p.compact is not None and p.compact.pairs.is_cuda
    np.testing.assert_array_equal(got.values, want)
    assert tk.launch_counts["bsr_spmv_fused_compact"] == \
        got.stats.sweeps * p.s


@pytest.mark.cuda
def test_cuda_launch_counts_exact_with_two_threads(cuda, monkeypatch):
    """A sync query launches while another thread captures its async
    sweep (held open until the sync query is done): the totals are the
    two queries' own, not a capture's snapshot of both."""
    g = _ca()
    proc = api.GraphProcessor(g, b=16, num_clusters=8, device=cuda)
    fused = api.KernelSpec(impl="pallas", fuse_frontier=True)
    asyn = api.ExecutionPolicy(mode="async", kernel=fused)
    sync = api.ExecutionPolicy(mode="sync", kernel=fused)
    proc.prepare("min_plus").compact_index()
    capturing, sync_done = threading.Event(), threading.Event()
    real = eng._CapturedSweep

    class Held(real):
        def __init__(self, sweep, device):
            def held():
                flags = sweep()
                capturing.set()
                sync_done.wait(timeout=60)
                return flags
            super().__init__(held, device)
    monkeypatch.setattr(eng, "_CapturedSweep", Held)
    tk.reset_launch_counts()
    out = {}

    def run_async():
        out["async"] = proc.sssp(0, policy=asyn)

    def run_sync():
        capturing.wait(timeout=60)
        try:
            out["sync"] = proc.sssp(9, policy=sync)
        finally:
            sync_done.set()
    threads = [threading.Thread(target=run_async),
               threading.Thread(target=run_sync)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    s = proc.prepare("min_plus").s
    a, b = out["async"].stats, out["sync"].stats
    assert tk.launch_counts["bsr_spmv_fused_compact"] == \
        a.sweeps * s + b.sweeps
    assert a.capture_s > 0.0
    monkeypatch.undo()
    np.testing.assert_array_equal(out["async"].values,
                                  proc.sssp(0, policy=asyn).values)
    np.testing.assert_array_equal(out["sync"].values,
                                  proc.sssp(9, policy=sync).values)
