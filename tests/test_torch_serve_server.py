"""The port's ``GraphServer`` and wave scheduler, as the JAX package's.

On the CPU (``device="cpu"``), on ``road_network(10, seed=1)`` at b 16
and 8 clusters: every behaviour that tests/test_graph_server.py and the
scheduler half of tests/test_resilience.py pin — futures bit-identical
to direct runs under concurrent clients, wave shapes, deadlines,
cancellation, admission control, eviction and shutdown, plan warming
from the access log, the asyncio adapter, the degradation ladder seen
by the service, retries with backoff, the watchdog, and faults at every
site — plus a server's results against the JAX package's server on the
same requests.  Every wait is bounded.

On the card (``-m cuda``, skipped here): an async wave captures its
sweep while a second thread uploads a plan through
``GraphServer.register(warm=True)`` and a third runs a sync query, all
three equal to their serial runs; two dispatch workers serve async waves
of two plans at once, bit-identical to serial runs, with exact launch
counts; and the reason the capture runs in thread-local mode: in the
default global mode the same upload breaks the capture.

Also ``test_distributed_fault_falls_back_to_single_device_sync``: a
failed exchange round of the distributed engine walks the ladder down
to single-device sync, bit for bit, in the session and in the server.
"""

import asyncio
import os
import threading
import time
import types
from concurrent.futures import Future

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
from repro_torch.serve.sched import _Request  # noqa: E402

CPU = "cpu"
SEED = int(os.environ.get("REPRO_FAULT_SEED", "1234"))
WAIT = 60          # seconds: the bound on every wait for a future


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
    from repro.serve import sched
    return types.SimpleNamespace(api=api, graph=graph, sched=sched)


@pytest.fixture()
def svc(road):
    svc = api.GraphService(device=CPU)
    svc.register("roads", road, b=16, num_clusters=8)
    return svc


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    rz.uninstall()
    # a dispatch the watchdog reaped sleeps out its injected delay on a
    # daemon thread: let it end here, not while the interpreter exits
    for t in threading.enumerate():
        if t.name == "repro-torch-wave-dispatch":
            t.join(timeout=WAIT)


def paused(svc, **wave_kw):
    """Server with the scheduler paused: submits accumulate, start()
    then closes deterministic waves (no timing races in assertions)."""
    wave = api.WavePolicy(**{"max_wait_s": 0.005, **wave_kw})
    return api.GraphServer(service=svc, wave=wave, autostart=False)


def sssp(s):
    return api.QuerySpec(algo="sssp", sources=(s,))


def fplan(*specs):
    return rz.FaultPlan(specs, seed=SEED)


def direct(svc, spec):
    return svc.run("roads", spec).values


# -- correctness: futures == direct runs -------------------------------------


def test_live_server_results_bit_identical_to_direct_run(svc):
    with api.GraphServer(service=svc) as server:
        futs = {s: server.submit("roads", sssp(s)) for s in (0, 3, 7)}
        f_pr = server.submit("roads", api.QuerySpec(algo="pagerank"))
        for s, f in futs.items():
            np.testing.assert_array_equal(f.result(WAIT).values,
                                          direct(svc, sssp(s)))
        np.testing.assert_array_equal(
            f_pr.result(WAIT).values,
            direct(svc, api.QuerySpec(algo="pagerank")))


def test_concurrent_clients_bit_identical_and_waves_batch(svc):
    server = paused(svc, max_wave=8)
    sources = list(range(16))
    futs = {}
    lock = threading.Lock()
    barrier = threading.Barrier(4)

    def client(chunk):
        barrier.wait(timeout=WAIT)
        for s in chunk:
            f = server.submit("roads", sssp(s))
            with lock:
                futs[s] = f

    threads = [threading.Thread(target=client, args=(sources[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert server.sched.pending() == len(sources)
    server.start()
    for s in sources:
        np.testing.assert_array_equal(futs[s].result(WAIT).values,
                                      direct(svc, sssp(s)))
        assert futs[s].result().extra["src"] == s
    st = server.stats()["scheduler"]
    assert st["completed"] == len(sources)
    assert st["waves"] == 2 and st["max_wave"] == 8    # 16 = 2 × 8
    assert st["achieved_wave"] > 1.0
    assert st["coalesced_waves"] == 2
    server.close()


def test_scheduler_coalesces_across_submits_in_wait_window(svc):
    server = api.GraphServer(service=svc, wave=api.WavePolicy(
        max_wait_s=1.0, max_wave=64))
    futs = [server.submit("roads", sssp(s)) for s in (0, 3, 7)]
    for f, s in zip(futs, (0, 3, 7)):
        np.testing.assert_array_equal(f.result(WAIT).values,
                                      direct(svc, sssp(s)))
    assert server.stats()["scheduler"]["max_wave"] >= 2
    server.close()


def test_wave_chunks_respect_max_wave(svc):
    server = paused(svc, max_wave=2)
    futs = [server.submit("roads", sssp(s)) for s in range(5)]
    server.start()
    for s, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(WAIT).values,
                                      direct(svc, sssp(s)))
    st = server.stats()["scheduler"]
    assert st["waves"] == 3 and st["max_wave"] == 2    # 2 + 2 + 1
    server.close()


def test_mixed_algorithms_route_like_gather(svc):
    server = paused(svc, max_wave=8)
    f_s = [server.submit("roads", sssp(s)) for s in (0, 5)]
    bfs = [api.QuerySpec(algo="bfs", sources=(s,)) for s in (0, 9)]
    f_b = [server.submit("roads", q) for q in bfs]
    f_cc = server.submit("roads", api.QuerySpec(algo="cc"))
    server.start()
    for s, f in zip((0, 5), f_s):
        np.testing.assert_array_equal(f.result(WAIT).values,
                                      direct(svc, sssp(s)))
        assert f.result().extra["coalesced"] == 2
    for q, f in zip(bfs, f_b):
        np.testing.assert_array_equal(f.result(WAIT).values, direct(svc, q))
    np.testing.assert_array_equal(f_cc.result(WAIT).values,
                                  direct(svc, api.QuerySpec(algo="cc")))
    server.close()


def test_server_results_equal_reference_server(svc, ref):
    """The same requests through both packages' servers: sssp and bfs
    bit for bit, PageRank within rtol 2e-6."""
    jsvc = ref.api.GraphService()
    jsvc.register("roads", ref.graph.road_network(10, seed=1), b=16,
                  num_clusters=8)
    specs = [("sssp", (s,)) for s in (0, 4, 8)] + \
        [("bfs", (s,)) for s in (1, 2)] + [("pagerank", ())]
    got = {}
    for name, server, qs in (
            ("jax", ref.api.GraphServer(service=jsvc, wave=ref.api.WavePolicy(
                max_wait_s=0.005), autostart=False), ref.api.QuerySpec),
            ("torch", paused(svc), api.QuerySpec)):
        futs = [server.submit("roads", qs(algo=a, sources=s))
                for a, s in specs]
        server.start()
        got[name] = [np.asarray(f.result(WAIT).values) for f in futs]
        server.close()
    for (algo, _), j, t in zip(specs, got["jax"], got["torch"]):
        if algo == "pagerank":
            np.testing.assert_allclose(t, j, rtol=2e-6)
        else:
            np.testing.assert_array_equal(t, j)


# -- fail-fast submit --------------------------------------------------------


def test_submit_unknown_graph_raises_at_submit(svc):
    server = paused(svc)
    with pytest.raises(KeyError, match="no graph registered"):
        server.submit("ghost", sssp(0))
    with pytest.raises(ValueError, match="source"):
        server.submit("roads", api.QuerySpec(algo="sssp"))
    assert server.sched.pending() == 0
    server.close()


def test_submit_after_close_is_refused(svc):
    server = paused(svc)
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit("roads", sssp(0))


def test_server_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.GraphServer()


# -- deadlines and cancellation ----------------------------------------------


def test_expired_request_resolves_deadline_exceeded_not_in_wave(svc):
    server = paused(svc, max_wave=8)
    f_dead = server.submit("roads", sssp(0), deadline=0.0)
    f_live = server.submit("roads", sssp(3), deadline=120.0)
    time.sleep(0.01)
    server.start()
    with pytest.raises(api.DeadlineExceeded):
        f_dead.result(WAIT)
    np.testing.assert_array_equal(f_live.result(WAIT).values,
                                  direct(svc, sssp(3)))
    st = server.stats()["scheduler"]
    assert st["expired"] == 1
    assert st["wave_queries"] == 1       # the dead one never rode
    server.close()


def test_deadline_exceeded_is_a_timeout_error():
    assert issubclass(api.DeadlineExceeded, TimeoutError)
    assert issubclass(api.WaveTimeout, TimeoutError)
    assert rz.is_transient(api.WaveTimeout("reaped"))


def test_cancelled_future_never_occupies_a_wave_row(svc):
    server = paused(svc, max_wave=8)
    futs = [server.submit("roads", sssp(s)) for s in (0, 3, 7)]
    assert futs[1].cancel()                 # still queued → cancellable
    assert server.sched.pending() == 3      # purge happens at wave close
    server.start()
    assert server.sched.drain(timeout=WAIT)
    for f, s in ((futs[0], 0), (futs[2], 7)):
        np.testing.assert_array_equal(f.result(WAIT).values,
                                      direct(svc, sssp(s)))
    assert futs[1].cancelled()
    st = server.stats()["scheduler"]
    assert st["cancelled"] == 1 and st["completed"] == 2
    assert st["wave_queries"] == 2 and st["max_wave"] == 2
    server.close()


def test_cancel_after_dispatch_is_refused(svc):
    with api.GraphServer(service=svc) as server:
        f = server.submit("roads", sssp(0))
        f.result(WAIT)
        assert not f.cancel()
        np.testing.assert_array_equal(f.result().values,
                                      direct(svc, sssp(0)))


# -- admission control -------------------------------------------------------


def test_backpressure_on_full_pending_queue(svc):
    server = paused(svc, max_pending=2)
    f = [server.submit("roads", sssp(s)) for s in (0, 3)]
    with pytest.raises(api.Backpressure) as exc:
        server.submit("roads", sssp(7))
    assert exc.value.stats["scheduler"]["pending"] == 2
    assert server.stats()["server"]["rejected_pending"] == 1
    server.start()
    for s, fut in zip((0, 3), f):
        np.testing.assert_array_equal(fut.result(WAIT).values,
                                      direct(svc, sssp(s)))
    assert server.sched.drain(timeout=WAIT)
    server.submit("roads", sssp(7)).result(WAIT)   # admitted again
    server.close()


def test_backpressure_on_plan_store_thrash(svc):
    server = paused(svc, thrash_evictions=3, thrash_window_s=60.0)
    server.submit("roads", sssp(0))              # takes a sample at 0
    svc.store._stats["evictions"] += 3           # store starts churning
    with pytest.raises(api.Backpressure, match="thrash"):
        server.submit("roads", sssp(3))
    assert server.stats()["server"]["rejected_thrash"] == 1
    server.close()


# -- eviction and shutdown ---------------------------------------------------


def test_evict_resolves_queued_requests(svc):
    svc.register("keep", G.road_network(6, seed=3), b=16, num_clusters=4)
    server = paused(svc)
    f_gone = server.submit("roads", sssp(0))
    f_kept = server.submit("keep", sssp(0))
    server.evict("roads")
    with pytest.raises(KeyError, match="evicted"):
        f_gone.result(WAIT)
    server.start()
    assert f_kept.result(WAIT).stats.converged
    server.close()


def test_close_drains_pending_requests(svc):
    server = paused(svc)                 # scheduler never started
    futs = [server.submit("roads", sssp(s)) for s in (0, 3)]
    server.close()                       # drain=True completes them
    for s, f in zip((0, 3), futs):
        np.testing.assert_array_equal(f.result(0).values,
                                      direct(svc, sssp(s)))


def test_close_without_drain_fails_queue_with_backpressure(svc):
    server = paused(svc)
    fut = server.submit("roads", sssp(0))
    server.close(drain=False)
    with pytest.raises(api.Backpressure):
        fut.result(0)


def test_stop_without_drain_resolves_queue_with_server_closed(svc):
    srv = paused(svc)
    futs = [srv.submit("roads", sssp(s)) for s in (0, 1, 2)]
    srv.close(drain=False)
    for f in futs:
        with pytest.raises(api.ServerClosed) as ei:
            f.result(timeout=10)
        assert isinstance(ei.value, api.Backpressure)   # structured
        assert isinstance(ei.value.stats, dict)
    with pytest.raises(api.ServerClosed, match="closed"):
        srv.submit("roads", sssp(0))


def test_offer_after_stop_resolves_immediately(svc):
    srv = paused(svc)
    srv.close(drain=False)
    fut = Future()
    srv.sched.offer(_Request(ticket=0, name="roads", spec=sssp(0),
                             key=None, future=fut,
                             t_submit=time.monotonic(), t_deadline=None))
    with pytest.raises(api.ServerClosed):
        fut.result(timeout=10)


def test_runtime_failure_isolated_per_future(svc, monkeypatch):
    proc = svc.get("roads")
    real_run = proc.run

    def flaky(spec):
        if spec.algo == "cc":
            raise RuntimeError("engine fell over")
        return real_run(spec)

    monkeypatch.setattr(proc, "run", flaky)
    server = paused(svc)
    f_bad = server.submit("roads", api.QuerySpec(algo="cc"))
    f_ok = server.submit("roads", sssp(0))
    server.start()
    with pytest.raises(RuntimeError, match="fell over"):
        f_bad.result(WAIT)
    assert f_ok.result(WAIT).stats.converged
    assert server.stats()["scheduler"]["failed"] == 1
    server.close()


# -- plan warming ------------------------------------------------------------


def _hot_cache(road, cache, *specs):
    s1 = api.GraphServer(cache_dir=cache, device=CPU)
    s1.register("roads", road, b=16, num_clusters=8)
    for spec in specs:
        s1.run("roads", spec)
    s1.close()                           # flushes the access log


def test_register_warms_hot_plans_from_access_log(road, tmp_path,
                                                  monkeypatch):
    cache = str(tmp_path / "plans")
    _hot_cache(road, cache, sssp(0), api.QuerySpec(algo="pagerank"))
    s2 = api.GraphServer(cache_dir=cache, device=CPU)
    proc2 = s2.register("roads", road, b=16, num_clusters=8)
    assert s2.wait_warm(timeout=WAIT)
    assert s2.stats()["server"]["plans_warmed"] == 2

    def boom(*a, **kw):
        raise AssertionError("compile pipeline ran after warming")

    monkeypatch.setattr(eng, "prepare", boom)
    r = s2.run("roads", sssp(0))
    assert proc2._prepare_calls == 0
    np.testing.assert_allclose(r.values, O.sssp_oracle(road, 0),
                               rtol=1e-5, atol=1e-4)
    s2.close()


@pytest.mark.parametrize("how", ["foreign-tiling", "opt-out"])
def test_warming_skips_foreign_keys_and_honours_opt_out(road, tmp_path,
                                                        how):
    cache = str(tmp_path / "plans")
    _hot_cache(road, cache, sssp(0))
    s2 = api.GraphServer(cache_dir=cache, device=CPU)
    if how == "foreign-tiling":
        s2.register("roads", road, b=8, num_clusters=4)
    else:
        s2.register("roads", road, b=16, num_clusters=8, warm=False)
    assert s2.wait_warm(timeout=WAIT)
    assert s2.stats()["server"]["plans_warmed"] == 0
    s2.close()


def test_hot_keys_orders_by_access_count(road, tmp_path):
    store = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    proc = api.GraphProcessor(road, b=16, num_clusters=8, store=store,
                              device=CPU)
    proc.prepare("min_plus")
    for _ in range(3):
        proc.prepare("plus_times", normalize="out_stochastic")
    hot = store.hot_keys(road.fingerprint())
    assert [k.semiring for k in hot] == ["plus_times", "min_plus"]
    assert store.hot_keys(road.fingerprint(), limit=1) == hot[:1]
    store.flush_access_log()
    again = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    assert again.hot_keys(road.fingerprint()) == hot


def test_corrupt_access_log_only_costs_warming(road, tmp_path):
    store = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    proc = api.GraphProcessor(road, b=16, num_clusters=8, store=store,
                              device=CPU)
    proc.prepare("min_plus")
    store.flush_access_log()
    (tmp_path / sg.ACCESS_LOG).write_text("{not json")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        fresh = api.PlanStore(cache_dir=str(tmp_path), device=CPU)
    assert fresh.hot_keys(road.fingerprint()) == []   # no raise
    assert fresh.get(road.fingerprint(),
                     proc.plan_key("min_plus")) is not None


# -- asyncio adapter and policy knobs ----------------------------------------


def test_asyncio_adapter_serves_coroutines(svc):
    server = paused(svc, max_wave=4)

    async def client():
        aws = [server.submit_async("roads", sssp(s)) for s in (0, 3, 7)]
        server.start()
        return await asyncio.wait_for(asyncio.gather(*aws), WAIT)

    results = asyncio.run(client())
    for s, r in zip((0, 3, 7), results):
        np.testing.assert_array_equal(r.values, direct(svc, sssp(s)))
    assert server.stats()["scheduler"]["max_wave"] == 3
    server.close()


@pytest.mark.parametrize("kw,match", [
    (dict(max_wave=0), "max_wave"), (dict(max_wait_s=-1.0), "max_wait_s"),
    (dict(workers=0), "workers"), (dict(max_retries=-1), "max_retries"),
    (dict(backoff_jitter=-0.1), "backoff"), (dict(watchdog_s=0.0),
                                             "watchdog_s"),
], ids=["max_wave", "max_wait_s", "workers", "max_retries", "backoff",
        "watchdog"])
def test_wave_policy_validates_knobs(kw, match):
    with pytest.raises(ValueError, match=match):
        api.WavePolicy(**kw)
    assert api.WavePolicy().but(max_wave=7).max_wave == 7


# -- degradation ladder, seen by the service ---------------------------------


def test_degrade_policy_ladder_shape():
    pallas = api.ExecutionPolicy(kernel=api.KernelSpec(impl="pallas"))
    assert api.degrade_policy(pallas).kernel.impl == "ref"
    dist = api.ExecutionPolicy(mode="distributed", dist_flavor="async")
    assert api.degrade_policy(dist).mode == "sync"
    assert api.degrade_policy(api.ExecutionPolicy()) is None


def test_kernel_fault_degrades_to_ref_bit_identical(svc):
    base = direct(svc, sssp(0))
    pallas = api.ExecutionPolicy(kernel=api.KernelSpec(impl="pallas"))
    plan = fplan(rz.FaultSpec("kernel.select", where={"impl": "pallas"}))
    with rz.inject(plan):
        r = svc.run("roads", api.QuerySpec(algo="sssp", sources=(0,),
                                           policy=pallas))
    np.testing.assert_array_equal(r.values, base)
    steps = r.extra["degraded"]
    assert len(steps) == 1 and "FaultInjected" in steps[0]["error"]
    assert "/pallas" in steps[0]["from"] and "/ref" in steps[0]["to"]
    assert svc.stats()["degraded_runs"] == 1


def test_degraded_wave_surfaces_per_ticket(svc):
    """A coalesced wave that degraded records it on every ticket and
    once in the service's count."""
    pallas = api.ExecutionPolicy(kernel=api.KernelSpec(impl="pallas"),
                                 max_sweeps=100_000)
    tickets = [svc.submit("roads", api.QuerySpec(
        algo="sssp", sources=(s,), policy=pallas)) for s in (0, 3)]
    with rz.inject(fplan(rz.FaultSpec("kernel.select", count=1,
                                      where={"impl": "pallas"}))):
        out = svc.gather()
    for t, s in zip(tickets, (0, 3)):
        assert out[t].extra["degraded"][0]["to"] == "async/ref"
        np.testing.assert_array_equal(out[t].values, direct(svc, sssp(s)))
    assert svc.stats()["degraded_runs"] == 1


def test_distributed_fault_falls_back_to_single_device_sync(svc, road):
    """A failed exchange round (``dist.dispatch``) walks the ladder to
    single-device sync, bit for bit: in the session, and for a wave the
    server closed, on every ticket."""
    base = direct(svc, sssp(0))
    proc = api.GraphProcessor(road, b=16, device=CPU)
    dist = api.ExecutionPolicy(mode="distributed", max_sweeps=100_000)
    with rz.inject(fplan(rz.FaultSpec("dist.dispatch"))):
        r = proc.run(api.QuerySpec(algo="sssp", sources=(0,),
                                   policy=dist))
    np.testing.assert_array_equal(r.values, proc.sssp(0).values)
    assert [s["from"].split("/")[0] for s in r.extra["degraded"]] \
        == ["distributed"]
    with paused(svc) as srv:
        futs = [srv.submit("roads", api.QuerySpec(
            algo="sssp", sources=(s,), policy=dist)) for s in (0, 3)]
        with rz.inject(fplan(rz.FaultSpec("dist.dispatch", count=1))):
            srv.start()
            got = [f.result(timeout=WAIT) for f in futs]
    np.testing.assert_array_equal(got[0].values, base)
    np.testing.assert_array_equal(got[1].values, direct(svc, sssp(3)))
    for res in got:
        assert res.extra["degraded"][0]["from"] == "distributed/ref/sync"
        assert res.extra["degraded"][0]["to"] == "sync/ref"
    assert svc.stats()["degraded_runs"] == 1


def test_degrade_false_propagates_the_fault(svc):
    hard = api.ExecutionPolicy(kernel=api.KernelSpec(impl="pallas"),
                               degrade=False)
    with rz.inject(fplan(rz.FaultSpec("kernel.select"))):
        with pytest.raises(rz.FaultInjected):
            svc.run("roads", api.QuerySpec(algo="sssp", sources=(0,),
                                           policy=hard))


def test_misuse_errors_never_degrade(svc, road):
    with pytest.raises(IndexError):
        svc.run("roads", api.QuerySpec(algo="sssp", sources=(road.n + 7,)))
    with pytest.raises(ValueError):
        svc.run("roads", api.QuerySpec(algo="nope", sources=(0,)))


# -- scheduler self-healing: retries, watchdog -------------------------------


def server(road, **wave_kw):
    wave = api.WavePolicy(**{"max_wait_s": 0.002, "backoff_base_s": 0.01,
                             **wave_kw})
    srv = api.GraphServer(wave=wave, device=CPU)
    srv.register("g", road, b=16, num_clusters=8, warm=False)
    return srv


def test_transient_wave_failure_retried_to_success(road):
    with server(road) as srv:
        base = srv.run("g", sssp(0))
        with rz.inject(fplan(rz.FaultSpec("sched.dispatch", count=1))):
            r = srv.submit("g", sssp(0)).result(WAIT)
        np.testing.assert_array_equal(r.values, base.values)
        st = srv.stats()["scheduler"]
        assert st["retries"] == 1 and st["failed"] == 0
        assert st["retry_exhausted"] == 0


def test_retry_budget_exhaustion_is_a_structured_failure(road):
    with server(road) as srv:
        with rz.inject(fplan(rz.FaultSpec("sched.dispatch"))):
            fut = srv.submit("g", sssp(0))
            with pytest.raises(rz.FaultInjected):
                fut.result(timeout=WAIT)
        st = srv.stats()["scheduler"]
        assert st["retry_exhausted"] == 1 and st["failed"] == 1
        assert st["retries"] == api.WavePolicy().max_retries


def test_deterministic_failures_are_never_retried(road):
    with server(road) as srv:
        real = srv.service.run
        calls = []

        def boom(name, spec):
            calls.append(name)
            raise RuntimeError("deterministic bug")

        srv.service.run = boom
        try:
            fut = srv.submit("g", api.QuerySpec(algo="pagerank"))
            with pytest.raises(RuntimeError, match="deterministic"):
                fut.result(timeout=WAIT)
        finally:
            srv.service.run = real
        assert len(calls) == 1
        assert srv.stats()["scheduler"]["retries"] == 0


def test_backoff_draws_the_reference_jitter(road, ref):
    """Retries wait ``min(cap, base·2ⁿ⁻¹)·(1 + jitter·U)`` with U from
    the same seeded generator as the JAX package's scheduler."""
    from repro_torch.serve.sched import WaveScheduler
    a = WaveScheduler(api.GraphService(device=CPU), api.WavePolicy())
    b = ref.sched.WaveScheduler(ref.api.GraphService(),
                                ref.api.WavePolicy())
    assert [a._rng.random() for _ in range(8)] == \
        [b._rng.random() for _ in range(8)]


@pytest.mark.parametrize("retries", [1, 0], ids=["retried", "exhausted"])
def test_watchdog_reaps_hung_wave(road, retries):
    """A dispatch hung past the watchdog is reaped: with retry budget
    the request runs again and matches; without, it fails with a
    ``WaveTimeout``."""
    with server(road, watchdog_s=1.0, max_retries=retries) as srv:
        base = srv.service.run("g", sssp(0))   # not under the watchdog
        plan = fplan(rz.FaultSpec("sched.dispatch", mode="delay",
                                  delay_s=2.0, count=1))
        with rz.inject(plan):
            fut = srv.submit("g", sssp(0))
            if retries:
                np.testing.assert_array_equal(fut.result(WAIT).values,
                                              base.values)
            else:
                with pytest.raises(api.WaveTimeout):
                    fut.result(timeout=WAIT)
        st = srv.stats()["scheduler"]
        assert st["watchdog_timeouts"] == 1 and st["retries"] == retries


# -- stress and the acceptance story -----------------------------------------


def test_concurrent_register_evict_submit_no_orphans(road):
    small = G.road_network(6, seed=2)
    with server(road, max_wait_s=0.001) as srv:
        stop_evt = threading.Event()
        futs, errs = [], []
        lock = threading.Lock()

        def churn():
            while not stop_evt.is_set():
                try:
                    srv.register("churn", small, b=8, warm=False)
                    time.sleep(0.002)
                    srv.evict("churn")
                except Exception as e:  # pragma: no cover
                    errs.append(e)

        def submitter(i):
            for k in range(20):
                name = "churn" if (i + k) % 3 == 0 else "g"
                try:
                    f = srv.submit(name, sssp(k % road.n
                                              if name == "g" else 0))
                except (KeyError, api.Backpressure):
                    continue
                with lock:
                    futs.append(f)

        threads = [threading.Thread(target=churn)] + \
            [threading.Thread(target=submitter, args=(i,))
             for i in range(4)]
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(timeout=WAIT)
        stop_evt.set()
        threads[0].join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        base = srv.run("g", sssp(0)).values
        for f in futs:
            try:
                r = f.result(timeout=WAIT)
            except (KeyError, api.Backpressure, api.DeadlineExceeded):
                continue
            if r.extra.get("src") == 0 and r.graph is road:
                np.testing.assert_array_equal(r.values, base)


def test_multi_site_faults_every_request_resolves(road, tmp_path):
    srv = api.GraphServer(cache_dir=str(tmp_path), device=CPU,
                          wave=api.WavePolicy(max_wait_s=0.002,
                                              backoff_base_s=0.01,
                                              watchdog_s=1.0))
    srv.register("g", road, b=16, num_clusters=8, warm=False)
    base = {s: srv.run("g", sssp(s)).values for s in range(4)}
    plan = fplan(
        rz.FaultSpec("planstore.disk_read", mode="corrupt", p=0.5),
        rz.FaultSpec("planstore.disk_write", exc="oserror", p=0.5),
        rz.FaultSpec("kernel.select", count=1, where={"impl": "pallas"}),
        rz.FaultSpec("sched.dispatch", p=0.3, count=3),
        rz.FaultSpec("sched.dispatch", mode="delay", delay_s=2.0, count=1,
                     after=1),
    )
    pallas = api.ExecutionPolicy(kernel=api.KernelSpec(impl="pallas"))
    with rz.inject(plan):
        futs = {}
        for rep in range(3):
            for s in range(4):
                spec = api.QuerySpec(algo="sssp", sources=(s,),
                                     policy=pallas if s == 0 else None)
                futs[(rep, s)] = srv.submit("g", spec)
        outcomes = {"ok": 0, "err": 0}
        for (rep, s), f in futs.items():
            try:
                r = f.result(timeout=WAIT)
            except (rz.FaultInjected, api.WaveTimeout, OSError,
                    api.Backpressure):
                outcomes["err"] += 1
                continue
            outcomes["ok"] += 1
            np.testing.assert_array_equal(r.values, base[s])
    srv.close()
    assert plan.stats().get("sched.dispatch", {}).get("injected", 0) >= 1
    assert outcomes["ok"] >= 1
    sched = srv.stats()["scheduler"]
    assert sched["completed"] + sched["failed"] >= len(futs)
    assert sched["retries"] >= 1


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


def _ca(scale):
    return G.make_paper_graph("ca", scale=scale, seed=0)


FUSED = api.KernelSpec(impl="pallas", fuse_frontier=True)


class _HeldCapture:
    """Patch ``engine._CapturedSweep`` so that the first capture stays
    open (inside ``torch.cuda.graph``) until ``release`` is set: what the
    other threads do meanwhile overlaps the capture for certain."""

    def __init__(self, monkeypatch):
        self.capturing = threading.Event()
        self.release = threading.Event()
        real = eng._CapturedSweep
        held = self

        class Held(real):
            def __init__(self, sweep, device):
                def hold():
                    flags = sweep()
                    if not held.capturing.is_set():
                        held.capturing.set()
                        held.release.wait(timeout=WAIT)
                    return flags
                super().__init__(hold, device)
        monkeypatch.setattr(eng, "_CapturedSweep", Held)


@pytest.mark.cuda
def test_cuda_capture_against_upload_and_sync_query(cuda, tmp_path,
                                                    monkeypatch):
    g, small = _ca(0.002), _ca(0.001)
    cache = str(tmp_path)
    warm_src = api.GraphServer(cache_dir=cache, device=cuda)
    warm_src.register("small", small, b=16, num_clusters=8)
    small_want = warm_src.run("small", sssp(3)).values
    warm_src.close()                      # the access log names min_plus
    srv = api.GraphServer(wave=api.WavePolicy(max_wait_s=0.005),
                          device=cuda, autostart=False)
    srv.register("ca", g, b=16, num_clusters=8)
    sync = api.ExecutionPolicy(mode="sync", kernel=FUSED)
    srcs = list(range(0, 640, 40))
    serial = srv.service.run("ca", api.QuerySpec(
        algo="sssp", sources=tuple(srcs), batched=True)).values
    sync_want = srv.service.run("ca", api.QuerySpec(
        algo="sssp", sources=(5,), policy=sync)).values
    loader = api.GraphServer(cache_dir=cache, device=cuda)
    hold = _HeldCapture(monkeypatch)
    futs = [srv.submit("ca", sssp(s)) for s in srcs]   # one wave
    out, errors = {}, []

    def upload():        # a plan read from disk and put on the card
        hold.capturing.wait(timeout=WAIT)
        try:
            loader.register("small", small, b=16, num_clusters=8,
                            warm=True)
            out["warm"] = loader.wait_warm(timeout=WAIT)
        except Exception as e:
            errors.append(e)

    def sync_query():    # no capture: runs while the wave's is open
        hold.capturing.wait(timeout=WAIT)
        try:
            out["sync"] = srv.service.run("ca", api.QuerySpec(
                algo="sssp", sources=(5,), policy=sync)).values
        except Exception as e:
            errors.append(e)

    others = [threading.Thread(target=upload),
              threading.Thread(target=sync_query)]
    for t in others:
        t.start()
    srv.start()          # the wave's dispatcher captures, held open
    for t in others:
        t.join(timeout=WAIT)
    hold.release.set()
    res = [f.result(WAIT) for f in futs]
    assert not any(t.is_alive() for t in others)
    assert not errors, errors
    assert hold.capturing.is_set() and out["warm"]
    assert loader.stats()["server"]["plans_warmed"] == 1
    assert loader.service.store.stats()["disk_hits"] == 1
    assert res[0].extra["coalesced"] == len(srcs)
    assert res[0].stats.capture_s > 0.0
    for r, want in zip(res, serial):
        np.testing.assert_array_equal(r.values, want)
    np.testing.assert_array_equal(out["sync"], sync_want)
    np.testing.assert_array_equal(loader.run("small", sssp(3)).values,
                                  small_want)
    srv.close()
    loader.close()


@pytest.mark.cuda
def test_cuda_two_workers_serve_two_plans_at_once(cuda):
    g = _ca(0.002)
    svc = api.GraphService(device=cuda)
    svc.register("ca", g, b=16, num_clusters=8)
    asyn = api.ExecutionPolicy(mode="async", kernel=FUSED,
                               max_sweeps=100_000)
    specs = [api.QuerySpec(algo=a, sources=(s,), policy=asyn)
             for a in ("sssp", "bfs") for s in range(0, 320, 40)]
    want = [svc.run("ca", q).values for q in specs]
    tk.reset_launch_counts()
    srv = api.GraphServer(service=svc, wave=api.WavePolicy(
        workers=2, max_wait_s=0.005), autostart=False)
    futs = [srv.submit("ca", q) for q in specs]
    srv.start()
    res = [f.result(WAIT) for f in futs]
    assert srv.sched.drain(timeout=WAIT)
    torch.cuda.synchronize()
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r.values, w)
    waves = {r.extra["algo"]: r for r in res}
    assert all(r.extra["coalesced"] == len(specs) // 2
               for r in waves.values())
    assert tk.launch_counts["bsr_spmv_fused_compact"] == \
        sum(r.stats.sweeps * r.prepared.s for r in waves.values())
    assert srv.stats()["scheduler"]["waves"] == 2
    srv.close()


@pytest.mark.cuda
def test_cuda_global_capture_mode_breaks_under_upload(cuda):
    """Why the engine captures in thread-local mode: a host-to-device
    upload from another thread while a global-mode capture is open fails
    in that thread or invalidates the capture."""
    x = torch.zeros(1 << 20, device=cuda)
    graph = torch.cuda.CUDAGraph()
    capturing, uploaded = threading.Event(), threading.Event()
    upload_error = []

    def upload():
        capturing.wait(timeout=WAIT)
        try:
            torch.from_numpy(np.ones(1 << 22, np.float32)).to(cuda)
            torch.cuda.synchronize()
        except RuntimeError as e:
            upload_error.append(e)
        finally:
            uploaded.set()
    t = threading.Thread(target=upload)
    t.start()
    capture_error = None
    try:
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(cuda)):
            x.add_(1.0)
            capturing.set()
            uploaded.wait(timeout=WAIT)
    except RuntimeError as e:
        capture_error = e
    t.join(timeout=WAIT)
    assert not t.is_alive()
    assert upload_error or capture_error is not None
