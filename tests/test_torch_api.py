"""The port's session API vs the JAX package's, and vs the numpy oracles.

``GraphProcessor.run`` for every relaxation algorithm × {sync, async} ×
{ref, fused}, single and batched, on the CPU (``device="cpu"``).  Exact
algorithms must equal the JAX package's values bit for bit; PageRank
stays within atol=1e-6 of it.  Oracle tolerances are those of
tests/test_algorithms.py.  Also: policy/spec validation equal to the JAX
package's, the autotuner's and the distributed specs once refused now
running, the device rule, and that the package imports neither jax nor
the JAX package.
"""

import pathlib
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import oracles as O  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import resilience as trz  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import semiring as ts  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAPHS = {
    "road": lambda G: G.road_network(8, seed=1),
    "rmat": lambda G: G.rmat(96, 520, seed=5),
}
ALGOS = ["sssp", "bfs", "pagerank", "pagerank_delta", "cc", "kcore2",
         "kcore3", "reachability"]
SOURCED = ("sssp", "bfs", "reachability")
SOURCES = (0, 7, 21)

_PROCS = {}
_JAX_RESULTS = {}


def _procs(gname):
    if gname not in _PROCS:
        _PROCS[gname] = (
            japi.GraphProcessor(GRAPHS[gname](jg), b=16, num_clusters=8),
            tapi.GraphProcessor(GRAPHS[gname](tg), b=16, num_clusters=8,
                                device="cpu"))
    return _PROCS[gname]


def _spec(api, algo, mode, batched, fused=False):
    kernel = api.KernelSpec(impl="pallas", fuse_frontier=True) \
        if fused else None
    a = api.get_algorithm("kcore" if algo.startswith("kcore") else algo)
    pol = api.ExecutionPolicy(kernel=kernel).but(
        **{**dict(a.default_policy), "mode": mode})
    if algo.startswith("kcore"):
        return api.QuerySpec(algo="kcore", policy=pol,
                             params={"k": float(algo[-1])})
    srcs = SOURCES if batched else (SOURCES[0],) if algo in SOURCED else ()
    return api.QuerySpec(algo=algo, sources=srcs, batched=batched,
                         policy=pol)


def _jax_result(gname, algo, mode, batched):
    key = (gname, algo, mode, batched)
    if key not in _JAX_RESULTS:
        jp, _ = _procs(gname)
        _JAX_RESULTS[key] = jp.run(_spec(japi, algo, mode, batched))
    return _JAX_RESULTS[key]


def _check_oracle(g, algo, values, src):
    if algo == "sssp":
        np.testing.assert_allclose(values, O.sssp_oracle(g, src),
                                   rtol=1e-5, atol=1e-4)
    elif algo == "bfs":
        np.testing.assert_array_equal(values, O.bfs_oracle(g, src))
    elif algo == "reachability":
        np.testing.assert_array_equal(values > 0,
                                      np.isfinite(O.bfs_oracle(g, src)))
    elif algo.startswith("pagerank"):
        pr = O.pagerank_oracle(g, tol=1e-12)
        assert np.max(np.abs(values - pr)) < 1e-5
        assert abs(values.sum() - 1.0) < 1e-5
    elif algo == "cc":
        oracle = O.cc_oracle(g)
        # same partition: one label per oracle component and vice versa
        pairs = set(zip(values.tolist(), oracle.tolist()))
        assert len(pairs) == len(set(oracle.tolist())) == \
            len(set(values.tolist()))
    else:
        np.testing.assert_array_equal(values,
                                      O.kcore_oracle(g, int(algo[-1])))


CASES = [(g, a, m, f, b)
         for g in GRAPHS for a in ALGOS for m in ("sync", "async")
         for f in (False, True) for b in (False, True)
         if not (b and a not in SOURCED)
         and not (a == "pagerank" and m == "async")]


@pytest.mark.parametrize(
    "gname,algo,mode,fused,batched", CASES,
    ids=[f"{g}-{a}-{m}-{'fused' if f else 'ref'}-{'batch' if b else 'one'}"
         for g, a, m, f, b in CASES])
def test_run_matches_reference_and_oracle(gname, algo, mode, fused,
                                          batched):
    jp, tp = _procs(gname)
    rt = tp.run(_spec(tapi, algo, mode, batched, fused))
    rj = _jax_result(gname, algo, mode, batched)
    assert "degraded" not in rt.extra
    vals = rt.values if batched else rt.values[None]
    srcs = SOURCES if batched else (SOURCES[0],)
    for q, src in enumerate(srcs):
        _check_oracle(tp.g, algo, vals[q], src)
    if algo.startswith("pagerank"):
        np.testing.assert_allclose(rt.values, rj.values, atol=1e-6, rtol=0)
        # The sweep that first moves every rank by less than tol (1e-8 here,
        # a few ulps of a rank) depends on how y's sums are grouped: XLA's
        # dot and the kernel's per-lane order round differently, and the
        # counts drift apart by up to two sweeps (rmat pagerank sync: 41 vs
        # 40 even at tol=1e-6).  Exact rules below must match exactly.
        assert abs(rt.stats.sweeps - rj.stats.sweeps) <= 2
        assert rt.stats.converged == rj.stats.converged
    else:
        np.testing.assert_array_equal(rt.values, np.asarray(rj.values))
        assert rt.stats.sweeps == rj.stats.sweeps
    if not fused and not algo.startswith("pagerank"):
        # exact ref flavors: every work counter equals the reference's
        for f in ("tile_work", "edge_work", "crit_tiles",
                  "active_group_sweeps", "halo_tiles", "total_groups",
                  "converged", "mode"):
            assert getattr(rt.stats, f) == getattr(rj.stats, f), f


def test_pagerank_async_and_free_functions():
    """Classic PageRank runs on the async engine too (first touch); the
    free functions build a one-query session on the named device."""
    from repro_torch.core import algorithms as TA
    g = GRAPHS["road"](tg)
    r = TA.pagerank(g, tol=1e-9, mode="async", b=16, num_clusters=8,
                    device="cpu")
    _check_oracle(g, "pagerank", r.values, None)
    r = TA.sssp(g, 0, mode="sync", b=16, num_clusters=8, device="cpu")
    _check_oracle(g, "sssp", r.values, 0)
    r = TA.kcore(g, 2, b=16, num_clusters=8, device="cpu")
    _check_oracle(g, "kcore2", r.values, None)


def test_plan_cache_shares_plans():
    proc = tapi.GraphProcessor(GRAPHS["road"](tg), b=16, num_clusters=8,
                               device="cpu")
    proc.sssp(0)
    proc.sssp(3)
    proc.sssp([1, 2])
    assert proc.cache_info()["prepare_calls"] == 1
    proc.bfs(0)  # the unit-weight variant is a second plan
    info = proc.cache_info()
    assert (info["plans"], info["prepare_calls"]) == (2, 2)


def test_custom_semiring_end_to_end():
    """A registered max-times ring runs through the plain path on any
    device (the kernels know only the built-in rings)."""
    name = "torch_test_max_times"
    if name not in ts.SEMIRINGS:
        ts.register(ts.Semiring(
            name=name, add=torch.maximum, mul=torch.multiply, zero=0.0,
            one=1.0, improves=lambda new, old: new > old,
            reduce_fn=lambda x, axis=None: torch.amax(x, dim=axis)))
    algo = "torch_test_reliability"
    if algo not in tapi.registered_algorithms():
        tapi.register_algorithm(tapi.AlgorithmSpec(
            name=algo, semiring=name, source_required=True,
            init=lambda p, src, pol: np.where(
                np.arange(p.n) == src, 1.0, 0.0).astype(np.float32)))
    g = tg.rmat(80, 400, seed=11)
    g = tg.Graph(n=g.n, indptr=g.indptr, indices=g.indices,
                 weights=(1.0 / (1.0 + g.weights)).astype(np.float32))
    x = np.zeros(g.n)
    x[0] = 1.0
    srcs = np.repeat(np.arange(g.n), np.diff(g.indptr))
    for _ in range(g.n):
        x_new = x.copy()
        np.maximum.at(x_new, g.indices, x[srcs] * g.weights)
        if np.array_equal(x_new, x):
            break
        x = x_new
    proc = tapi.GraphProcessor(g, b=16, num_clusters=8, device="cpu")
    fused = tapi.KernelSpec(impl="pallas", fuse_frontier=True)
    for mode in ("sync", "async"):
        for kernel in (None, fused):
            r = proc.run(tapi.QuerySpec(algo=algo, sources=(0,),
                         policy=tapi.ExecutionPolicy(mode=mode,
                                                     kernel=kernel)))
            np.testing.assert_allclose(r.values, x.astype(np.float32),
                                       rtol=1e-5, atol=1e-6)


# -- validation equal to the JAX package's --------------------------------

BAD_POLICIES = [
    dict(mode="warp"),
    dict(impl="ref", kernel={"impl": "pallas"}),
    dict(mode="distributed", impl="pallas"),
    dict(query_axis=-1),
    dict(dist_flavor="eventually"),
    dict(local_sweeps=0),
    dict(dist_flavor="async"),
    dict(mode="distributed", local_sweeps=2),
    dict(mode="distributed", dist_flavor="async", query_axis=0),
]
BAD_KERNELS = [
    dict(impl="mosaic"), dict(block_size=0), dict(rows_per_step=1.5),
    dict(impl="ref", block_size=8), dict(impl="ref", fuse_frontier=True),
    dict(impl="ref", autotune=True),
    dict(impl="pallas", fuse_frontier=True, rows_per_step=2),
    dict(impl="pallas", autotune=True, block_size=8, rows_per_step=1),
]


def _error(api, make):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            make(api)
    except Exception as e:  # the type and message are what is compared
        return type(e).__name__, str(e)
    return None


def _kernelize(api, kw):
    kw = dict(kw)
    if isinstance(kw.get("kernel"), dict):
        kw["kernel"] = api.KernelSpec(**kw["kernel"])
    return kw


@pytest.mark.parametrize("kw", BAD_POLICIES, ids=str)
def test_policy_rejections_equal_reference(kw):
    want = _error(japi, lambda a: a.ExecutionPolicy(**_kernelize(a, kw)))
    assert want is not None
    assert _error(tapi,
                  lambda a: a.ExecutionPolicy(**_kernelize(a, kw))) == want


@pytest.mark.parametrize("kw", BAD_KERNELS, ids=str)
def test_kernelspec_rejections_equal_reference(kw):
    want = _error(japi, lambda a: a.KernelSpec(**kw))
    assert want is not None
    assert _error(tapi, lambda a: a.KernelSpec(**kw)) == want


def test_policy_but_and_hash_equal_reference():
    for api in (japi, tapi):
        pol = api.ExecutionPolicy(mode="sync")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            legacy = api.ExecutionPolicy(mode="sync", impl="pallas")
        fused = pol.but(kernel=api.KernelSpec(impl="pallas"))
        assert legacy == fused and hash(legacy) == hash(fused)
        assert fused.but(impl="ref").kernel == api.KernelSpec()
        assert api.QuerySpec(algo="sssp", sources=(1,),
                             params={"tol": 1e-3}) == \
            api.QuerySpec(algo="sssp", sources=(1,),
                          params=(("tol", 1e-3),))
    with pytest.raises(ValueError, match="unknown algorithm"):
        tapi.QuerySpec(algo="warp")


# -- the autotuner, once refused, now runs -----------------------------------


@pytest.mark.parametrize("make", [
    lambda api, kernel: api.QuerySpec(algo="sssp", sources=(0,),
                                      policy=api.ExecutionPolicy(
                                          mode="async", kernel=kernel)),
], ids=["autotune"])
def test_autotune_spec_runs(make):
    """``KernelSpec(autotune=True)`` runs, measures one tuning, and gives
    the JAX package's values (its ``impl="ref"`` run: its Pallas kernel
    does not run on this tree's JAX)."""
    jp, tp = _procs("road")
    plan = trz.FaultPlan([])
    with trz.inject(plan):
        res = tp.run(make(tapi, tapi.KernelSpec(impl="pallas",
                                                autotune=True)))
    assert plan.stats()["engine.run"]["hits"] == 1
    assert "degraded" not in res.extra
    want = jp.run(make(japi, japi.KernelSpec(impl="ref")))
    np.testing.assert_array_equal(res.values, np.asarray(want.values))
    assert res.stats.sweeps == want.stats.sweeps
    assert tp.cache_info()["tunings"] == 1
    assert set(res.platform_models()) == {"nale", "cpu"}


@pytest.mark.parametrize("make", [
    lambda api: api.QuerySpec(algo="sssp", sources=(0,),
                              policy=api.ExecutionPolicy(mode="distributed")),
    lambda api: api.QuerySpec(algo="sssp", sources=(0,),
                              params={"mode": "distributed"}),
], ids=["distributed", "distributed-param"])
def test_distributed_spec_runs(make):
    """The specs the port refused before its distributed engines now run,
    on the session's default mesh, and equal the JAX package's sync
    result bit for bit."""
    jp, tp = _procs("road")
    res = tp.run(make(tapi))
    want = jp.run(japi.QuerySpec(algo="sssp", sources=(0,),
                                 policy=japi.ExecutionPolicy(mode="sync")))
    np.testing.assert_array_equal(res.values, np.asarray(want.values))
    assert res.stats.mode == "distributed"
    assert res.extra["dist"].converged
    assert res.stats.sweeps == want.stats.sweeps
    assert res.platform_models()["nale"]


def test_degradation_ladder_on_kernel_fault():
    _, tp = _procs("road")
    fused = tapi.ExecutionPolicy(mode="sync", kernel=tapi.KernelSpec(
        impl="pallas", fuse_frontier=True))
    plan = trz.FaultPlan([trz.FaultSpec("kernel.select", count=1,
                                        where={"impl": "pallas"})])
    with trz.inject(plan):
        r = tp.sssp(0, policy=fused)
    assert r.extra["degraded"][0]["to"] == "sync/ref"
    _check_oracle(tp.g, "sssp", r.values, 0)
    plan = trz.FaultPlan([trz.FaultSpec("kernel.select", count=1)])
    with trz.inject(plan), pytest.raises(trz.FaultInjected):
        tp.sssp(0, policy=fused.but(degrade=False))


def test_session_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.GraphProcessor(tg.ring(16))


# -- imports: no jax, no JAX package ---------------------------------------

_BAD_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


def test_sources_import_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "flash_turns.py"]
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files
                 for m in _BAD_IMPORT.finditer(f.read_text())]
    assert len(files) > 10 and not offenders, offenders


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.api, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.models.lm, "
            "repro_torch.serve.engine, repro_torch.launch.serve\n"
            "from repro_torch.configs import get_config\n"
            "get_config('granite-3-2b')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('ok')")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
