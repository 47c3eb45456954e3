"""The port's engines vs the JAX package's (``impl="ref"``), on the CPU.

Every runner (sync, async, and their batched forms) × every update rule
runs on the same plan and the same initial state in both packages.
Exact rules (relax, kcore) must give bit-identical values and every
``RunStats`` field; the accumulation rules (pagerank, pagerank_delta,
identity) stay within atol=1e-6 of the reference with equal sweep
counts, as the JAX package's own fused-vs-ref test allows
(tests/test_kernelspec.py::test_engine_fused_pagerank).  The fused
flavors are held against the reference's unfused values and sweeps, and
their counters against the ``kernel_fused`` family of BENCH_graph.json.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

FUSED = tapi.KernelSpec(impl="pallas", fuse_frontier=True)
RUNNERS = {
    "sync": (je.run_sync, te.run_sync),
    "async": (je.run_async, te.run_async),
    "sync_batched": (je.run_sync_batched, te.run_sync_batched),
    "async_batched": (je.run_async_batched, te.run_async_batched),
}
# rule -> (semiring, graph transform, prepare kwargs, damping, max_sweeps)
RULES = {
    "relax": ("min_plus", "base", {}, 0.85, 10_000),
    "pagerank": ("plus_times", "base", {"normalize": "out_stochastic"},
                 0.85, 500),
    "pagerank_delta": ("plus_times", "base",
                       {"normalize": "out_stochastic"}, 0.85, 500),
    "kcore": ("plus_times", "unit_undirected", {}, 2.0, 10_000),
    "identity": ("plus_times", "base", {"normalize": "out_stochastic"},
                 0.85, 7),
}
SOURCES = (0, 9, 33)


def _variant(G, name):
    g = G.road_network(8, seed=1)
    if name == "unit_undirected":
        u = g.to_undirected()
        g = G.Graph(n=u.n, indptr=u.indptr, indices=u.indices,
                    weights=np.ones(u.nnz, np.float32))
    return g


_PLANS = {}


def _plans(rule):
    """(JAX plan, port plan) for a rule, built once per module."""
    if rule not in _PLANS:
        semiring, variant, kw, _, _ = RULES[rule]
        pj = je.prepare(_variant(jg, variant), semiring, b=16,
                        num_clusters=8, **kw)
        pt = te.prepare(_variant(tg, variant), semiring, b=16,
                        num_clusters=8, device="cpu", **kw)
        _PLANS[rule] = (pj, pt)
    return _PLANS[rule]


def _x0(p, rule, src):
    """Initial state in block layout, as the session would build it."""
    n = p.n
    if rule == "relax":
        x = np.full(n, np.inf, np.float32)
        x[src] = 0.0
        pad = np.inf
    elif rule == "pagerank_delta":
        x, pad = np.full(n, np.float32(0.15) / n, np.float32), 0.0
    elif rule == "kcore":
        x, pad = np.ones(n, np.float32), 0.0
    else:
        x, pad = np.full(n, 1.0 / n, np.float32), 0.0
    out = np.full(p.r_pad * p.b, pad, np.float32)
    out[p.perm] = x
    return out.reshape(p.r_pad, p.b)


def _frontier(p, src):
    ch = np.zeros(p.r_pad, bool)
    ch[int(p.perm[src]) // p.b] = True
    return ch


def _stats(s):
    d = dataclasses.asdict(s)
    d.pop("host_syncs", None)
    d.pop("capture_s", None)
    return d


def _compare(rule, xj, sj, xt, st):
    exact = rule in ("relax", "kcore")
    if exact:
        np.testing.assert_array_equal(xt, xj)
        assert _stats(st) == _stats(sj)
    else:
        np.testing.assert_allclose(xt, xj, atol=1e-6, rtol=0)
        assert st.sweeps == sj.sweeps
        assert st.converged == sj.converged


def _run_both(runner, rule, kernel_t=None):
    semiring, _, _, damping, max_sweeps = RULES[rule]
    pj, pt = _plans(rule)
    fj, ft = RUNNERS[runner]
    batched = runner.endswith("batched")
    srcs = SOURCES if batched else SOURCES[:1]
    x0 = np.stack([_x0(pj, rule, s) for s in srcs])
    ch0 = np.stack([_frontier(pj, s) for s in srcs]) if rule == "relax" \
        else np.ones((len(srcs), pj.r_pad), bool)
    if not batched:
        x0, ch0 = x0[0], ch0[0]
    kw = dict(apply_kind=rule, damping=damping, tol=1e-6,
              max_sweeps=max_sweeps)
    async_ = runner.startswith("async")
    jkw = dict(kw, changed0=jnp.asarray(ch0)) if async_ else kw
    xj, sj = fj(pj, jnp.asarray(x0), impl="ref", **jkw)
    fused = kernel_t is not None and kernel_t.fuse_frontier
    tkw = dict(kw, changed0=torch.from_numpy(ch0)) \
        if async_ or fused else kw
    xt, st = ft(pt, torch.from_numpy(x0), kernel=kernel_t, **tkw)
    return np.asarray(xj), sj, xt.numpy(), st


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_engine_matches_reference(runner, rule):
    xj, sj, xt, st = _run_both(runner, rule)
    _compare(rule, xj, sj, xt, st)
    assert st.host_syncs == st.sweeps


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_fused_matches_reference_unfused(runner, rule):
    """The fused flavors compute what the unfused reference computes:
    same values (exactly, for exact rules) and the same sweep counts."""
    xj, sj, xt, st = _run_both(runner, rule, kernel_t=FUSED)
    if rule in ("relax", "kcore"):
        np.testing.assert_array_equal(xt, xj)
    else:
        np.testing.assert_allclose(xt, xj, atol=1e-6, rtol=0)
    assert (st.sweeps, st.converged) == (sj.sweeps, sj.converged)
    if runner.startswith("async"):
        # walking only the ready rows never charges more tiles
        assert st.tile_work <= sj.tile_work


def test_batched_freezes_converged_queries():
    """A converged query's sweeps stop counting: the batched work total
    is the sum of the single runs' work."""
    _, pt = _plans("relax")
    xs = [torch.from_numpy(_x0(pt, "relax", s)) for s in SOURCES]
    chs = [torch.from_numpy(_frontier(pt, s)) for s in SOURCES]
    for mode in ("sync", "async"):
        single = getattr(te, f"run_{mode}")
        batched = getattr(te, f"run_{mode}_batched")
        for kernel in (None, FUSED):
            kw = dict(kernel=kernel)
            if mode == "async" or kernel is not None:
                runs = [single(pt, x, changed0=c, **kw)
                        for x, c in zip(xs, chs)]
                xb, sb = batched(pt, torch.stack(xs),
                                 changed0=torch.stack(chs), **kw)
            else:
                runs = [single(pt, x, **kw) for x in xs]
                xb, sb = batched(pt, torch.stack(xs), **kw)
            for q, (x, _) in enumerate(runs):
                np.testing.assert_array_equal(xb[q].numpy(), x.numpy())
            assert sb.sweeps == max(s.sweeps for _, s in runs)
            assert sb.tile_work == sum(s.tile_work for _, s in runs)
            assert sb.edge_work == sum(s.edge_work for _, s in runs)


# -- BENCH_graph.json kernel_fused: the fused counters carry over ----------

_BENCH = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "BENCH_graph.json").read_text())["kernel_fused"]


@pytest.mark.parametrize("row", _BENCH,
                         ids=[f"{r['graph']}-{r['algo']}" for r in _BENCH])
def test_fused_counters_match_bench(row):
    g = (tg.road_network(29, seed=5) if row["graph"] == "road"
         else tg.rmat(512, 2048, seed=3))
    proc = tapi.GraphProcessor(g, b=16, num_clusters=64, device="cpu")
    pol = tapi.ExecutionPolicy(mode="sync", max_sweeps=100_000)
    run = proc.bfs if row["algo"] == "bfs" else proc.sssp
    rs = run(0, policy=pol)
    rf = run(0, policy=pol.but(kernel=FUSED))
    np.testing.assert_array_equal(rs.values, rf.values)
    assert rf.stats.sweeps == row["sweeps"]
    assert rs.stats.tile_work == row["tile_work_sync"]
    assert rf.stats.tile_work == row["tile_work_fused"]


# -- plans cross between the packages --------------------------------------


@pytest.mark.parametrize("rule", ["relax", "pagerank"])
def test_plan_round_trip_both_ways(rule):
    pj, pt = _plans(rule)
    from_j = te.deserialize_prepared(je.serialize_prepared(pj),
                                     device="cpu")
    from_t = je.deserialize_prepared(te.serialize_prepared(pt))
    for f in te._PREPARED_DEVICE_FIELDS:
        np.testing.assert_array_equal(getattr(from_j, f).numpy(),
                                      np.asarray(getattr(pj, f)))
        np.testing.assert_array_equal(np.asarray(getattr(from_t, f)),
                                      getattr(pt, f).numpy())
    _, _, damping, max_sweeps = RULES[rule][1:]
    x0 = _x0(pj, rule, 0)
    ch0 = _frontier(pj, 0)
    kw = dict(apply_kind=rule, damping=damping, max_sweeps=max_sweeps)
    xj, sj = je.run_async(from_t, jnp.asarray(x0),
                          changed0=jnp.asarray(ch0), **kw)
    xt, st = te.run_async(from_j, torch.from_numpy(x0),
                          changed0=torch.from_numpy(ch0), **kw)
    _compare(rule, np.asarray(xj), sj, xt.numpy(), st)


def test_plan_integrity_error():
    _, pt = _plans("relax")
    data = bytearray(te.serialize_prepared(pt))
    data[len(data) // 2] ^= 0xFF
    with pytest.raises(te.PlanIntegrityError):
        te.deserialize_prepared(bytes(data), device="cpu")
    with pytest.raises(je.PlanIntegrityError):
        je.deserialize_prepared(bytes(data))
