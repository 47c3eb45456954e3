"""The port's measured autotuner and kernel roofline against the JAX
package's.

On the CPU (``device="cpu"``): the counterparts of tests/
test_kernelspec.py's ``test_autotune_deterministic``,
``test_autotune_cached_per_plan`` and ``test_tunings_survive_plan_store_
restart`` with the same assertions; the tuning record equal to
``repro.kernels.autotune.autotune_spmv``'s under one shared fake
``measure`` in every key but the roofline's (the port's model counts the
compacted kernel's bytes); the calibration inputs and
``KernelSpec.concrete`` equal to ``repro``'s; ``kernel_roofline`` on fixed
inputs; the modelled bytes against an independent count of a small plan's
compacted index; ``autotune=True`` queries through ``GraphProcessor``,
``GraphService`` and ``GraphServer`` equal to ``repro``'s ``impl="ref"``
runs in values and counters, with the tuned knobs reaching every engine
and a tuning measured once under two server workers.

On the card (``-m cuda``, skipped here; no jax needed): every candidate of
the grid against the plain version, bitwise, on the four rings at b 8, 16
and 32 with hub rows; a captured async query on tuned knobs equal to the
untuned one; the tuner under two ``GraphServer`` workers measuring once.
"""

import dataclasses
import itertools
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import semiring as ts  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import bsr_spmv as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

CPU = "cpu"
WAIT = 60          # seconds: the bound on every wait for a future
TUNE = api.KernelSpec(impl="pallas", autotune=True)
TUNE_FUSED = api.KernelSpec(impl="pallas", fuse_frontier=True,
                            autotune=True)


@pytest.fixture(scope="module")
def ref():
    """The JAX package, for the parity tests; they skip where JAX is
    absent (the card's machine runs only the ``-m cuda`` tests)."""
    pytest.importorskip("jax")
    from repro import api as japi
    from repro.core import graph as jgraph
    from repro.kernels import autotune as jat
    from repro.kernels import spec as jspec
    from repro.launch import roofline as jrl
    return types.SimpleNamespace(api=japi, graph=jgraph, autotune=jat,
                                 spec=jspec, roofline=jrl)


@pytest.fixture(scope="module")
def erdos():
    return G.erdos(200, 0.03, seed=2, weighted=True)


@pytest.fixture(scope="module")
def road():
    return G.road_network(10, seed=1)


def _fake_measure(calls):
    def measure(call, config, iters):
        calls.append(config)
        # deterministic synthetic cost: favour bk=4, rs=2
        return (abs(config.block_size - 4) + 1) * \
            (abs((config.rows_per_step or 1) - 2) + 1) * 1e-6
    return measure


def _flat_measure(calls):
    def measure(call, config, iters):
        calls.append(config)
        return 1e-6              # every candidate ties: smallest knobs win
    return measure


# -- the reference's three tests (tests/test_kernelspec.py) ------------------


def test_autotune_deterministic(erdos):
    proc = api.GraphProcessor(erdos, b=16, num_clusters=16, device=CPU)
    p = proc.prepare("min_plus")
    calls = []
    rec1 = at.autotune_spmv(p, TUNE, seed=0, measure=_fake_measure(calls))
    rec2 = at.autotune_spmv(p, TUNE, seed=0, measure=_fake_measure([]))
    assert rec1 == rec2
    assert (rec1["block_size"], rec1["rows_per_step"]) == (4, 2)
    assert rec1["seed"] == 0
    assert len(calls) == len(rec1["candidates"])
    assert rec1["modeled_s"] > 0 and rec1["measured_s"] > 0
    # pinned fields shrink the sweep
    pinned = at.autotune_spmv(
        p, api.KernelSpec(impl="pallas", autotune=True, block_size=8),
        seed=0, measure=_fake_measure([]))
    assert all(c["block_size"] == 8 for c in pinned["candidates"])
    with pytest.raises(ValueError):
        at.autotune_spmv(p, api.KernelSpec(impl="ref"), seed=0)


def test_autotune_cached_per_plan(erdos):
    proc = api.GraphProcessor(erdos, b=16, num_clusters=16, device=CPU)
    pol = api.ExecutionPolicy(mode="sync", kernel=TUNE_FUSED)
    r1 = proc.sssp(3, policy=pol)
    r2 = proc.sssp(5, policy=pol)
    info = proc.cache_info()
    assert info["autotune_calls"] == 1 and info["tunings"] == 1
    # tuning must not change results vs the untuned fused path
    r0 = proc.sssp(3, policy=api.ExecutionPolicy(mode="sync"))
    np.testing.assert_array_equal(r0.values, r1.values)
    assert r2.stats.converged


def test_tunings_survive_plan_store_restart(erdos, tmp_path, ref):
    pol = api.ExecutionPolicy(mode="sync", kernel=TUNE)

    svc = api.GraphService(cache_dir=str(tmp_path), device=CPU)
    proc = svc.register("g", erdos, b=16, num_clusters=16)
    r1 = proc.sssp(3, policy=pol)
    assert proc.cache_info()["autotune_calls"] == 1
    assert svc.store.stats()["tunings"] == 1

    # cold process, same cache_dir: the tuning record comes off disk, the
    # calibration sweep is NOT re-run
    svc2 = api.GraphService(cache_dir=str(tmp_path), device=CPU)
    assert svc2.store.stats()["tunings"] == 1
    proc2 = svc2.register("g", erdos, b=16, num_clusters=16)
    r = proc2.sssp(3, policy=pol)
    assert proc2.cache_info()["autotune_calls"] == 0
    assert r.stats.converged

    key = proc2.plan_key("min_plus")
    tkey = dataclasses.replace(key, kernel=TUNE)
    rec = svc2.store.get_tuning(erdos.fingerprint(), tkey)
    assert rec is not None and rec["block_size"] >= 1
    assert rec == svc.store.get_tuning(erdos.fingerprint(), tkey)
    # the values are repro's impl="ref" run's
    jproc = ref.api.GraphProcessor(ref.graph.erdos(200, 0.03, seed=2,
                                                   weighted=True),
                                   b=16, num_clusters=16)
    want = jproc.sssp(3, policy=ref.api.ExecutionPolicy(mode="sync"))
    for got in (r1, r):
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
        assert got.stats.sweeps == want.stats.sweeps


# -- parity of the record, the calibration and concrete() ---------------------


PARITY_SPECS = {
    "free": dict(autotune=True),
    "bk-pinned": dict(autotune=True, block_size=4),
    "rs-pinned": dict(autotune=True, rows_per_step=2),
    "fused": dict(autotune=True, fuse_frontier=True),
}


def _plans(ref, b, semiring="min_plus"):
    jp = ref.api.GraphProcessor(ref.graph.road_network(10, seed=1), b=b,
                                num_clusters=8).prepare(semiring)
    tp = api.GraphProcessor(G.road_network(10, seed=1), b=b,
                            num_clusters=8, device=CPU).prepare(semiring)
    return jp, tp


@pytest.mark.parametrize("measure", [_fake_measure, _flat_measure],
                         ids=["fake", "ties"])
@pytest.mark.parametrize("spec", list(PARITY_SPECS))
@pytest.mark.parametrize("b", [8, 16])
def test_record_equals_reference(ref, b, spec, measure):
    jp, tp = _plans(ref, b)
    jcalls, tcalls = [], []
    want = ref.autotune.autotune_spmv(
        jp, ref.spec.KernelSpec(impl="pallas", **PARITY_SPECS[spec]),
        seed=3, measure=measure(jcalls))
    got = at.autotune_spmv(
        tp, api.KernelSpec(impl="pallas", **PARITY_SPECS[spec]), seed=3,
        measure=measure(tcalls))
    for k in ("modeled_s", "roofline_agrees"):
        want.pop(k)
        got.pop(k)
    assert got == want
    assert [dataclasses.asdict(c) for c in tcalls] == \
        [dataclasses.asdict(c) for c in jcalls]
    assert (at.CALIBRATION_DENSITY, at.BK_CANDIDATES, at.RS_CANDIDATES) == \
        (ref.autotune.CALIBRATION_DENSITY, ref.autotune.BK_CANDIDATES,
         ref.autotune.RS_CANDIDATES)


@pytest.mark.parametrize("semiring", ["min_plus", "plus_times"])
def test_calibration_inputs_equal_reference(ref, semiring):
    jp, tp = _plans(ref, 16, semiring)
    want = ref.autotune._calibration_inputs(jp, 7, "relax")
    got = at._calibration_inputs(tp, 7, "relax")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.device == tp.device


def _spec_grid(KernelSpec):
    """Every KernelSpec of a small grid, or the ValueError it raises."""
    out = []
    for impl, bk, rs, fused, tune in itertools.product(
            ("ref", "pallas"), (None, 4), (None, 1, 2), (False, True),
            (False, True)):
        try:
            out.append(KernelSpec(impl=impl, block_size=bk, rows_per_step=rs,
                                  fuse_frontier=fused, autotune=tune))
        except ValueError:
            out.append(None)
    return out


@pytest.mark.parametrize("tuning", [
    None, {}, {"block_size": 16, "rows_per_step": 4}, {"block_size": 2},
    {"rows_per_step": 2, "measured_s": 1e-5}], ids=["none", "empty", "both",
                                                     "bk", "rs"])
def test_concrete_equals_reference(ref, tuning):
    tspecs = _spec_grid(api.KernelSpec)
    jspecs = _spec_grid(ref.spec.KernelSpec)
    assert [s is None for s in tspecs] == [s is None for s in jspecs]
    for t, j in zip(tspecs, jspecs):
        if t is None:
            continue
        assert dataclasses.asdict(t.concrete(tuning)) == \
            dataclasses.asdict(j.concrete(tuning))
    from repro_torch.kernels import spec as tspec
    assert (tspec.DEFAULT_BLOCK_SIZE, tspec.DEFAULT_ROWS_PER_STEP) == \
        (ref.spec.DEFAULT_BLOCK_SIZE, ref.spec.DEFAULT_ROWS_PER_STEP)


# -- the roofline and the modelled bytes --------------------------------------


def test_kernel_roofline_fixed_inputs(ref):
    assert (rl.HBM_BW, rl.PEAK_FLOPS, rl.BF16_PEAK_FLOPS, rl.ICI_BW) == \
        (3.35e12, 67e12, 989e12, 450e9)
    r = rl.kernel_roofline(67e12, 3.35e12)
    assert r == {"t_compute_s": 1.0, "t_memory_s": 1.0, "t_collective_s": 0.0,
                 "dominant": "compute", "modeled_s": 1.0}
    r = rl.kernel_roofline(6.7e9, 3.35e10, 4.5e8)
    assert r["dominant"] == "memory"
    assert r["t_compute_s"] == pytest.approx(1e-4, rel=1e-12)
    assert r["t_memory_s"] == pytest.approx(1e-2, rel=1e-12)
    assert r["t_collective_s"] == pytest.approx(1e-3, rel=1e-12)
    assert r["modeled_s"] == pytest.approx(1.1e-2, rel=1e-12)
    assert set(r) == set(ref.roofline.kernel_roofline(1.0, 1.0, 1.0))


@pytest.mark.parametrize("fused", [False, True], ids=["spmv", "fused"])
@pytest.mark.parametrize("semiring", ["min_plus", "plus_times"])
def test_modeled_bytes_against_independent_count(road, semiring, fused):
    """The model's bytes from a direct numpy walk of the ELL image: the
    filled entries of the walked rows (8 B), their row pointers, each
    distinct x value once, y once; fused also xg, valid, act, changed."""
    p = te.prepare(road, semiring, b=16, num_clusters=8, device=CPU)
    x, act, *_ = at._calibration_inputs(p, 0, "relax")
    vals, cols, nnz = p.vals.numpy(), p.cols.numpy(), p.nnz.numpy()
    zero = np.float32(ts.get(semiring).zero).view(np.int32)
    b = p.b
    rows = np.flatnonzero(act.numpy()) if fused else np.arange(p.r_pad)
    entries, srcs = 0, set()
    for r in rows:
        tiles = vals[r, :nnz[r]].view(np.int32)              # (k, i, j)
        kk, _, jj = np.nonzero(tiles != zero)
        entries += kk.size
        srcs.update((cols[r, kk] * b + jj).tolist())
    n = rows.size * b
    want = entries * 8 + (n + 1) * 4 + len(srcs) * 4 + n * 4
    if fused:
        want += n * 4 + n + 2 * p.r_pad
    model = at._modeled_seconds(p, act, fused)
    assert at.entry_bytes(p.compact_index(), 1, act if fused else None,
                          fused=fused) == want
    assert model["t_memory_s"] == want / rl.HBM_BW
    assert model["t_compute_s"] == 2.0 * entries / rl.PEAK_FLOPS
    assert model["modeled_s"] == max(model["t_memory_s"],
                                     model["t_compute_s"])
    assert entries > 0


# -- autotune=True through the session ----------------------------------------


QUERY_CASES = [(m, f, b) for m in ("sync", "async") for f in (False, True)
               for b in (False, True)]


@pytest.mark.parametrize(
    "mode,fused,batched", QUERY_CASES,
    ids=[f"{m}-{'fused' if f else 'spmv'}-{'batch' if b else 'one'}"
         for m, f, b in QUERY_CASES])
def test_autotune_query_equals_reference(ref, road, mode, fused, batched):
    """``autotune=True`` queries equal repro's impl="ref" runs: values and
    sweeps always, every counter on the unfused path; the fused path's
    counters equal the port's untuned fused run's."""
    spec = TUNE_FUSED if fused else TUNE
    tproc = api.GraphProcessor(road, b=16, num_clusters=8, device=CPU)
    jproc = ref.api.GraphProcessor(ref.graph.road_network(10, seed=1),
                                   b=16, num_clusters=8)
    src = [0, 7, 21] if batched else 0
    got = tproc.sssp(src, policy=api.ExecutionPolicy(mode=mode,
                                                     kernel=spec))
    want = jproc.sssp(src, policy=ref.api.ExecutionPolicy(mode=mode))
    assert tproc.cache_info()["autotune_calls"] == 1
    assert "degraded" not in got.extra
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    assert got.stats.sweeps == want.stats.sweeps
    fields = ("tile_work", "edge_work", "crit_tiles", "active_group_sweeps",
              "halo_tiles", "total_groups", "converged", "mode")
    if fused:
        want = tproc.sssp(src, policy=api.ExecutionPolicy(
            mode=mode, kernel=api.KernelSpec(impl="pallas",
                                             fuse_frontier=True)))
        np.testing.assert_array_equal(got.values, want.values)
        fields += ("sweeps",)
    for f in fields:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert tproc.cache_info()["autotune_calls"] == 1


def _spy_knobs(monkeypatch):
    """Record the knobs every SpMV wrapper call gets."""
    seen = []
    spmv, fused = tk.bsr_spmv, tk.bsr_spmv_fused

    def spy_spmv(*a, block_size=None, rows_per_step=None, **kw):
        seen.append(("spmv", block_size, rows_per_step))
        return spmv(*a, block_size=block_size, rows_per_step=rows_per_step,
                    **kw)

    def spy_fused(*a, block_size=None, **kw):
        seen.append(("fused", block_size, 1))
        return fused(*a, block_size=block_size, **kw)
    monkeypatch.setattr(tk, "bsr_spmv", spy_spmv)
    monkeypatch.setattr(tk, "bsr_spmv_fused", spy_fused)
    return seen


@pytest.mark.parametrize(
    "mode,fused,batched", QUERY_CASES,
    ids=[f"{m}-{'fused' if f else 'spmv'}-{'batch' if b else 'one'}"
         for m, f, b in QUERY_CASES])
def test_tuned_knobs_reach_every_engine(road, mode, fused, batched,
                                        monkeypatch):
    """The winner's knobs reach every launch of the sync, async and
    batched engines; without autotune the defaults do."""
    spec = TUNE_FUSED if fused else TUNE
    proc = api.GraphProcessor(road, b=16, num_clusters=8, device=CPU)
    p = proc.prepare("min_plus", kernel=spec)    # measured at prepare
    assert proc.cache_info()["autotune_calls"] == 1
    tkey = dataclasses.replace(proc.plan_key("min_plus"), kernel=spec)
    proc._tunings[tkey] = dict(proc._tunings[tkey], block_size=2,
                               rows_per_step=4)
    seen = _spy_knobs(monkeypatch)
    src = [0, 7] if batched else 0
    proc.sssp(src, policy=api.ExecutionPolicy(mode=mode, kernel=spec))
    kind = "fused" if fused else "spmv"
    assert seen and set(seen) == {(kind, 2, 1 if fused else 4)}
    del seen[:]
    plain = api.KernelSpec(impl="pallas", fuse_frontier=fused)
    proc.sssp(src, policy=api.ExecutionPolicy(mode=mode, kernel=plain))
    assert set(seen) == {(kind, 8, 1)}
    assert proc.cache_info()["autotune_calls"] == 1
    assert p is proc.prepare("min_plus")


def test_knobs_are_checked_and_ignored_on_the_cpu(road):
    p = te.prepare(road, "min_plus", b=16, num_clusters=8, device=CPU)
    index = p.compact_index()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, p.r_pad, p.b)).astype(np.float32))
    want = tk.bsr_spmv(p.vals, p.cols, p.nnz, x, "min_plus", index=index)
    for bk, rs in ((1, 1), (2, 4), (32, 3)):
        got = tk.bsr_spmv(p.vals, p.cols, p.nnz, x, "min_plus", index=index,
                          block_size=bk, rows_per_step=rs)
        assert torch.equal(got, want)
    act = torch.ones((2, p.r_pad), dtype=torch.bool)
    args = (p.vals, p.cols, p.nnz, x, x, p.valid, act, 0.85, 1e-6, 0.01,
            "min_plus", "relax")
    fwant = tk.bsr_spmv_fused(*args, index=index)
    for got, w in zip(tk.bsr_spmv_fused(*args, index=index, block_size=3),
                      fwant):
        assert torch.equal(got, w)
    for bad in (dict(block_size=0), dict(block_size=33),
                dict(rows_per_step=0), dict(block_size=True),
                dict(rows_per_step=1.0)):
        with pytest.raises(ValueError):
            tk.bsr_spmv(p.vals, p.cols, p.nnz, x, "min_plus", index=index,
                        **bad)
    with pytest.raises(ValueError):
        tk.bsr_spmv_fused(*args, index=index, block_size=64)


def test_default_measure_on_the_cpu():
    calls = []

    def call():
        calls.append(1)
        return torch.zeros(3)
    t = at.default_measure(call, TUNE.concrete(), 4)
    assert len(calls) == 5 and 0.0 <= t < 10.0


def test_autotune_refuses_a_custom_semiring(road):
    p = te.prepare(road, "min_plus", b=16, num_clusters=8, device=CPU)
    q = dataclasses.replace(p, semiring="torch_test_no_such_ring")
    with pytest.raises(ValueError, match="built-in rings"):
        at.autotune_spmv(q, TUNE, measure=_fake_measure([]))


# -- the serving layer ----------------------------------------------------------


def _slow_autotune(monkeypatch, delay):
    """Count the tuner's calls; each takes ``delay`` seconds more, so two
    waves that need one record surely overlap in it."""
    calls = []
    real = at.autotune_spmv

    def slow(p, spec, **kw):
        calls.append(spec)
        time.sleep(delay)
        return real(p, spec, measure=_fake_measure([]), **kw)
    monkeypatch.setattr(at, "autotune_spmv", slow)
    return calls


def test_tuning_measured_once_under_two_workers(road, ref, monkeypatch):
    """Two waves of one plan and one tuning key (their policies differ
    only in max_sweeps, so they do not coalesce) on two workers: the
    record is measured once, and both waves' values equal repro's."""
    calls = _slow_autotune(monkeypatch, 0.3)
    svc = api.GraphService(device=CPU)
    svc.register("roads", road, b=16, num_clusters=8)
    pols = [api.ExecutionPolicy(mode="async", kernel=TUNE,
                                max_sweeps=m) for m in (10_000, 20_000)]
    srcs = (0, 3, 7)
    srv = api.GraphServer(service=svc, wave=api.WavePolicy(
        workers=2, max_wait_s=0.005), autostart=False)
    futs = {(i, s): srv.submit("roads", api.QuerySpec(
        algo="sssp", sources=(s,), policy=pol))
        for i, pol in enumerate(pols) for s in srcs}
    srv.start()
    res = {k: f.result(WAIT) for k, f in futs.items()}
    assert srv.sched.drain(timeout=WAIT)
    srv.close()
    assert len(calls) == 1
    assert svc.get("roads").cache_info()["autotune_calls"] == 1
    assert svc.store.stats()["tunings"] == 1
    assert srv.stats()["scheduler"]["waves"] == 2
    jproc = ref.api.GraphProcessor(ref.graph.road_network(10, seed=1),
                                   b=16, num_clusters=8)
    for (_, s), r in res.items():
        want = jproc.sssp(s, policy=ref.api.ExecutionPolicy(mode="async"))
        np.testing.assert_array_equal(r.values, np.asarray(want.values))
        assert r.extra["coalesced"] == len(srcs)


def test_service_gather_uses_the_stored_tuning(road, tmp_path, monkeypatch):
    """A GraphService's coalesced wave runs on the record its store holds:
    measured by the first service, read back by a second on the same
    cache_dir, which measures nothing."""
    calls = _slow_autotune(monkeypatch, 0.0)
    pol = api.ExecutionPolicy(mode="sync", kernel=TUNE_FUSED)

    def wave(svc):
        svc.register("roads", road, b=16, num_clusters=8)
        ts_ = [svc.submit("roads", api.QuerySpec(algo="bfs", sources=(s,),
                                                 policy=pol))
               for s in (1, 5)]
        out = svc.gather()
        return [out[t] for t in ts_]
    first = wave(api.GraphService(cache_dir=str(tmp_path), device=CPU))
    svc2 = api.GraphService(cache_dir=str(tmp_path), device=CPU)
    seen = _spy_knobs(monkeypatch)
    second = wave(svc2)
    assert len(calls) == 1
    assert svc2.get("roads").cache_info()["autotune_calls"] == 0
    assert {k for k, *_ in seen} == {"fused"}
    assert {bk for _, bk, _ in seen} == {4}   # _fake_measure's winner
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.values, b.values)
        assert a.extra["coalesced"] == 2


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _hub_plan(semiring, b, dev):
    """A power-law plan whose hub rows exceed LONG_ROW entries."""
    g = G.make_paper_graph("fb", scale=0.0004, seed=0)
    return te.prepare(g, semiring, b=b, num_clusters=8, device=dev)


GRID = [(bk, rs) for bk in at.BK_CANDIDATES for rs in at.RS_CANDIDATES]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 16, 32])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "max_min",
                                      "min_select"])
def test_cuda_every_candidate_bitwise(semiring, b, cuda):
    p = _hub_plan(semiring, b, cuda)
    index = p.compact_index()
    assert len(index.long_host) > 0
    rng = np.random.default_rng(b)
    x = rng.random((2, p.r_pad, b)).astype(np.float32)
    if semiring == "max_min":
        x = (x > 0.5).astype(np.float32)
    x = torch.from_numpy(x).to(cuda)
    want = tref.bsr_spmv_compact_ref(index, x, semiring)
    for bk, rs in GRID + [(1, 1), (32, 1), (3, 5)]:
        got = tk.bsr_spmv(p.vals, p.cols, p.nnz, x, semiring, index=index,
                          block_size=bk, rows_per_step=rs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (bk, rs)
    act = torch.from_numpy(rng.random((2, p.r_pad)) < 0.3).to(cuda)
    args = (p.vals, p.cols, p.nnz, x, x, p.valid, act, 0.85, 1e-6,
            1.0 / p.n, semiring, "relax")
    fwant = tref.bsr_spmv_fused_compact_ref(index, *args[3:])
    for bk in at.BK_CANDIDATES + (1, 32):
        got = tk.bsr_spmv_fused(*args, index=index, block_size=bk)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, fwant):
            assert torch.equal(g_, w_), bk


@pytest.mark.cuda
def test_cuda_captured_async_query_on_tuned_knobs(cuda):
    g = G.make_paper_graph("ca", scale=0.002, seed=0)
    proc = api.GraphProcessor(g, b=16, num_clusters=8, device=cuda)
    base = proc.sssp(0, policy=api.ExecutionPolicy(
        mode="async", kernel=api.KernelSpec(impl="pallas",
                                            fuse_frontier=True)))
    tk.reset_launch_counts()
    got = proc.sssp(0, policy=api.ExecutionPolicy(mode="async",
                                                  kernel=TUNE_FUSED))
    torch.cuda.synchronize()
    info = proc.cache_info()
    assert info["autotune_calls"] == 1
    rec = next(iter(proc._tunings.values()))
    assert rec["roofline_agrees"]
    np.testing.assert_array_equal(got.values, base.values)
    assert dataclasses.asdict(got.stats) | {"capture_s": 0} == \
        dataclasses.asdict(base.stats) | {"capture_s": 0}
    assert got.stats.capture_s > 0.0
    # the tuner's own launches: one warm-up and three timed a candidate
    n_cand = len(rec["candidates"])
    assert tk.launch_counts["bsr_spmv_fused_compact"] == \
        4 * n_cand + got.stats.sweeps * got.prepared.s


@pytest.mark.cuda
def test_cuda_tuner_under_two_workers_measures_once(cuda, monkeypatch):
    calls = []
    real = at.autotune_spmv

    def counted(p, spec, **kw):
        calls.append(spec)
        return real(p, spec, **kw)
    monkeypatch.setattr(at, "autotune_spmv", counted)
    g = G.make_paper_graph("ca", scale=0.002, seed=0)
    svc = api.GraphService(device=cuda)
    svc.register("ca", g, b=16, num_clusters=8)
    pols = [api.ExecutionPolicy(mode="async", kernel=TUNE,
                                max_sweeps=m) for m in (10_000, 20_000)]
    srcs = list(range(0, 320, 40))
    want = svc.run("ca", api.QuerySpec(algo="sssp", sources=tuple(srcs),
                                       batched=True)).values
    srv = api.GraphServer(service=svc, wave=api.WavePolicy(
        workers=2, max_wait_s=0.005), autostart=False)
    futs = [[srv.submit("ca", api.QuerySpec(algo="sssp", sources=(s,),
                                            policy=pol)) for s in srcs]
            for pol in pols]
    srv.start()
    res = [[f.result(WAIT) for f in fs] for fs in futs]
    assert srv.sched.drain(timeout=WAIT)
    torch.cuda.synchronize()
    srv.close()
    assert len(calls) == 1
    assert svc.store.stats()["tunings"] == 1
    for rows in res:
        for r, w in zip(rows, want):
            np.testing.assert_array_equal(r.values, w)
