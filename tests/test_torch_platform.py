"""The port's ISA compiler and platform models vs the JAX package's, on
the CPU (``device="cpu"``).

``compile_graph_program`` runs on the same graph and plan in both
packages and must emit the same instruction words, static cycles,
instruction totals and disassembly.  ``model_nale``/``model_cpu``/
``model_gpu`` and ``Result.platform_models`` are pure functions of the
plan and ``RunStats`` (Python floats in both packages), so every report
must be equal, not close.  The last tests are the JAX package's two
direction checks (tests/test_isa_power.py), run on the port's results.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import compile as JC  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import isa as JI  # noqa: E402
from repro.core import power as JP  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import algorithms as TA  # noqa: E402
from repro_torch.core import compile as TC  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import isa as TI  # noqa: E402
from repro_torch.core import power as TP  # noqa: E402

GRAPHS = {
    "rmat": lambda G: G.rmat(300, 1500, seed=9),
    "road": lambda G: G.road_network(8, seed=1),
}
RULES = ("relax", "pagerank", "pagerank_delta", "kcore", "identity")
# plans the compiler reads: (semiring, variant, normalize)
PLANS = {"min_plus": ("min_plus", "base", None),
         "plus_times": ("plus_times", "base", "out_stochastic")}
ALGOS = ("sssp", "bfs", "cc", "kcore")

_PROCS = {}
_RESULTS = {}


def _procs(gname):
    if gname not in _PROCS:
        _PROCS[gname] = (
            japi.GraphProcessor(GRAPHS[gname](jg), b=16, num_clusters=8),
            tapi.GraphProcessor(GRAPHS[gname](tg), b=16, num_clusters=8,
                                device="cpu"))
    return _PROCS[gname]


def _query(proc, api, algo, mode):
    pol = api.ExecutionPolicy(mode=mode, max_sweeps=100_000)
    if algo == "kcore":
        return proc.kcore(2, policy=pol)
    if algo == "cc":
        return proc.connected_components(policy=pol)
    return getattr(proc, algo)(0, policy=pol)


def _results(gname, algo, mode):
    """(JAX result, port result) of one query, cached per module."""
    key = (gname, algo, mode)
    if key not in _RESULTS:
        jp, tp = _procs(gname)
        _RESULTS[key] = (_query(jp, japi, algo, mode),
                         _query(tp, tapi, algo, mode))
    return _RESULTS[key]


def _same_report(a, b):
    assert a.platform == b.platform
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.perf_per_watt == b.perf_per_watt


def test_isa_is_the_reference_isa():
    assert TI.OPCODES == JI.OPCODES and TI.MNEMONICS == JI.MNEMONICS
    assert TI.BASE_COST == JI.BASE_COST
    for op in TI.OPCODES:
        np.testing.assert_array_equal(TI.instr(op, 3, 4, 5),
                                      JI.instr(op, 3, 4, 5))
    code = [TI.instr("GCFG", 0, 1), TI.instr("GMAC", 2, 7), TI.instr("GSYN")]
    pt, pj = TI.assemble(4, code), JI.assemble(4, code)
    assert pt.disassemble(limit=2) == pj.disassemble(limit=2)
    assert pt.histogram() == pj.histogram()
    assert pt.static_cycles(16) == pj.static_cycles(16)
    assert len(TI.assemble(0, [])) == len(JI.assemble(0, [])) == 0


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_compile_matches_reference(gname, plan, rule):
    jp, tp = _procs(gname)
    semiring, variant, normalize = PLANS[plan]
    pj = jp.prepare(semiring, variant=variant, normalize=normalize)
    pt = tp.prepare(semiring, variant=variant, normalize=normalize)
    cj = JC.compile_graph_program(pj, rule)
    ct = TC.compile_graph_program(pt, rule)
    assert len(ct.programs) == len(cj.programs) == pt.s
    for a, b in zip(ct.programs, cj.programs):
        assert a.cluster_id == b.cluster_id
        np.testing.assert_array_equal(a.code, b.code)
        assert a.code.dtype == b.code.dtype
        assert a.disassemble() == b.disassemble()
        assert a.disassemble(limit=10_000) == b.disassemble(limit=10_000)
    np.testing.assert_array_equal(ct.static_cycles, cj.static_cycles)
    np.testing.assert_array_equal(ct.cluster_order, cj.cluster_order)
    assert ct.instr_total == cj.instr_total
    assert ct.total_instructions() == cj.total_instructions()
    assert ct.b == cj.b
    assert ct.instr_total["GMAC"] == int(pt.nnz.sum())
    assert TC.APPLY_RULES[rule] == JC.APPLY_RULES[rule]


def test_compile_refuses_an_unknown_rule_as_reference():
    jp, tp = _procs("road")
    msgs = []
    for C, proc in ((JC, jp), (TC, tp)):
        with pytest.raises(ValueError) as e:
            C.compile_graph_program(proc.prepare("min_plus"), "warp")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_models_match_reference(gname, algo, mode):
    rj, rt = _results(gname, algo, mode)
    port = dataclasses.asdict(rt.stats)
    assert (port.pop("host_syncs"), port.pop("capture_s")) == \
        (rt.stats.sweeps, 0.0)
    assert port == dataclasses.asdict(rj.stats)
    _same_report(TP.model_nale(rt.prepared, rt.stats),
                 JP.model_nale(rj.prepared, rj.stats))
    _same_report(TP.model_cpu(rt.prepared, rt.stats),
                 JP.model_cpu(rj.prepared, rj.stats))
    g = rt.graph
    kw = dict(k_max_pad=float(np.diff(g.indptr).max()),
              avg_degree=g.avg_degree)
    _same_report(TP.model_gpu(rt.prepared, rt.stats, **kw),
                 JP.model_gpu(rj.prepared, rj.stats, **kw))
    cfg = dict(num_nales=2)
    _same_report(TP.model_nale(rt.prepared, rt.stats, TP.NaleConfig(**cfg)),
                 JP.model_nale(rj.prepared, rj.stats, JP.NaleConfig(**cfg)))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_result_platform_models_match_reference(gname, algo):
    (ja, ta), (js, ts) = (_results(gname, algo, m) for m in ("async",
                                                              "sync"))
    cases = ((ta.platform_models(sync_stats=ts.stats),
              ja.platform_models(sync_stats=js.stats)),
             (ta.platform_models(), ja.platform_models()),
             (ts.platform_models(), js.platform_models()))
    for got, want in cases:
        assert set(got) == set(want)
        for k in want:
            _same_report(got[k], want[k])
    assert set(cases[0][0]) == {"nale", "cpu", "gpu"}
    assert set(cases[1][0]) == {"nale", "cpu"}  # gpu needs sync sweeps


def test_configs_are_the_reference_constants():
    for t, j in ((TP.NaleConfig, JP.NaleConfig), (TP.CpuConfig, JP.CpuConfig),
                 (TP.GpuConfig, JP.GpuConfig)):
        assert dataclasses.asdict(t()) == dataclasses.asdict(j())


# -- the JAX package's direction checks, on the port's own results ----------


def _port_prepared():
    g = tg.rmat(300, 1500, seed=9)
    ra = TA.sssp(g, 0, mode="async", b=16, num_clusters=8, device="cpu")
    rs = TA.sssp(g, 0, mode="sync", b=16, num_clusters=8, device="cpu")
    return g, ra, rs


def test_platform_models_ordering():
    """NALE beats the in-order CPU; async NALE power ≪ GPU power —
    the paper's two headline directions."""
    g, ra, rs = _port_prepared()
    p = ra.prepared
    nale = TP.model_nale(p, ra.stats)
    cpu = TP.model_cpu(p, ra.stats)
    gpu = TP.model_gpu(p, rs.stats,
                       k_max_pad=float(np.diff(g.indptr).max()),
                       avg_degree=g.avg_degree)
    assert nale.time_s < cpu.time_s
    assert nale.power_w < gpu.power_w
    assert nale.perf_per_watt > gpu.perf_per_watt
    for r in (nale, cpu, gpu):
        assert r.cycles > 0 and r.energy_j > 0 and r.power_w > 0


def test_nale_scales_with_parallelism():
    g, ra, _ = _port_prepared()
    p = ra.prepared
    few = TP.model_nale(p, ra.stats, TP.NaleConfig(num_nales=2))
    many = TP.model_nale(p, ra.stats, TP.NaleConfig(num_nales=256))
    assert many.time_s <= few.time_s
