"""The port's runner algorithms (minitri, tricount, dfs) vs the JAX
package's, and vs the numpy oracles, on the CPU (``device="cpu"``).

Each runs through ``GraphProcessor``'s method, ``GraphProcessor.run``
with a ``QuerySpec`` and the free function of ``core/algorithms.py``, on
the graphs of tests/test_torch_api.py and a denser one with many
triangles.  Values, ``extra`` and every ``RunStats`` field must equal the
JAX package's exactly (the JAX package's MiniTri and DFS run jitted on
its CPU backend), and the values must equal ``core/oracles.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import algorithms as JA  # noqa: E402
from repro.core import api as jcore  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import algorithms as TA  # noqa: E402
from repro_torch.core import api as tcore  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import oracles as O  # noqa: E402

GRAPHS = {
    "road": lambda G: G.road_network(8, seed=1),
    "rmat": lambda G: G.rmat(96, 520, seed=5),
    "erdos": lambda G: G.erdos(40, 0.2, seed=3),
}
ENTRIES = ("method", "spec", "free")
DFS_SOURCES = (0, 7, 21)

_PROCS = {}


def _procs(gname):
    if gname not in _PROCS:
        _PROCS[gname] = (
            japi.GraphProcessor(GRAPHS[gname](jg), b=16, num_clusters=8),
            tapi.GraphProcessor(GRAPHS[gname](tg), b=16, num_clusters=8,
                                device="cpu"))
    return _PROCS[gname]


def _run(api, proc, algo, entry, src=None):
    if entry == "method":
        return proc.dfs(src) if algo == "dfs" else getattr(proc, algo)()
    if entry == "spec":
        srcs = (src,) if algo == "dfs" else ()
        return proc.run(api.QuerySpec(algo=algo, sources=srcs))
    A = JA if api is japi else TA
    kw = {} if api is japi else {"device": "cpu"}
    return A.dfs(proc.g, src, **kw) if algo == "dfs" \
        else getattr(A, algo)(proc.g, **kw)


def _stats(s):
    d = dataclasses.asdict(s)
    d.pop("host_syncs", None)
    d.pop("capture_s", None)
    return d


def _same_result(rt, rj):
    assert rt.values.dtype == np.asarray(rj.values).dtype
    np.testing.assert_array_equal(rt.values, np.asarray(rj.values))
    assert set(rt.extra) == set(rj.extra)
    for k, v in rj.extra.items():
        np.testing.assert_array_equal(rt.extra[k], np.asarray(v))
    assert _stats(rt.stats) == _stats(rj.stats)
    assert rt.prepared is None and rj.prepared is None


CASES = [(g, a, e) for g in GRAPHS for a in ("minitri", "tricount")
         for e in ENTRIES]


@pytest.mark.parametrize("gname,algo,entry", CASES,
                         ids=[f"{g}-{a}-{e}" for g, a, e in CASES])
def test_triangles_match_reference_and_oracle(gname, algo, entry):
    jp, tp = _procs(gname)
    rt = _run(tapi, tp, algo, entry)
    _same_result(rt, _run(japi, jp, algo, entry))
    total = O.triangles_oracle(tp.g)
    assert rt.extra["triangles"] == total
    if algo == "minitri":
        np.testing.assert_array_equal(rt.values, [total])
    else:
        np.testing.assert_array_equal(rt.values, O.tricount_oracle(tp.g))
        assert int(rt.values.sum()) == 3 * total


DFS_CASES = [(g, s, e) for g in GRAPHS for s in DFS_SOURCES
             for e in ENTRIES]


@pytest.mark.parametrize("gname,src,entry", DFS_CASES,
                         ids=[f"{g}-{s}-{e}" for g, s, e in DFS_CASES])
def test_dfs_matches_reference_and_oracle(gname, src, entry):
    jp, tp = _procs(gname)
    rt = _run(tapi, tp, "dfs", entry, src)
    _same_result(rt, _run(japi, jp, "dfs", entry, src))
    order, parent = O.dfs_oracle(tp.g, src)
    nv = rt.extra["visited_count"]
    assert nv == len(order) == rt.stats.sweeps
    np.testing.assert_array_equal(rt.values[:nv], order)
    assert (rt.values[nv:] == -1).all()
    np.testing.assert_array_equal(rt.extra["parent"], parent)


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("algo", ["minitri", "tricount"])
def test_triangle_chunks_do_not_change_the_result(algo, chunk):
    """The edge chunks (the device's for minitri, numpy's for tricount)
    partition the oriented edges: any chunk size gives the same bits."""
    jp, tp = _procs("erdos")
    whole = getattr(tp, algo)()
    part = getattr(tp, algo)(chunk=chunk)
    _same_result(part, whole)
    _same_result(part, getattr(jp, algo)(chunk=chunk))


def test_dfs_from_an_isolated_vertex():
    n = 12
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    rj = jg.Graph.from_edges(n, src, dst)
    rt = tg.Graph.from_edges(n, src, dst)
    out_t = TA.dfs(rt, 5, device="cpu")
    _same_result(out_t, JA.dfs(rj, 5))
    assert out_t.extra["visited_count"] == 1
    assert out_t.values[0] == 5 and out_t.extra["parent"][5] == -1


@pytest.mark.parametrize("algo", ["minitri", "tricount", "dfs"])
def test_runner_platform_models_raise_as_reference(algo):
    jp, tp = _procs("road")
    msgs = []
    for api, proc in ((japi, jp), (tapi, tp)):
        res = _run(api, proc, algo, "method", 0)
        with pytest.raises(ValueError) as e:
            res.platform_models()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# algorithms that other test files register at run time, in whichever
# process runs them before this file (tests/test_algorithms.py in the JAX
# package's registry, tests/test_torch_api.py in the port's): not part of
# either package's catalog
_TEST_REGISTERED = ("test_reliability", "torch_test_reliability")


def _catalog(api):
    return tuple(n for n in api.registered_algorithms()
                 if n not in _TEST_REGISTERED)


def test_runners_are_registered_and_accepted():
    """Every registered algorithm passes ``validate_spec`` in the port as
    in the JAX package: no runner is refused any more."""
    for name in _catalog(japi):
        a = japi.get_algorithm(name)
        srcs = (0,) if a.source_required else ()
        params = {k: 2.0 for k in a.required_params}
        for api in (jcore, tcore):
            api.validate_spec(api.QuerySpec(algo=name, sources=srcs,
                                            params=params))
    assert _catalog(tapi) == _catalog(japi)


def test_dfs_needs_a_source():
    _, tp = _procs("road")
    with pytest.raises(ValueError, match="requires at least one source"):
        tp.run(tapi.QuerySpec(algo="dfs"))

