"""The async engine's sweep without host reads, and its CUDA graph.

On the CPU: the launch accounting that moves a capture's counts to its
replays, and the async loop's shape (every group of every sweep reaches
the SpMV, the host is read once a sweep).  On the card (``-m cuda``,
skipped here): the async engine through its captured sweep against the
same run on the CPU — values, sweeps and every counter — its host reads
and its launch counts; MiniTri's intersections on the device.  No test
here imports jax, so the card tests run where the JAX package is absent.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import oracles as O  # noqa: E402
from repro_torch.kernels import bsr_spmv as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FUSED = te.KernelSpec(impl="pallas", fuse_frontier=True)
# rule -> (semiring, graph variant, prepare kwargs, damping, tol,
# max_sweeps); PageRank's tol is about 1e-6 of a rank at n = 961
RULES = {
    "relax": ("min_plus", "base", {}, 0.85, 1e-6, 10_000),
    "kcore": ("plus_times", "unit_undirected", {}, 3.0, 1e-6, 10_000),
    "pagerank_delta": ("plus_times", "base",
                       {"normalize": "out_stochastic"}, 0.85, 1e-9, 500),
}
SOURCES = (0, 300, 900)


def _graph(variant):
    g = tg.make_paper_graph("ca", scale=0.0005, seed=0)
    if variant == "unit_undirected":
        u = g.to_undirected()
        g = tg.Graph(n=u.n, indptr=u.indptr, indices=u.indices,
                     weights=np.ones(u.nnz, np.float32))
    return g


def _plan(rule, device):
    semiring, variant, kw = RULES[rule][:3]
    return te.prepare(_graph(variant), semiring, b=16, num_clusters=8,
                      device=device, **kw)


def _x0(p, rule, src):
    n = p.n
    if rule == "relax":
        x, pad = np.full(n, np.inf, np.float32), np.inf
        x[src] = 0.0
    elif rule == "kcore":
        x, pad = np.ones(n, np.float32), 0.0
    else:
        x, pad = np.full(n, 0.15 / n, np.float32), 0.0
    out = np.full(p.r_pad * p.b, pad, np.float32)
    out[p.perm] = x
    return out.reshape(p.r_pad, p.b)


def _frontier(p, rule, src):
    if rule != "relax":
        return np.ones(p.r_pad, bool)
    ch = np.zeros(p.r_pad, bool)
    ch[int(p.perm[src]) // p.b] = True
    return ch


def _run(p, rule, fused, batched):
    damping, tol, max_sweeps = RULES[rule][3:]
    srcs = SOURCES if batched else SOURCES[:1]
    x0 = torch.from_numpy(np.stack([_x0(p, rule, s) for s in srcs]))
    ch0 = torch.from_numpy(np.stack([_frontier(p, rule, s) for s in srcs]))
    kw = dict(apply_kind=rule, damping=damping, tol=tol,
              max_sweeps=max_sweeps, kernel=FUSED if fused else None)
    if batched:
        return te.run_async_batched(p, x0.to(p.device),
                                    changed0=ch0.to(p.device), **kw)
    x, st = te.run_async(p, x0[0].to(p.device), changed0=ch0[0].to(p.device),
                         **kw)
    return x[None], st


# -- on the CPU --------------------------------------------------------------


def test_capture_launches_moves_counts_to_replays():
    tk.reset_launch_counts()
    for _ in range(3):
        tk.count_launch("bsr_spmv_compact")
    with tk.capture_launches() as rec:
        for _ in range(64):
            tk.count_launch("bsr_spmv_compact")
        for _ in range(2):
            tk.count_launch("bsr_spmv_fused_compact")
    assert tk.launch_counts["bsr_spmv_compact"] == 3   # nothing launched
    assert rec["bsr_spmv_compact"] == 64
    assert rec["bsr_spmv_fused_compact"] == 2
    for _ in range(5):
        tk.add_launches(rec)
    assert tk.launch_counts["bsr_spmv_compact"] == 3 + 5 * 64
    assert tk.launch_counts["bsr_spmv_fused_compact"] == 10
    before = dict(tk.launch_counts)
    with pytest.raises(RuntimeError):
        with tk.capture_launches():
            tk.count_launch("bsr_spmv")
            raise RuntimeError("capture failed")
    assert tk.launch_counts == before               # a failed capture
    tk.reset_launch_counts()


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("fused", [False, True], ids=["ref", "fused"])
@pytest.mark.parametrize("rule", list(RULES))
def test_async_sweep_reaches_every_group(rule, fused, batched, monkeypatch):
    """No group is skipped on the host: each sweep calls the SpMV once per
    group, idle or not, and reads the host once."""
    name = "bsr_spmv_fused_compact_ref" if fused else "bsr_spmv_compact_ref"
    calls = []
    real = getattr(tref, name)
    monkeypatch.setattr(tref, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    p = _plan(rule, "cpu")
    _, st = _run(p, rule, fused, batched)
    assert st.sweeps > 1
    assert len(calls) == st.sweeps * p.s
    assert st.host_syncs == st.sweeps
    assert st.capture_s == 0.0           # the CPU runs every sweep eagerly


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("fused", [False, True], ids=["ref", "fused"])
@pytest.mark.parametrize("rule", list(RULES))
def test_cuda_captured_async_equals_cpu(rule, fused, batched, cuda):
    pc, pg = _plan(rule, "cpu"), _plan(rule, cuda)
    xc, sc = _run(pc, rule, fused, batched)
    tk.reset_launch_counts()
    xg, sg = _run(pg, rule, fused, batched)
    torch.cuda.synchronize()
    launches = dict(tk.launch_counts)
    if rule == "pagerank_delta":   # tests/test_torch_api.py's tolerance
        np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), atol=1e-6,
                                   rtol=0)
        assert abs(sg.sweeps - sc.sweeps) <= 2
    else:
        assert torch.equal(xg.cpu(), xc)
        dg, dc = dataclasses.asdict(sg), dataclasses.asdict(sc)
        for d in (dg, dc):
            d.pop("capture_s")
        assert dg == dc
    assert sg.host_syncs == sg.sweeps
    assert sg.capture_s > 0.0        # sweep 0 eager, the rest replayed
    route = "bsr_spmv_fused_compact" if fused else "bsr_spmv_compact"
    assert launches[route] == sg.sweeps * pg.s
    assert sum(launches.values()) == launches[route]


@pytest.mark.cuda
def test_cuda_capture_failure_raises(cuda, monkeypatch):
    """A sweep that cannot be captured raises; nothing runs eagerly
    instead, and the launch counts keep no trace of the capture."""
    p = _plan("relax", cuda)
    real = te._apply

    def syncing_apply(*a, **k):
        out = real(*a, **k)
        out[0].sum().item()          # a host read: illegal while capturing
        return out

    monkeypatch.setattr(te, "_apply", syncing_apply)
    tk.reset_launch_counts()
    with pytest.raises(RuntimeError):
        _run(p, "relax", False, False)
    assert tk.launch_counts["bsr_spmv_compact"] == p.s   # sweep 0 only


@pytest.mark.cuda
@pytest.mark.parametrize("gname", ["road", "rmat", "erdos"])
def test_cuda_runners_equal_cpu(gname, cuda):
    g = {"road": lambda: tg.road_network(8, seed=1),
         "rmat": lambda: tg.rmat(96, 520, seed=5),
         "erdos": lambda: tg.erdos(40, 0.2, seed=3)}[gname]()
    on_card = tapi.GraphProcessor(g, b=16, num_clusters=8, device=cuda)
    on_cpu = tapi.GraphProcessor(g, b=16, num_clusters=8, device="cpu")
    for algo in ("minitri", "tricount"):
        a, b = getattr(on_card, algo)(chunk=5), getattr(on_cpu, algo)()
        np.testing.assert_array_equal(a.values, b.values)
        assert a.extra == b.extra and a.stats == b.stats
    assert on_card.minitri().extra["triangles"] == O.triangles_oracle(g)
    a, b = on_card.dfs(0), on_cpu.dfs(0)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.extra["parent"], b.extra["parent"])
