"""The compacted route of the port's SpMV kernels, on the CPU.

``kernels/bsr_spmv.build_compact_index`` keeps the filled entries of a
plan's ELL tile image; the plain versions over it
(``ref.bsr_spmv_compact_ref`` and its fused form) must equal the ELL plain
versions bit for bit (``torch.equal``) on every ring, tile size, query
count, update rule and frontier, and the engines, which take the
compacted route, must still equal the JAX package's ``impl="ref"`` runs
as ``tests/test_torch_engine.py`` holds them: exact rules bit for bit with
every ``RunStats`` counter, PageRank within atol 1e-6 with equal sweeps.
The tests marked ``cuda`` hold the compacted CUDA kernels against their
plain versions and against the ELL kernels, bitwise; they skip without a
card (on the card: ``python -m pytest -q -m cuda
tests/test_torch_compact_spmv.py``, no jax needed).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import semiring as ts  # noqa: E402
from repro_torch.kernels import bsr_spmv as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SEMIRINGS = ["plus_times", "min_plus", "max_min", "min_select"]
BLOCKS = [8, 16, 32]
RULES = ["relax", "pagerank", "pagerank_delta", "kcore", "identity"]
FRONTIERS = ["empty", "sparse", "dense"]
SCALARS = dict(damping=0.85, tol=1e-6, inv_n=1e-2)


def _unique_graph(n, e, seed):
    """An rmat graph with its duplicate edges dropped, weights in (0, 1]."""
    g = tg.rmat(n, e, seed=seed)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    key = np.unique(src.astype(np.int64) * g.n + g.indices)
    s, d = key // g.n, key % g.n
    w = np.random.default_rng(seed).uniform(0.05, 1.0, key.size)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=g.n))])
    return tg.Graph(n=g.n, indptr=indptr.astype(g.indptr.dtype),
                    indices=d.astype(g.indices.dtype),
                    weights=w.astype(np.float32))


def _prepared(semiring, b, seed=0):
    g = _unique_graph(40 * b, 300 * b // 8, seed + b)
    return te.prepare(g, semiring, b=b, num_clusters=4, device="cpu")


def _numpy_index(vals, cols, nnz, zero):
    """(row_ptr, src, value bits) by a direct count: for each vertex row
    (r, i), the entries at k < nnz[r] whose bits are not the identity's,
    in (k, j) order."""
    r, _, b, _ = vals.shape
    bits = vals.view(np.int32)
    zbits = np.float32(zero).view(np.int32)
    row_ptr, src, val = [0], [], []
    for rb in range(r):
        for i in range(b):
            tile = bits[rb, :nnz[rb], i, :]                  # (k, j)
            kk, jj = np.nonzero(tile != zbits)
            src.extend(cols[rb, kk] * b + jj)
            val.extend(tile[kk, jj])
            row_ptr.append(len(src))
    return (np.array(row_ptr, np.int64), np.array(src, np.int64),
            np.array(val, np.int32))


def _x(rng, q, c, b, semiring, rule="relax"):
    x = rng.random((q, c, b)).astype(np.float32)
    if semiring == "max_min" or rule == "kcore":
        x = (x > 0.5).astype(np.float32)  # {0,1} carrier; integer counts
    return torch.from_numpy(x)


def _garbage(p):
    dead = torch.arange(p.k_max)[None, :] >= p.nnz[:, None]
    return torch.where(dead[:, :, None, None], -123.0, p.vals)


def _scalars(rule):
    d = 3.0 if rule == "kcore" else SCALARS["damping"]
    return [torch.tensor(v, dtype=torch.float32)
            for v in (d, SCALARS["tol"], SCALARS["inv_n"])]


def _act(rng, frontier, q, r):
    return torch.from_numpy({
        "empty": np.zeros((q, r), bool),
        "sparse": rng.random((q, r)) < 0.15,
        "dense": np.ones((q, r), bool)}[frontier])


# -- the index ----------------------------------------------------------------


@pytest.mark.parametrize("b", BLOCKS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_index_holds_exactly_the_filled_entries(semiring, b):
    p = _prepared(semiring, b)
    idx = tk.build_compact_index(p.vals, p.cols, p.nnz, semiring)
    row_ptr, src, val = _numpy_index(p.vals.numpy(), p.cols.numpy(),
                                     p.nnz.numpy(), ts.get(semiring).zero)
    np.testing.assert_array_equal(idx.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(idx.src.numpy(), src)
    np.testing.assert_array_equal(idx.pairs[:, 1].numpy(), val)
    assert idx.r == p.r_pad and idx.b == b and idx.semiring == semiring
    # no duplicate edge and no identity weight: one entry per edge
    assert idx.pairs.shape[0] == p.edges_total
    # tiles beyond nnz never enter, whatever they hold
    dirty = tk.build_compact_index(_garbage(p), p.cols, p.nnz, semiring)
    assert torch.equal(dirty.row_ptr, idx.row_ptr)
    assert torch.equal(dirty.pairs, idx.pairs)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_index_drops_identity_and_duplicate_edges(semiring):
    """Edges whose weight is the ring's identity leave no entry, and a
    duplicate edge keeps one: the index is shorter than edges_total."""
    g = _unique_graph(256, 1200, 7)
    zero = np.float32(ts.get(semiring).zero)
    w = g.weights.copy()
    w[::5] = zero
    dup = tg.Graph(n=g.n, indptr=g.indptr, indices=g.indices, weights=w)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    # the first edge twice, as the last of its row
    idx_d = np.insert(dup.indices, g.indptr[src[0] + 1], dup.indices[0])
    w_d = np.insert(w, g.indptr[src[0] + 1], w[0])
    indptr = g.indptr.copy()
    indptr[src[0] + 1:] += 1
    dup = tg.Graph(n=g.n, indptr=indptr, indices=idx_d, weights=w_d)
    p = te.prepare(dup, semiring, b=16, num_clusters=4, device="cpu")
    idx = p.compact_index()
    n_identity = int((w == zero).sum())
    assert idx.pairs.shape[0] == p.edges_total - 1 - n_identity
    assert not (idx.val.view(torch.int32) == int(
        torch.tensor(float(zero)).view(torch.int32))).any()


def _hub_plan(semiring, b):
    """A power-law plan whose hub rows exceed LONG_ROW entries."""
    g = tg.make_paper_graph("fb", scale=0.0004, seed=0)
    return te.prepare(g, semiring, b=b, num_clusters=8, device="cpu")


@pytest.mark.parametrize("b", BLOCKS)
def test_index_lists_long_rows(b):
    p = _hub_plan("min_plus", b)
    idx = p.compact_index()
    lens = np.diff(idx.row_ptr.numpy())
    want = np.flatnonzero(lens > tk.LONG_ROW)
    assert want.size > 0
    np.testing.assert_array_equal(idx.long_host, want)
    np.testing.assert_array_equal(idx.long_rows.numpy(), want)
    assert idx.row_base == 0
    # a view lists the long rows of its own row-blocks, by their full id
    for g in range(p.s):
        view = idx.rows(slice(g * p.gb, (g + 1) * p.gb))
        first = g * p.gb * b
        assert view.row_base == first
        inside = want[(want >= first) & (want < first + p.gb * b)]
        np.testing.assert_array_equal(view.long_host, inside)
        np.testing.assert_array_equal(view.long_rows.numpy(), inside)
        again = view.rows(slice(1, p.gb))
        assert again.row_base == first + b
        np.testing.assert_array_equal(again.long_host,
                                      inside[inside >= first + b])


# -- plain versions: compacted == ELL, bit for bit ---------------------------


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("b", BLOCKS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_compact_plain_equals_ell_plain(semiring, b, q, rng):
    p = _prepared(semiring, b, seed=1)
    idx = p.compact_index()
    x = _x(rng, q, p.r_pad, b, semiring)
    want = tref.bsr_spmv_ref(p.vals, p.cols, p.nnz, x, semiring)
    got = tk.bsr_spmv(p.vals, p.cols, p.nnz, x, semiring, index=idx)
    assert torch.equal(got, want)
    assert torch.equal(tref.bsr_spmv_compact_ref(idx, x, semiring), want)
    if q == 1:  # the 2-D spelling drops the query axis
        got2 = tk.bsr_spmv(p.vals, p.cols, p.nnz, x[0], semiring, index=idx)
        assert torch.equal(got2, want[0])


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_fused_compact_plain_equals_ell_plain(semiring, frontier, rule, q,
                                              rng):
    for b in BLOCKS:
        p = _prepared(semiring, b, seed=2)
        idx = p.compact_index()
        x = _x(rng, q, p.r_pad, b, semiring, rule)
        act = _act(rng, frontier, q, p.r_pad)
        args = (x, x, p.valid, act, *_scalars(rule), semiring, rule)
        want = tref.bsr_spmv_fused_ref(p.vals, p.cols, p.nnz, *args)
        got = tk.bsr_spmv_fused(p.vals, p.cols, p.nnz, *args, index=idx)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), (b, frontier)
        if frontier == "empty":
            assert torch.equal(got[0], x) and not got[2].any()


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_group_view_equals_sliced_ell(semiring, rng):
    """A group's ``rows(sl)`` view (a slice of row_ptr, no copy) against
    the ELL plain versions on the sliced arrays, with the full x."""
    p = _prepared(semiring, 16, seed=3)
    idx = p.compact_index()
    x = _x(rng, 2, p.r_pad, 16, semiring)
    for g in range(p.s):
        sl = slice(g * p.gb, (g + 1) * p.gb)
        view = idx.rows(sl)
        assert view.pairs is idx.pairs and view.r == p.gb
        assert view.row_ptr.data_ptr() == (idx.row_ptr.data_ptr()
                                           + sl.start * 16 * 4)
        ell = (p.vals[sl], p.cols[sl], p.nnz[sl])
        want = tref.bsr_spmv_ref(*ell, x, semiring)
        assert torch.equal(tk.bsr_spmv(*ell, x, semiring, index=view), want)
        xg = x[:, sl].contiguous()
        act = _act(rng, "sparse", 2, p.gb)
        args = (x, xg, p.valid[sl], act, *_scalars("relax"), semiring,
                "relax")
        want = tref.bsr_spmv_fused_ref(*ell, *args)
        got = tk.bsr_spmv_fused(*ell, *args, index=view)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)


def test_compact_route_refuses_bad_input():
    p = _prepared("plus_times", 8)
    idx = p.compact_index()
    x = torch.zeros((1, p.r_pad, 8))
    with pytest.raises(ValueError, match="identity"):
        tref.bsr_spmv_compact_ref(idx, x, "min_plus")
    with pytest.raises(ValueError, match="step 1"):
        idx.rows(slice(0, 4, 2))
    with pytest.raises(ValueError, match="different devices"):
        tk.bsr_spmv(p.vals, p.cols, p.nnz, x.to("meta"), index=idx)
    assert set(tk.launch_counts) == {
        "bsr_spmv", "bsr_spmv_fused", "bsr_spmv_compact",
        "bsr_spmv_fused_compact"}


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_hub_plan_compact_plain_equals_ell_plain(semiring, rng):
    p = _hub_plan(semiring, 32)
    idx = p.compact_index()
    x = _x(rng, 2, p.r_pad, 32, semiring)
    want = tref.bsr_spmv_ref(p.vals, p.cols, p.nnz, x, semiring)
    assert torch.equal(tk.bsr_spmv(p.vals, p.cols, p.nnz, x, semiring,
                                   index=idx), want)


# -- the plan: built once, kept out of its bytes -----------------------------


def test_index_is_not_part_of_the_plan_bytes():
    p = _prepared("min_plus", 16)
    before = te.serialize_prepared(p)
    assert p.compact is None
    idx = p.compact_index()
    assert p.compact_index() is idx          # built once
    assert te.serialize_prepared(p) == before
    assert "compact" not in repr(p)
    field = {f.name: f for f in dataclasses.fields(te.Prepared)}["compact"]
    assert not field.compare and not field.repr
    q = te.deserialize_prepared(before, device="cpu")
    assert q.compact is None
    again = q.compact_index()
    assert torch.equal(again.row_ptr, idx.row_ptr)
    assert torch.equal(again.pairs, idx.pairs)


# -- the engines through the compacted route vs the JAX package --------------

# rule -> (semiring, prepare kwargs, damping, tol, max_sweeps); PageRank's
# tol is about 1e-6 of a rank (n = 961), as tests/test_torch_engine.py's
# 1e-6 is at n = 64: the fused loop skips rows whose inputs moved by less
ENGINE_RULES = {
    "relax": ("min_plus", {}, 0.85, 1e-6, 10_000),
    "pagerank": ("plus_times", {"normalize": "out_stochastic"}, 0.85, 1e-9,
                 500),
    "kcore": ("plus_times", {}, 2.0, 1e-6, 10_000),
}
_PLANS = {}


def _ca(G, rule):
    g = G.make_paper_graph("ca", scale=0.0005, seed=0)
    if rule == "kcore":
        u = g.to_undirected()
        g = G.Graph(n=u.n, indptr=u.indptr, indices=u.indices,
                    weights=np.ones(u.nnz, np.float32))
    return g


def _plans(rule):
    if rule not in _PLANS:
        from repro.core import engine as je
        from repro.core import graph as jg
        semiring, kw, _, _, _ = ENGINE_RULES[rule]
        _PLANS[rule] = (
            je.prepare(_ca(jg, rule), semiring, b=16, num_clusters=8, **kw),
            te.prepare(_ca(tg, rule), semiring, b=16, num_clusters=8,
                       device="cpu", **kw))
    return _PLANS[rule]


def _x0(p, rule):
    n = p.n
    if rule == "relax":
        x, pad = np.full(n, np.inf, np.float32), np.inf
        x[0] = 0.0
    elif rule == "kcore":
        x, pad = np.ones(n, np.float32), 0.0
    else:
        x, pad = np.full(n, 1.0 / n, np.float32), 0.0
    out = np.full(p.r_pad * p.b, pad, np.float32)
    out[p.perm] = x
    return out.reshape(p.r_pad, p.b)


def _run_port(rule, mode, fused, pt):
    _, _, damping, tol, max_sweeps = ENGINE_RULES[rule]
    x0 = _x0(pt, rule)
    kw = dict(apply_kind=rule, damping=damping, tol=tol,
              max_sweeps=max_sweeps,
              kernel=(te.KernelSpec(impl="pallas", fuse_frontier=True)
                      if fused else None))
    if mode == "async" or fused:
        kw["changed0"] = torch.ones(pt.r_pad, dtype=torch.bool)
    run = te.run_sync if mode == "sync" else te.run_async
    return run(pt, torch.from_numpy(x0), **kw)


def _spy_compact(monkeypatch):
    calls = []
    for name in ("bsr_spmv_compact_ref", "bsr_spmv_fused_compact_ref"):
        def spy(*a, _real=getattr(tref, name), _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(tref, name, spy)
    return calls


@pytest.mark.parametrize("fused", [False, True], ids=["ref", "fused"])
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("rule", ["relax", "kcore"])
def test_engine_on_compacted_route_matches_reference(rule, mode, fused,
                                                     monkeypatch):
    """Exact rules against the JAX package: values bit for bit, and every
    RunStats counter (the unfused runs) or the sweeps (the fused runs,
    whose counters walk only the active rows)."""
    import jax.numpy as jnp
    from repro.core import engine as je
    pj, pt = _plans(rule)
    _, _, damping, tol, max_sweeps = ENGINE_RULES[rule]
    calls = _spy_compact(monkeypatch)
    kw = dict(apply_kind=rule, damping=damping, tol=tol,
              max_sweeps=max_sweeps)
    if mode == "async":
        kw["changed0"] = jnp.ones(pj.r_pad, dtype=bool)
    run = je.run_sync if mode == "sync" else je.run_async
    xj, sj = run(pj, jnp.asarray(_x0(pj, rule)), impl="ref", **kw)
    xt, st = _run_port(rule, mode, fused, pt)
    # the fused plain version reaches the unfused one for y
    assert "bsr_spmv_compact_ref" in calls
    assert ("bsr_spmv_fused_compact_ref" in calls) == fused
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    if fused:
        assert (st.sweeps, st.converged) == (sj.sweeps, sj.converged)
        assert st.tile_work <= sj.tile_work
    else:
        ds, dj = dataclasses.asdict(st), dataclasses.asdict(sj)
        ds.pop("host_syncs")
        ds.pop("capture_s")
        dj.pop("host_syncs", None)
        assert ds == dj


@pytest.mark.parametrize("fused", [False, True], ids=["ref", "fused"])
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("rule", list(ENGINE_RULES))
def test_engine_compacted_route_equals_ell_route(rule, mode, fused,
                                                 monkeypatch):
    """Every loop on the compacted route against the same loop on the ELL
    route (a plan without an index): the same bits, sweeps, counters and
    host syncs, PageRank included."""
    _, pt = _plans(rule)
    xc, sc = _run_port(rule, mode, fused, pt)
    monkeypatch.setattr(te.Prepared, "compact_index", lambda self: None)
    calls = _spy_compact(monkeypatch)
    xe, se = _run_port(rule, mode, fused, pt)
    assert not calls
    assert torch.equal(xc, xe)
    assert dataclasses.asdict(sc) == dataclasses.asdict(se)


# -- on the card: the compacted kernels vs the plain versions and ELL ---------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _on(p, dev):
    return {f: getattr(p, f).to(dev) for f in ("vals", "cols", "nnz",
                                                "valid")}


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("b", BLOCKS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_compact_spmv_bitwise(semiring, b, q, rng, cuda):
    p = _prepared(semiring, b, seed=4)
    d = _on(p, cuda)
    idx = tk.build_compact_index(d["vals"], d["cols"], d["nnz"], semiring)
    x = _x(rng, q, p.r_pad, b, semiring).to(cuda)
    ell = (d["vals"], d["cols"], d["nnz"])
    before = tk.launch_counts["bsr_spmv_compact"]
    got = tk.bsr_spmv(*ell, x, semiring, index=idx)
    plain = tref.bsr_spmv_compact_ref(idx, x, semiring)
    ell_y = tk.bsr_spmv(*ell, x, semiring)
    torch.cuda.synchronize()
    assert tk.launch_counts["bsr_spmv_compact"] == before + 1
    assert torch.equal(got, plain)
    assert torch.equal(got, ell_y)
    view = idx.rows(slice(1, p.r_pad - 1))
    got = tk.bsr_spmv(*(a[1:-1] for a in ell), x, semiring, index=view)
    assert torch.equal(got, ell_y[:, 1:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_fused_compact_bitwise(semiring, frontier, rule, q, rng, cuda):
    for b in BLOCKS:
        p = _prepared(semiring, b, seed=5)
        d = _on(p, cuda)
        idx = tk.build_compact_index(d["vals"], d["cols"], d["nnz"],
                                     semiring)
        x = _x(rng, q, p.r_pad, b, semiring, rule).to(cuda)
        act = _act(rng, frontier, q, p.r_pad).to(cuda)
        args = (x, x, d["valid"], act, *_scalars(rule), semiring, rule)
        ell = (d["vals"], d["cols"], d["nnz"])
        before = tk.launch_counts["bsr_spmv_fused_compact"]
        got = tk.bsr_spmv_fused(*ell, *args, index=idx)
        plain = tref.bsr_spmv_fused_compact_ref(idx, *args)
        ell_out = tk.bsr_spmv_fused(*ell, *args)
        torch.cuda.synchronize()
        assert tk.launch_counts["bsr_spmv_fused_compact"] == before + 1
        for g_, p_, e_ in zip(got, plain, ell_out):
            assert torch.equal(g_, p_), (b, "plain")
            assert torch.equal(g_, e_), (b, "ell")


@pytest.mark.cuda
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_long_rows_bitwise(semiring, rule, rng, cuda):
    """Hub rows (more than LONG_ROW entries) go one warp a row: both
    kernels against plain and ELL, on the plan and on group views."""
    p = _hub_plan(semiring, 32)
    d = _on(p, cuda)
    ell = (d["vals"], d["cols"], d["nnz"])
    idx = tk.build_compact_index(*ell, semiring)
    assert len(idx.long_host) > 0
    x = _x(rng, 2, p.r_pad, 32, semiring, rule).to(cuda)
    sc = _scalars(rule)
    for g in range(p.s):
        sl = slice(g * p.gb, (g + 1) * p.gb)
        view, part = idx.rows(sl), tuple(a[sl] for a in ell)
        got = tk.bsr_spmv(*part, x, semiring, index=view)
        assert torch.equal(got, tref.bsr_spmv_compact_ref(view, x, semiring))
        assert torch.equal(got, tk.bsr_spmv(*part, x, semiring))
        xg = x[:, sl].contiguous()
        act = _act(rng, "sparse", 2, p.gb).to(cuda)
        args = (x, xg, d["valid"][sl], act, *sc, semiring, rule)
        got = tk.bsr_spmv_fused(*part, *args, index=view)
        plain = tref.bsr_spmv_fused_compact_ref(view, *args)
        ell_out = tk.bsr_spmv_fused(*part, *args)
        torch.cuda.synchronize()
        for g_, p_, e_ in zip(got, plain, ell_out):
            assert torch.equal(g_, p_) and torch.equal(g_, e_)
