"""Host-side graph pipeline of the PyTorch port vs the JAX package.

Same seeds → the same CSR arrays, BSR tile image, clustering, content
fingerprint and every ``Prepared`` array (array-equal: this is all host
numpy, and the device half is only an upload)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import cluster as jc  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import semiring as js  # noqa: E402
from repro_torch.core import cluster as tc  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

GENERATORS = {
    "road": lambda G: G.road_network(12, seed=3),
    "rmat": lambda G: G.rmat(200, 900, seed=4),
    "ring": lambda G: G.ring(40),
    "erdos": lambda G: G.erdos(50, 0.08, seed=5),
    "paper_ca": lambda G: G.make_paper_graph("ca", scale=1 / 2048, seed=1),
    "paper_fb": lambda G: G.make_paper_graph("fb", scale=1 / 8192, seed=2),
}


def _pair(name):
    return GENERATORS[name](jg), GENERATORS[name](tg)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_equal(name):
    a, b = _pair(name)
    assert a.n == b.n
    for f in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.fingerprint() == b.fingerprint()


@pytest.mark.parametrize("name", ["road", "rmat"])
def test_graph_transforms_equal(name):
    a, b = _pair(name)
    perm = np.random.default_rng(0).permutation(a.n).astype(np.int32)
    for fa, fb in ((a.transpose(), b.transpose()),
                   (a.to_undirected(), b.to_undirected()),
                   (a.permute(perm), b.permute(perm))):
        assert fa.fingerprint() == fb.fingerprint()
    ea, eb = jg.to_ell(a), tg.to_ell(b)
    fa, fb = jg.to_ell_fast(a), tg.to_ell_fast(b)
    for x, y in ((ea, eb), (fa, fb), (ea, fb)):
        np.testing.assert_array_equal(x.cols, y.cols)
        np.testing.assert_array_equal(x.vals, y.vals)
        np.testing.assert_array_equal(x.deg, y.deg)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("b", [8, 16, 32])
def test_bsr_equal(semiring, b):
    a, g = _pair("rmat")
    za = float(js.get(semiring).zero)
    ba = jg.to_bsr(a, b, pad_value=za)
    bb = tg.to_bsr(g, b, pad_value=za)
    for f in ("block_vals", "block_cols", "block_nnz", "edge_nnz"):
        np.testing.assert_array_equal(getattr(ba, f), getattr(bb, f))
    assert (ba.r, ba.k_max, ba.density_stats()) == \
        (bb.r, bb.k_max, bb.density_stats())
    np.testing.assert_array_equal(jg.bsr_to_dense(ba), tg.bsr_to_dense(bb))


@pytest.mark.parametrize("name", ["road", "rmat", "paper_ca"])
def test_clustering_equal(name):
    a, b = _pair(name)
    for k in (4, 16):
        ca, cb = jc.cluster_graph(a, k), tc.cluster_graph(b, k)
        for f in ("assign", "perm", "sizes", "schedule"):
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
        assert (ca.internal_edges, ca.cut_edges) == \
            (cb.internal_edges, cb.cut_edges)
        ia, ib = jc.identity_clustering(a, k), tc.identity_clustering(b, k)
        np.testing.assert_array_equal(ia.assign, ib.assign)
        np.testing.assert_array_equal(jc.place_clusters(ca, 3),
                                      tc.place_clusters(cb, 3))
    assert jc.tile_stats_after(a, ca, 16) == tc.tile_stats_after(b, cb, 16)


@pytest.mark.parametrize("semiring,normalize,pull", [
    ("min_plus", None, True), ("plus_times", "out_stochastic", True),
    ("max_min", None, False), ("min_select", None, True)])
def test_prepared_arrays_equal(semiring, normalize, pull):
    a, b = _pair("road")
    pa = je.prepare(a, semiring, b=16, num_clusters=8, pull=pull,
                    normalize=normalize)
    pb = te.prepare(b, semiring, b=16, num_clusters=8, pull=pull,
                    normalize=normalize, device="cpu")
    for f in je._PREPARED_DEVICE_FIELDS:
        ja, tb = np.asarray(getattr(pa, f)), getattr(pb, f).numpy()
        assert ja.dtype == tb.dtype, f
        np.testing.assert_array_equal(ja, tb, err_msg=f)
    for f in ("n", "b", "r_pad", "k_max", "gb", "s", "semiring",
              "tiles_total", "edges_total"):
        assert getattr(pa, f) == getattr(pb, f), f
    np.testing.assert_array_equal(pa.perm, pb.perm)
    np.testing.assert_array_equal(pa.inv_perm, pb.inv_perm)
    np.testing.assert_array_equal(pa.clustering.schedule,
                                  pb.clustering.schedule)
    x = np.arange(a.n, dtype=np.float32)
    xb = pb.to_blocks(x, np.inf)
    np.testing.assert_array_equal(np.asarray(pa.to_blocks(x, np.inf)),
                                  xb.numpy())
    np.testing.assert_array_equal(pb.from_blocks(xb), x)


def test_prepare_without_device_needs_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.prepare(tg.ring(16), "min_plus", b=8)
