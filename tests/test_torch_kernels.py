"""The port's SpMV kernels vs the JAX package's reference composition.

On the CPU the wrappers run the plain torch versions (``kernels/ref.py``);
those are held against ``repro.kernels.ref.bsr_spmv_ref`` and the
composition ref SpMV → ``repro.core.engine._apply`` → frontier mask.  The
tests marked ``cuda`` hold the hand-written CUDA kernels against the plain
versions on the card, on the same grid; they skip without one, and need
no jax (on the card: ``python -m pytest -q -m cuda
tests/test_torch_kernels.py``).

Tolerances: the comparison semirings (min_plus, max_min, min_select) and
the exact rules must agree bit for bit.  plus_times sums, and the PageRank
rules' (1-d)/n + d·y, are grouped differently by XLA than by the kernel
(per lane over k, then a butterfly), so against the JAX package they
agree to rtol=2e-6, the tolerance its own fused-kernel tests use.  The
plain versions repeat the kernel's order, so on the card the same
tolerance holds with room to spare.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import semiring as ts  # noqa: E402
from repro_torch.kernels import bsr_spmv as tk  # noqa: E402
from repro_torch.kernels.cuda_lib import on_cpu  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SEMIRINGS = ["plus_times", "min_plus", "max_min", "min_select"]
SHAPES = [(64, 256, 8), (200, 800, 16), (120, 900, 32)]
RULES = ["relax", "pagerank", "pagerank_delta", "kcore", "identity"]
FRONTIERS = ["empty", "sparse", "dense"]
SCALARS = dict(damping=0.85, tol=1e-6, inv_n=1e-2)


def _inexact(semiring, rule="relax"):
    return semiring == "plus_times" or rule.startswith("pagerank")


def _check(got, want, semiring, rule="relax"):
    if _inexact(semiring, rule):
        np.testing.assert_allclose(got, want, rtol=2e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _plan(n, e, b, semiring, seed):
    # the port's generator and BSR build: array-equal to the JAX
    # package's (tests/test_torch_graph.py)
    g = tg.rmat(n, e, seed=seed)
    return tg.to_bsr(g, b=b, pad_value=float(ts.get(semiring).zero))


def _x(rng, q, c, b, semiring):
    x = rng.random((q, c, b)).astype(np.float32)
    if semiring == "max_min":
        x = (x > 0.5).astype(np.float32)
    return x


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _jax_spmv(bsr_vals, cols, x, semiring):
    # imported here so that the card-only tests below also run where
    # there is no jax (the machine with the card)
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    return np.stack([np.asarray(jref.bsr_spmv_ref(
        jnp.asarray(bsr_vals), jnp.asarray(cols), jnp.asarray(xq),
        semiring)) for xq in x])


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("n,e,b", SHAPES)
def test_plain_spmv_matches_reference(n, e, b, semiring, q, rng):
    bsr = _plan(n, e, b, semiring, n + e)
    x = _x(rng, q, bsr.r, b, semiring)
    want = _jax_spmv(bsr.block_vals, bsr.block_cols, x, semiring)
    got = tk.bsr_spmv(_t(bsr.block_vals), _t(bsr.block_cols),
                      _t(bsr.block_nnz), _t(x), semiring)
    _check(got.numpy(), want, semiring)
    if q == 1:  # the 2-D spelling drops the query axis
        got2 = tk.bsr_spmv(_t(bsr.block_vals), _t(bsr.block_cols),
                           _t(bsr.block_nnz), _t(x[0]), semiring)
        np.testing.assert_array_equal(got2.numpy(), got.numpy()[0])


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_padding_is_noop(semiring, rng):
    """Extra all-padding tile slots never change the result."""
    g = tg.rmat(50, 200, seed=3)
    z = float(ts.get(semiring).zero)
    bsr = tg.to_bsr(g, b=8, pad_value=z)
    x = _t(_x(rng, 2, bsr.r, 8, semiring))
    y0 = tref.bsr_spmv_ref(_t(bsr.block_vals), _t(bsr.block_cols),
                           _t(bsr.block_nnz), x, semiring)
    vals = np.concatenate(
        [bsr.block_vals, np.full((bsr.r, 2, 8, 8), z, np.float32)], axis=1)
    cols = np.concatenate([bsr.block_cols,
                           np.zeros((bsr.r, 2), np.int32)], axis=1)
    # padding slots counted as live tiles too: identities stay no-ops
    for nnz in (bsr.block_nnz, bsr.block_nnz + 2):
        y1 = tref.bsr_spmv_ref(_t(vals), _t(cols), _t(nnz), x, semiring)
        np.testing.assert_array_equal(y0.numpy(), y1.numpy())


def _garbage(bsr):
    vals = bsr.block_vals.copy()
    lane = np.arange(bsr.k_max)[None, :]
    trash = lane >= bsr.block_nnz[:, None]
    vals[np.broadcast_to(trash[:, :, None, None], vals.shape)] = -123.0
    return vals


def test_plain_spmv_respects_nnz_bound(rng):
    """Garbage tiles beyond block_nnz never reach y."""
    bsr = tg.to_bsr(tg.rmat(60, 240, seed=4), b=8, pad_value=np.inf)
    x = _x(rng, 1, bsr.r, 8, "min_plus")
    want = _jax_spmv(bsr.block_vals, bsr.block_cols, x, "min_plus")
    got = tk.bsr_spmv(_t(_garbage(bsr)), _t(bsr.block_cols),
                      _t(bsr.block_nnz), _t(x), "min_plus")
    np.testing.assert_array_equal(got.numpy(), want)


def _fused_case(semiring, frontier, q, rng):
    bsr = _plan(120, 700, 8, semiring, 11)
    x = _x(rng, q, bsr.r, 8, semiring)
    valid = np.ones((bsr.r, 8), bool)
    valid[-1, 5:] = False  # a padded tail, as prepare() makes
    act = {"empty": np.zeros((q, bsr.r), bool),
           "sparse": rng.random((q, bsr.r)) < 0.15,
           "dense": np.ones((q, bsr.r), bool)}[frontier]
    return bsr, x, valid, act


def _fused_oracle(bsr, x, valid, act, semiring, rule):
    """The JAX package's composition: ref SpMV → engine apply → mask."""
    import jax.numpy as jnp
    from repro.core import engine as je
    from repro.core import semiring as js
    y = _jax_spmv(bsr.block_vals, bsr.block_cols, x, semiring)
    xs, chs = [], []
    for qi in range(x.shape[0]):
        x_new, imp = je._apply(
            rule, js.get(semiring), jnp.asarray(y[qi]), jnp.asarray(x[qi]),
            jnp.asarray(valid), jnp.float32(SCALARS["damping"]),
            jnp.float32(SCALARS["inv_n"]), jnp.float32(SCALARS["tol"]))
        xs.append(np.where(act[qi][:, None], np.asarray(x_new), x[qi]))
        chs.append(act[qi] & np.any(np.asarray(imp), axis=1))
    return np.stack(xs), np.stack(chs)


def _fused_call(bsr, x, valid, act, semiring, rule, device="cpu",
                vals=None):
    f32 = torch.float32
    xt = _t(x, device)
    return tk.bsr_spmv_fused(
        _t(bsr.block_vals if vals is None else vals, device),
        _t(bsr.block_cols, device), _t(bsr.block_nnz, device), xt, xt,
        _t(valid, device), _t(act, device),
        *(torch.tensor(SCALARS[k], dtype=f32)
          for k in ("damping", "tol", "inv_n")),
        semiring=semiring, apply_kind=rule)


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_plain_fused_matches_composition(semiring, frontier, rule, q, rng):
    bsr, x, valid, act = _fused_case(semiring, frontier, q, rng)
    x_exp, ch_exp = _fused_oracle(bsr, x, valid, act, semiring, rule)
    x_new, changed, conv = _fused_call(bsr, x, valid, act, semiring, rule)
    _check(x_new.numpy(), x_exp, semiring, rule)
    np.testing.assert_array_equal(changed.numpy(), ch_exp)
    np.testing.assert_array_equal(conv.numpy(), ch_exp.any(axis=1))
    if frontier == "empty":  # pure passthrough, nothing changed
        np.testing.assert_array_equal(x_new.numpy(), x)
        assert not conv.any()


def test_plain_fused_respects_nnz_bound(rng):
    bsr, x, valid, act = _fused_case("min_plus", "dense", 2, rng)
    x_exp, ch_exp = _fused_oracle(bsr, x, valid, act, "min_plus", "relax")
    x_new, changed, _ = _fused_call(bsr, x, valid, act, "min_plus",
                                    "relax", vals=_garbage(bsr))
    np.testing.assert_array_equal(x_new.numpy(), x_exp)
    np.testing.assert_array_equal(changed.numpy(), ch_exp)


def test_wrappers_refuse_bad_input():
    bsr = tg.to_bsr(tg.rmat(40, 160, seed=1), b=8, pad_value=0.0)
    v, c, n = _t(bsr.block_vals), _t(bsr.block_cols), _t(bsr.block_nnz)
    x = torch.zeros((1, bsr.r, 8))
    with pytest.raises(ValueError, match="different devices"):
        tk.bsr_spmv(v, c, n, x.to("meta"))
    # meta tensors (the dry run's) take the plain version: shapes only
    y = tk.bsr_spmv(v.to("meta"), c.to("meta"), n.to("meta"), x.to("meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (1, bsr.r, 8)
    # any device but the CPU, meta or one card is refused
    with pytest.raises(ValueError, match="unsupported device"):
        on_cpu(types.SimpleNamespace(device=torch.device("xpu")))


# -- on the card: the CUDA kernels vs the plain versions --------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("n,e,b", SHAPES)
def test_cuda_spmv_matches_plain(n, e, b, semiring, q, rng, cuda):
    bsr = _plan(n, e, b, semiring, n + e)
    x = _x(rng, q, bsr.r, b, semiring)
    args = [_t(a, cuda) for a in (bsr.block_vals, bsr.block_cols,
                                  bsr.block_nnz, x)]
    before = tk.launch_counts["bsr_spmv"]
    got = tk.bsr_spmv(*args, semiring)
    want = tref.bsr_spmv_ref(*args, semiring)
    torch.cuda.synchronize()
    assert tk.launch_counts["bsr_spmv"] == before + 1
    _check(got.cpu().numpy(), want.cpu().numpy(), semiring)
    garbage = tk.bsr_spmv(_t(_garbage(bsr), cuda), *args[1:], semiring)
    np.testing.assert_array_equal(garbage.cpu().numpy(),
                                  got.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_fused_matches_plain(semiring, frontier, rule, q, rng, cuda):
    bsr, x, valid, act = _fused_case(semiring, frontier, q, rng)
    before = tk.launch_counts["bsr_spmv_fused"]
    got = _fused_call(bsr, x, valid, act, semiring, rule, device=cuda)
    want = _fused_call(bsr, x, valid, act, semiring, rule)
    torch.cuda.synchronize()
    assert tk.launch_counts["bsr_spmv_fused"] == before + 1
    _check(got[0].cpu().numpy(), want[0].numpy(), semiring, rule)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
