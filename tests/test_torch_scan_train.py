"""Training through the scans: ``wkv6.wkv6_train`` and
``rg_lru.rg_lru_scan``, autograd Functions whose backwards are the
hand-written kernels ``csrc/wkv6_backward.cu`` and ``csrc/rg_lru.cu`` on
the card and their plain versions (``ref.wkv6_heads_backward_ref``,
``ref.rg_lru_scan_backward_ref``) on the CPU.

On the CPU, in f32 at small sizes, from numpy draws: every gradient of
``wkv6_train`` (r, k, v, w, u, s0, with dy and a nonzero ds_last) against
``jax.grad`` of the JAX package's ``models.rwkv._wkv_scan``, and every
gradient of the port's RG-LRU training path (x, h0, wr, wi, lam, through
``rg_lru_scan``) against ``jax.grad`` of ``models.griffin._rg_lru``,
within 1e-5 relative L2 each (summation order only); T 1024 takes the
reference's remat over 512-step chunks.  CPU tensors launch nothing, and
``launch/train`` trains both scan families and restarts them bit for
bit.

The tests marked ``cuda`` hold the kernels to their plain versions on the
card, bit for bit (both built with -fmad=false, the plain versions in
the kernels' order), and need no jax (on the card: ``python -m pytest -q
-m cuda tests/test_torch_scan_train.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rg_lru as trg  # noqa: E402
from repro_torch.kernels import wkv6 as twkv  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import griffin as tgriffin  # noqa: E402

REL_L2 = 1e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _wkv_inputs(rng, b, t, h, hs):
    """r, k, v, dy ~ N(0, 1); w in rwkv6's init decay range,
    exp(-exp(U(-6, -1))); u ~ N(0, 0.25); s0, ds_last ~ N(0, 0.01)."""
    r, k, v, dy = (rng.standard_normal((b, t, h, hs)) for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(-6, -1, (b, t, h, hs))))
    u = 0.5 * rng.standard_normal((h, hs))
    s0, ds_last = (0.1 * rng.standard_normal((b, h, hs, hs))
                   for _ in range(2))
    return [np.asarray(x, np.float32) for x in (r, k, v, w, u, s0, dy,
                                                ds_last)]


def _wkv_grads(args):
    """The port's six gradients through ``wkv6_train``, f32 on the CPU."""
    ins = [torch.from_numpy(x).requires_grad_(True) for x in args[:6]]
    y, s = twkv.wkv6_train(*ins)
    return torch.autograd.grad((y, s), ins, (torch.from_numpy(args[6]),
                                             torch.from_numpy(args[7])))


@pytest.mark.parametrize("b,t,h,hs", [(2, 33, 3, 16), (1, 1024, 2, 8)])
def test_wkv6_train_grads_match_jax(b, t, h, hs, rng):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as jrwkv
    args = _wkv_inputs(rng, b, t, h, hs)
    dy, ds_last = (jnp.asarray(x) for x in args[6:])

    def loss(*ins):
        y, s = jrwkv._wkv_scan(*ins)
        return jnp.sum(y * dy) + jnp.sum(s * ds_last)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(x) for x in args[:6]))
    got = _wkv_grads(args)
    for name, g, jg in zip(("r", "k", "v", "w", "u", "s0"), got, want):
        assert g.dtype == torch.float32 and g.shape == jg.shape, name
        assert float(g.abs().sum()) > 0, name
        assert _rel_l2(g.numpy(), jg) <= REL_L2, name


def test_wkv6_backward_blocks_give_the_same_bits(rng, monkeypatch):
    """The plain backward over blocks of a few steps gives the bits of
    one block: every sum runs in the kernel's order either way."""
    args = [torch.from_numpy(x) for x in _wkv_inputs(rng, 2, 21, 2, 8)]
    whole = tref.wkv6_heads_backward_ref(*args)
    monkeypatch.setattr(tref, "WKV_BWD_BLOCK", 2 * 2 * 8 * 8 * 4)
    for a, b in zip(tref.wkv6_heads_backward_ref(*args), whole):
        assert torch.equal(a, b)


def _recurrent(rng, ld):
    """A reduced recurrentgemma's RG-LRU leaves from numpy (wr, wi at the
    init scale, lam around the init's a = σ(Λ) ≈ .98), as numpy and as
    the port's ``Recurrent``."""
    cfg = dataclasses.replace(tget("recurrentgemma-9b").reduced(),
                              lru_dim=ld, compute_dtype="float32")
    leaves = {"wr": rng.standard_normal((ld, ld)) / np.sqrt(ld),
              "wi": rng.standard_normal((ld, ld)) / np.sqrt(ld),
              "lam": np.log(np.expm1(4.0)) + rng.standard_normal(ld)}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    p = tgriffin.Recurrent(cfg, device="cpu")
    with torch.no_grad():
        for name, x in leaves.items():
            getattr(p, name).copy_(torch.from_numpy(x))
    for param in p.parameters():
        param.requires_grad_(True)
    return leaves, p


@pytest.mark.parametrize("b,s,ld", [(2, 40, 16), (1, 1024, 8)])
def test_rg_lru_train_grads_match_jax(b, s, ld, rng):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import griffin as jgriffin
    leaves, p = _recurrent(rng, ld)
    x, dy = (rng.standard_normal((b, s, ld)).astype(np.float32)
             for _ in range(2))
    h0, dh_last = (rng.standard_normal((b, ld)).astype(np.float32)
                   for _ in range(2))

    def loss(lv, x_, h0_):
        y, h = jgriffin._rg_lru(lv, x_, h0_, jnp.float32)
        return jnp.sum(y * dy) + jnp.sum(h * dh_last)

    jg, jgx, jgh = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        {k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(x),
        jnp.asarray(h0))
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, h0))
    trg.reset_launch_counts()
    y, h = tgriffin._rg_lru(p, tx, th, train=True)
    (y * torch.from_numpy(dy)).sum().add(
        (h * torch.from_numpy(dh_last)).sum()).backward()
    assert trg.launch_counts == {"rg_lru": 0, "rg_lru_backward": 0}
    for name, g, want in (("x", tx.grad, jgx), ("h0", th.grad, jgh),
                          *((k, getattr(p, k).grad, jg[k]) for k in leaves)):
        assert float(g.abs().sum()) > 0, name
        assert _rel_l2(g.numpy(), want) <= REL_L2, name
    # the step loop of serving and the scan agree on the values
    with torch.no_grad():
        y_loop, h_loop = tgriffin._rg_lru(p, tx, th)
    assert _rel_l2(y.detach().numpy(), y_loop.numpy()) <= REL_L2
    assert _rel_l2(h.detach().numpy(), h_loop.numpy()) <= REL_L2


def test_cpu_tensors_never_launch(rng):
    """Forward and backward of both Functions on CPU tensors: the plain
    versions, bit for bit, and no count moves."""
    twkv.reset_launch_counts()
    trg.reset_launch_counts()
    args = _wkv_inputs(rng, 1, 130, 2, 64)
    for dt in (torch.float32, torch.bfloat16):
        t = [torch.from_numpy(x) for x in args]
        t[:4] = [x.to(dt) for x in t[:4]]
        t[6] = t[6].to(dt)
        assert twkv.route(dt, 130, 64) == ("chunked" if dt == torch.bfloat16
                                           else "recurrent")
        ins = [x.clone().requires_grad_(True) for x in t[:6]]
        y, s = twkv.wkv6_train(*ins)
        got = torch.autograd.grad((y, s), ins, (t[6], t[7]))
        want_y, want_s = tref.wkv6_heads_ref(*t[:6])
        assert torch.equal(y, want_y) and torch.equal(s, want_s)
        for g, want in zip(got, tref.wkv6_heads_backward_ref(*t)):
            assert g.dtype == want.dtype and torch.equal(g, want)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 17, 8)).astype(
        np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((2, 17, 8)).astype(
        np.float32)).requires_grad_(True)
    h0 = torch.zeros((2, 8), requires_grad=True)
    h_all, h_last = trg.rg_lru_scan(a, g, h0)
    want_h, want_last = tref.rg_lru_scan_ref(a.detach(), g.detach(), h0)
    assert torch.equal(h_all, want_h) and torch.equal(h_last, want_last)
    h_all.sum().backward()
    da, dg, dh0 = tref.rg_lru_scan_backward_ref(
        a.detach(), h0.detach(), want_h.detach(), torch.ones_like(want_h),
        torch.zeros_like(want_last))
    assert torch.equal(a.grad, da) and torch.equal(g.grad, dg) and \
        torch.equal(h0.grad, dh0)
    assert all(n == 0 for n in twkv.launch_counts.values())
    assert all(n == 0 for n in trg.launch_counts.values())


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_launch_train_trains_the_scan_families(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch ...`` on the CPU at the
    reduced config: every loss finite and every master moved off its
    init; a failure at step 2 of 3 restarts from the step-1 checkpoint
    (the f32 leaves of the scan blocks and their AdamW state) and ends on
    the uninterrupted run's masters and state, bit for bit."""
    from repro_torch.train import step as tstep
    from repro_torch.train import tree as T
    args = ["--device", "cpu", "--arch", arch, "--steps", "3", "--batch",
            "2", "--seq", "16"]
    out = tlaunch.main(args)
    assert out["final_step"] == 3
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    init = tstep.init_masters(tget(arch).reduced(), 0, "cpu")
    for (path, a), b in zip(T.items(out["params"]), T.leaves(init)):
        assert not torch.equal(a, b), path
    again = tlaunch.main(args + ["--ckpt-dir", str(tmp_path / "c"),
                                 "--ckpt-every", "1", "--fail-at", "2"])
    assert again["restarts"] == 1 and again["final_step"] == 3
    for a, b in zip(T.leaves(out["params"]) + T.leaves(out["opt_state"]),
                    T.leaves(again["params"]) + T.leaves(again["opt_state"])):
        assert torch.equal(a, b)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hs,dt", [
    (2, 300, 3, 64, torch.bfloat16), (1, 77, 2, 64, torch.float32),
    (2, 40, 3, 20, torch.float32), (1, 16, 1, 32, torch.bfloat16)])
def test_cuda_wkv6_backward_matches_plain(b, t, h, hs, dt, rng, cuda):
    """The backward kernel against its plain version on the card, bit for
    bit, one launch, and the same bits on a second launch."""
    args = [torch.from_numpy(x).to(cuda) for x in
            _wkv_inputs(rng, b, t, h, hs)]
    for i in (0, 1, 2, 3, 6):
        args[i] = args[i].to(dt)
    before = twkv.launch_counts["wkv6_backward"]
    got = twkv._launch_backward(*args)
    again = twkv._launch_backward(*args)
    want = tref.wkv6_heads_backward_ref(*args)
    torch.cuda.synchronize()
    assert twkv.launch_counts["wkv6_backward"] == before + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_cuda_rg_lru_matches_plain(rng, cuda):
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 100, 300)).astype(
        np.float32)).to(cuda)
    g, dh = (torch.from_numpy(rng.standard_normal((3, 100, 300)).astype(
        np.float32)).to(cuda) for _ in range(2))
    h0, dh_last = (torch.from_numpy(rng.standard_normal((3, 300)).astype(
        np.float32)).to(cuda) for _ in range(2))
    before = dict(trg.launch_counts)
    h_all, h_last = trg._launch(a, g, h0)
    grads = trg._launch_backward(a, h0, h_all, dh, dh_last)
    want_h, want_last = tref.rg_lru_scan_ref(a, g, h0)
    want = tref.rg_lru_scan_backward_ref(a, h0, want_h, dh, dh_last)
    torch.cuda.synchronize()
    assert trg.launch_counts == {k: v + 1 for k, v in before.items()}
    assert torch.equal(h_all, want_h) and torch.equal(h_last, want_last)
    assert all(torch.equal(x, y) for x, y in zip(grads, want))
