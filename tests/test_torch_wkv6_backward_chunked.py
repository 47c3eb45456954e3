"""WKV6's chunked backward: its plain version, the route to its CUDA
kernel, the kernel.

``wkv6_train``'s backward takes the forward's route (``wkv6.route``):
bf16 at head size 64 and T >= 128 launches the chunked backward kernel
(``csrc/wkv6_backward_chunked.cu``), everything else the recurrent one
(``csrc/wkv6_backward.cu``).  On the CPU both run the recurrent plain
backward (``ref.wkv6_heads_backward_ref``) whatever the route.

The chunked plain backward, ``ref.wkv6_chunked_heads_backward_ref``,
computes the kernel's algebra in its blocking.  In f32 it rounds nothing,
so it is held to ``jax.grad`` of the JAX package's ``models.rwkv.
_wkv_scan`` within 1e-5 relative L2 per gradient (summation order only),
to ``torch.autograd`` of the chunked forward's plain version, and to the
recurrent plain backward at extreme decays.  In bf16 it forms every
product from bf16 operands as the kernel does, so against the recurrent
plain backward it is held to ``chip_smoke.py``'s ``WKV_BWD_REL_L2``
(relative L2 per output: 1e-2 for the bf16 dr, dk, dv, dw; 1e-5 for the
f32 du and ds0), which two planted faults must fail.

The tests marked ``cuda`` hold the kernel against both plain versions on
the card, as ``chip_smoke.py``'s ``wkv6_backward_chunked_case`` does:
against the chunked plain version dr, dk, dv, dw within one bf16 step and
du, ds0 within 1e-5 relative L2 (only the order of the sums inside the
matrix products differs); against the recurrent one ``WKV_BWD_REL_L2``.
They skip without a card and need no jax (on the card: ``python -m
pytest -q -m cuda tests/test_torch_wkv6_backward_chunked.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv6 as twkv  # noqa: E402

REL_L2 = 1e-5
# chip_smoke.WKV_BWD_REL_L2: dr, dk, dv, dw at their dtype's; du, ds0 f32
BWD_REL_L2 = {"bfloat16": 1e-2, "float32": 1e-5}
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(rng, b, t, h, hs, decays="model"):
    """Float32 numpy, model layout: r, k, v, dy ~ N(0, 1) (B, T, H, hs);
    w by ``decays`` as test_torch_wkv6_chunked.py's ``_heads``: "model"
    exp(-exp(U(-6, -1))), "strong" U(0.4, 0.9), "extreme" 10^U(-6, 0)
    with one w in 16 set to 0; u (H, hs) ~ N(0, 0.25); s0, ds_last (B, H,
    hs, hs) ~ N(0, 0.01).  Returns r, k, v, w, u, s0, dy, ds_last."""
    r, k, v, dy = (rng.standard_normal((b, t, h, hs)) for _ in range(4))
    x = rng.random((b, t, h, hs))
    if decays == "model":
        w = np.exp(-np.exp(x * 5 - 6))
    elif decays == "strong":
        w = x * 0.5 + 0.4
    else:
        w = np.where(rng.random((b, t, h, hs)) < 1 / 16, 0.0, 10 ** (-6 * x))
    u = rng.standard_normal((h, hs)) * 0.5
    s0, ds_last = (rng.standard_normal((b, h, hs, hs)) * 0.1
                   for _ in range(2))
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u, s0, dy,
                                                ds_last)]


def _t(arrs, dtype=torch.float32, device="cpu"):
    """r, k, v, w and dy in ``dtype``; u, s0 and ds_last f32."""
    out = [torch.from_numpy(a).to(device) for a in arrs]
    for i in (0, 1, 2, 3, 6):
        out[i] = out[i].to(dtype)
    return out


def _rel(got, want) -> float:
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _rels(got, want):
    return {n: _rel(a, b) for n, a, b in zip(NAMES, got, want)}


def _within(rels, dtype) -> bool:
    key = str(dtype).split(".")[-1]
    return all(v <= BWD_REL_L2["float32" if n in ("du", "ds0") else key]
               for n, v in rels.items())


# -- the chunked plain backward in f32 ---------------------------------------


@pytest.mark.parametrize("t", [33, 64, 65, 130])
@pytest.mark.parametrize("decays", ["model", "strong"])
def test_chunked_plain_backward_matches_jax_grad(t, decays, rng):
    """Every gradient against jax.grad of the JAX package's scan, ragged
    and padded sub-chunks included."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as jrwkv
    args = _inputs(rng, 2, t, 2, 32, decays)
    dy, ds_last = (jnp.asarray(x) for x in args[6:])

    def loss(*ins):
        y, s = jrwkv._wkv_scan(*ins)
        return jnp.sum(y * dy) + jnp.sum(s * ds_last)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in args[:6]))
    got = tref.wkv6_chunked_heads_backward_ref(*_t(args))
    for name, g, jg in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == jg.shape, name
        assert float(g.abs().sum()) > 0, name
        assert _rel(g, torch.from_numpy(np.asarray(jg))) <= REL_L2, name


@pytest.mark.parametrize("t,h,hs", [(130, 3, 64), (47, 2, 16)])
def test_chunked_plain_backward_matches_autograd(t, h, hs, rng):
    """Against torch.autograd through the chunked forward's plain
    version, which differentiates the same blocking step by step."""
    args = _t(_inputs(rng, 2, t, h, hs, "strong"))
    ins = [x.clone().requires_grad_(True) for x in args[:6]]
    y, s = tref.wkv6_chunked_heads_ref(*ins)
    want = torch.autograd.grad((y, s), ins, (args[6], args[7]))
    got = tref.wkv6_chunked_heads_backward_ref(*args)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w) <= REL_L2, name


def test_chunked_plain_backward_finite_at_extreme_decays(rng):
    """w from 1e-6 to 1 with one in 16 set to 0: every gradient finite
    (no logarithm, exponential or division) and the recurrent plain
    backward's."""
    args = _t(_inputs(rng, 2, 150, 3, 64, "extreme"))
    got = tref.wkv6_chunked_heads_backward_ref(*args)
    want = tref.wkv6_heads_backward_ref(*args)
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_zero_decay_cuts_the_past_exactly(rng):
    """w = 0 at step 70 of every channel: after it, the gradients are
    those of a run that starts at step 70 from a zero state; before it,
    those of a run that stops at step 69 with ∂L/∂S_69 = r_70ᵀ dy_70 (the
    only way S_69 reaches the loss once w_70 is 0)."""
    r, k, v, w, u, s0, dy, ds_last = _t(_inputs(rng, 1, 150, 2, 64,
                                                  "strong"))
    w[:, 70] = 0.0
    got = tref.wkv6_chunked_heads_backward_ref(r, k, v, w, u, s0, dy,
                                               ds_last)
    tail = tref.wkv6_heads_backward_ref(
        *(x[:, 70:] for x in (r, k, v, w)), u, torch.zeros_like(s0),
        dy[:, 70:], ds_last)
    for name, g, want in zip(NAMES[:4], got, tail):
        torch.testing.assert_close(g[:, 71:], want[:, 1:], rtol=1e-4,
                                   atol=1e-4, msg=name)
    carry = r[:, 70, :, :, None] * dy[:, 70, :, None, :]
    head = tref.wkv6_heads_backward_ref(
        *(x[:, :70] for x in (r, k, v, w)), u, s0, dy[:, :70], carry)
    for name, g, want in zip(NAMES[:4], got, head):
        torch.testing.assert_close(g[:, :70], want, rtol=1e-4, atol=1e-4,
                                   msg=name)
    torch.testing.assert_close(got[5], head[5], rtol=1e-4, atol=1e-4)


# -- bf16, and the planted faults --------------------------------------------


@pytest.mark.parametrize("t,decays", [(200, "model"), (130, "extreme"),
                                      (128, "strong")])
def test_chunked_plain_backward_bf16_within_limits(t, decays, rng):
    """bf16 inputs: every product from bf16 operands (a high part and a
    remainder), sums in f32.  Each gradient within WKV_BWD_REL_L2 of the
    recurrent plain backward (read: about 1e-4 for dr, dk, dv, dw, 2e-6
    for ds0)."""
    args = _t(_inputs(rng, 2, t, 3, 64, decays), torch.bfloat16)
    got = tref.wkv6_chunked_heads_backward_ref(*args)
    want = tref.wkv6_heads_backward_ref(*args)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    rels = _rels(got, want)
    assert _within(rels, torch.bfloat16), rels


def _block_no_u_dk(r, k, w, u, da):
    """A planted fault: the diagonal block's gradient without dk's u
    term."""
    dr, dk, dw = _BLOCK_BACKWARD(r, k, w, u, da)
    dtt = torch.diagonal(da, dim1=-2, dim2=-1)[..., None] * u[..., None, :]
    return dr, dk - dtt * r, dw


def _block_w_next(r, k, w, u, da):
    """A planted fault: the diagonal block's gradient carrying X past
    w_{t+1} in place of w_t (the last step keeps its own)."""
    w_next = torch.cat([w[..., 1:, :], w[..., -1:, :]], -2)
    sub = r.shape[-2]
    x = [torch.zeros_like(r[..., 0, :]) for _ in range(sub)]
    dr, dk, dw = [], [], []
    for t in range(sub):
        dtt = da[..., t, t, None] * u
        dr.append(x[t] + dtt * k[..., t, :])
        pp, h, dkd = (torch.ones_like(r[..., 0, :]),
                      torch.zeros_like(r[..., 0, :]),
                      torch.zeros_like(r[..., 0, :]))
        for q in range(t + 1, sub):
            rp = r[..., q, :] * pp
            h = h + x[q] * rp
            dkd = dkd + da[..., q, t, None] * rp
            pp = pp * w[..., q, :]
        dk.append(dkd + dtt * r[..., t, :])
        dw.append(h)
        for q in range(t + 1, sub):
            x[q] = (w_next[..., t, :] * x[q]
                    + da[..., q, t, None] * k[..., t, :])
    return torch.stack(dr, -2), torch.stack(dk, -2), torch.stack(dw, -2)


_BLOCK_BACKWARD = tref.wkv6_diag_block_backward


@pytest.mark.parametrize("fault", ["no_u_dk", "w_next"])
@pytest.mark.parametrize("decays", ["model", "strong"])
def test_planted_faults_fail_the_limits(fault, decays, rng, monkeypatch):
    """Each fault, in the chunked plain backward, must fail the limits
    the right one passes (read on these inputs: dk 0.17-0.34 relative L2
    without u; dr 0.08-0.18 and dw 0.05-0.17 with w_{t+1})."""
    args = _t(_inputs(rng, 2, 256, 3, 64, decays), torch.bfloat16)
    want = tref.wkv6_heads_backward_ref(*args)
    assert _within(_rels(tref.wkv6_chunked_heads_backward_ref(*args),
                         want), torch.bfloat16)
    monkeypatch.setattr(tref, "wkv6_diag_block_backward",
                        {"no_u_dk": _block_no_u_dk,
                         "w_next": _block_w_next}[fault])
    rels = _rels(tref.wkv6_chunked_heads_backward_ref(*args), want)
    assert not _within(rels, torch.bfloat16), rels


# -- the route and the CPU ---------------------------------------------------


@pytest.mark.parametrize("dtype,t,hs,want", [
    (torch.bfloat16, 1024, 64, "chunked"),
    (torch.bfloat16, 128, 64, "chunked"),
    (torch.bfloat16, 130, 64, "chunked"),
    (torch.bfloat16, 127, 64, "recurrent"),
    (torch.float32, 1024, 64, "recurrent"),
    (torch.bfloat16, 1024, 32, "recurrent"),
    (torch.float32, 77, 64, "recurrent"),
])
def test_backward_takes_the_forwards_route(dtype, t, hs, want, rng,
                                           monkeypatch):
    """With the device rule bypassed and every launcher replaced by a
    recorder, ``wkv6_train``'s backward calls the chunked launcher only
    for bf16 at hs 64 and T >= 128, as its forward."""
    calls = []

    def forward(r, k, v, w, u, s0, s_out, path=None):
        calls.append("forward_" + twkv.route(r.dtype, r.shape[1],
                                             r.shape[3]))
        y, s = tref.wkv6_heads_ref(r, k, v, w, u, s0)
        s_out.copy_(s)
        return y

    def backward(name):
        def run(*args):
            calls.append(name)
            return tref.wkv6_heads_backward_ref(*args)
        return run

    monkeypatch.setattr(twkv, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(twkv, "_launch", forward)
    monkeypatch.setattr(twkv, "_launch_backward", backward("recurrent"))
    monkeypatch.setattr(twkv, "_launch_backward_chunked",
                        backward("chunked"))
    args = _t(_inputs(rng, 1, t, 1, hs), dtype)
    ins = [x.clone().requires_grad_(True) for x in args[:6]]
    y, s = twkv.wkv6_train(*ins)
    torch.autograd.grad((y, s), ins, (args[6], args[7]))
    assert calls == ["forward_" + want, want]


def test_cpu_tensors_launch_nothing_and_keep_the_recurrent_bits(rng):
    """On the CPU a chunked-route input runs the recurrent plain versions,
    forward and backward, bit for bit, and launches nothing."""
    args = _t(_inputs(rng, 2, 130, 2, 64), torch.bfloat16)
    assert twkv.route(args[0].dtype, 130, 64) == "chunked"
    twkv.reset_launch_counts()
    ins = [x.clone().requires_grad_(True) for x in args[:6]]
    y, s = twkv.wkv6_train(*ins)
    got = torch.autograd.grad((y, s), ins, (args[6], args[7]))
    for g, want in zip(got, tref.wkv6_heads_backward_ref(*args)):
        assert g.dtype == want.dtype and torch.equal(g, want)
    assert all(n == 0 for n in twkv.launch_counts.values())
    assert set(twkv.launch_counts) >= {"wkv6_backward",
                                       "wkv6_backward_recurrent",
                                       "wkv6_backward_chunked"}


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _one_bf16_step(got, want) -> bool:
    """|Δ| within one bf16 step of max(|want|, rms(want) / 32)."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    return bool(((g - w).abs() <= 2.0 ** -7 * torch.clamp(
        w.abs(), min=rms / 32)).all())


def _check_card(args, got):
    """The kernel's six gradients against both plain versions."""
    want = tref.wkv6_chunked_heads_backward_ref(*args)
    rec = tref.wkv6_heads_backward_ref(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        if name in ("du", "ds0"):
            assert _rel(g, w) <= 1e-5, name
        else:
            assert _one_bf16_step(g, w), name
    rels = _rels(got, rec)
    assert _within(rels, torch.bfloat16), rels


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,decays", [(2, 256, 4, "model"),
                                          (1, 128, 2, "strong"),
                                          (1, 777, 2, "model"),
                                          (2, 300, 3, "extreme")])
def test_cuda_chunked_backward_matches_both_plain_versions(b, t, h, decays,
                                                           rng, cuda):
    args = _t(_inputs(rng, b, t, h, 64, decays), torch.bfloat16, cuda)
    before = dict(twkv.launch_counts)
    got = twkv._launch_backward_chunked(*args)
    again = twkv._launch_backward_chunked(*args)
    torch.cuda.synchronize()
    assert twkv.launch_counts["wkv6_backward_chunked"] == \
        before["wkv6_backward_chunked"] + 2
    assert twkv.launch_counts["wkv6_backward_recurrent"] == \
        before["wkv6_backward_recurrent"]
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _check_card(args, got)


@pytest.mark.cuda
def test_cuda_wkv6_train_launches_the_chunked_backward(rng, cuda):
    """wkv6_train on a chunked-route input: the chunked forward once, the
    chunked backward once, the recurrent kernels never.  Autograd runs
    the backward on a thread of its own, where the launch is the first
    CUDA call: the launcher must make the context current there before it
    encodes its tensor maps."""
    args = _t(_inputs(rng, 2, 200, 3, 64), torch.bfloat16, cuda)
    ins = [x.clone().requires_grad_(True) for x in args[:6]]
    twkv.reset_launch_counts()
    y, s = twkv.wkv6_train(*ins)
    got = torch.autograd.grad((y, s), ins, (args[6], args[7]))
    torch.cuda.synchronize()
    assert twkv.launch_counts == {
        "wkv6": 1, "wkv6_recurrent": 0, "wkv6_chunked": 1,
        "wkv6_backward": 1, "wkv6_backward_recurrent": 0,
        "wkv6_backward_chunked": 1}
    _check_card(args, got)


@pytest.mark.cuda
def test_cuda_recurrent_backward_still_exact_at_a_chunked_shape(rng, cuda):
    """The recurrent backward kernel through its own launcher, at an
    input the route sends to the chunked one: bit for bit with its plain
    version."""
    args = _t(_inputs(rng, 1, 256, 2, 64), torch.bfloat16, cuda)
    assert twkv.route(args[0].dtype, 256, 64) == "chunked"
    got = twkv._launch_backward(*args)
    want = tref.wkv6_heads_backward_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_chunked_launchers_from_a_fresh_thread(rng, cuda):
    """Both chunked launchers as the first CUDA call of a new thread (as
    autograd's backward thread, or a recompute there): each makes the
    context current before it encodes its tensor maps."""
    import threading
    args = _t(_inputs(rng, 1, 256, 2, 64), torch.bfloat16, cuda)
    errors = []

    def run(fn):
        def body():
            try:
                fn()
                torch.cuda.synchronize()
            except Exception as exc:  # reported below, in the test's thread
                errors.append(repr(exc))
        th = threading.Thread(target=body)
        th.start()
        th.join()

    state = args[5].clone()
    run(lambda: twkv.wkv6_heads(*args[:5], state))
    got = []
    run(lambda: got.append(twkv._launch_backward_chunked(*args)))
    assert not errors, errors
    _, want_s = tref.wkv6_chunked_heads_ref(*args[:6])
    assert float((state - want_s).norm() / want_s.norm()) <= 1e-5
    _check_card(args, got[0])
