"""The port's WKV6 recurrence vs the JAX package's kernel and scans.

On the CPU the wrappers run the plain torch version (``ref.wkv6_ref``,
``ref.wkv6_heads_ref``); it is held against the JAX package's Pallas
``wkv6`` in interpret mode (with that kernel's own ``chunk``), its
``wkv6_ref`` and the model's ``rwkv._wkv_scan``, on the shapes of
``tests/test_wkv6_kernel.py`` and with its tolerances: atol 1e-4 against
the kernel and ``wkv6_ref``, 2e-4 against ``_wkv_scan`` (summation order;
y and the state are O(1) there).

The tests marked ``cuda`` hold the hand-written CUDA kernel against the
plain version on the card, bit for bit: the plain version repeats the
kernel's order of operations.  They skip without a card and need no jax
(on the card: ``python -m pytest -q -m cuda tests/test_torch_wkv6.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv6 as twkv  # noqa: E402

# (BH, T, hs, the Pallas kernel's chunk), as tests/test_wkv6_kernel.py
SHAPES = [(4, 128, 16, 32), (2, 64, 32, 64), (3, 96, 8, 16),
          (1, 200, 16, 50)]


def _inputs(rng, bh, t, hs):
    """r, k, v, w (BH, T, hs), u (hs,), s0 (BH, hs, hs), float32 numpy,
    drawn as tests/test_wkv6_kernel.py draws them."""
    r, k, v = (rng.standard_normal((bh, t, hs)).astype(np.float32)
               for _ in range(3))
    w = (rng.random((bh, t, hs)) * 0.5 + 0.4).astype(np.float32)
    u = rng.standard_normal(hs).astype(np.float32)
    s0 = (rng.standard_normal((bh, hs, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _heads(rng, b, t, h, hs):
    """Model layout: r, k, v, w (B, T, H, hs), u (H, hs), s0 (B, H, hs,
    hs), with per-head nonzero u and a nonzero s0."""
    r, k, v = (rng.standard_normal((b, t, h, hs)).astype(np.float32)
               for _ in range(3))
    w = (rng.random((b, t, h, hs)) * 0.5 + 0.4).astype(np.float32)
    u = rng.standard_normal((h, hs)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hs, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _t(arrs, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrs]


def _np(t):
    return t.float().cpu().numpy()


def _jax():
    jax = pytest.importorskip("jax")
    from repro.kernels import wkv6 as jwkv
    from repro.models import rwkv as jrwkv
    return jax.numpy, jwkv, jrwkv


@pytest.mark.parametrize("bh,t,hs,chunk", SHAPES)
def test_wkv6_matches_reference_kernel(bh, t, hs, chunk, rng):
    jnp, jwkv, _ = _jax()
    arrs = _inputs(rng, bh, t, hs)
    ja = [jnp.asarray(a) for a in arrs]
    y, s = twkv.wkv6(*_t(arrs))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for want_y, want_s in (jwkv.wkv6(*ja, chunk=chunk), jwkv.wkv6_ref(*ja)):
        np.testing.assert_allclose(_np(y), np.asarray(want_y), atol=1e-4)
        np.testing.assert_allclose(_np(s), np.asarray(want_s), atol=1e-4)


def test_wkv6_heads_matches_model_scan(rng):
    """Per-head u, the model's layout: the JAX model's ``_wkv_scan`` in
    f32, which the port's ``ops.wkv6`` replaces."""
    jnp, _, jrwkv = _jax()
    arrs = _heads(rng, 2, 64, 3, 16)
    y_j, s_j = jrwkv._wkv_scan(*(jnp.asarray(a) for a in arrs))
    r, k, v, w, u, s0 = _t(arrs)
    state = s0.clone()
    y = tops.wkv6(r, k, v, w, u, state)
    np.testing.assert_allclose(_np(y), np.asarray(y_j), atol=2e-4)
    np.testing.assert_allclose(_np(state), np.asarray(s_j), atol=2e-4)


def test_wkv6_heads_is_the_shared_u_kernel_per_head(rng):
    """H heads with their own u equal H calls of the JAX-layout wrapper,
    head by head (the form tests/test_wkv6_kernel.py checks)."""
    r, k, v, w, u, s0 = _t(_heads(rng, 2, 40, 3, 8))
    state = s0.clone()
    y = twkv.wkv6_heads(r, k, v, w, u, state)
    for h in range(3):
        yh, sh = twkv.wkv6(r[:, :, h], k[:, :, h], v[:, :, h], w[:, :, h],
                           u[h], s0[:, h])
        torch.testing.assert_close(y[:, :, h], yh, rtol=0, atol=0)
        torch.testing.assert_close(state[:, h], sh, rtol=0, atol=0)


@pytest.mark.parametrize("bh,t,hs,chunk", SHAPES[:2])
def test_wkv6_bf16_inputs_match_reference(bh, t, hs, chunk, rng):
    """bf16 r, k, v, w, u and s0 into both: each upcasts to f32, keeps
    the state in f32, and rounds y once to bf16 (so 2⁻⁸ relative)."""
    jnp, jwkv, _ = _jax()
    arrs = _inputs(rng, bh, t, hs)
    y, s = twkv.wkv6(*_t(arrs, torch.bfloat16))
    want_y, want_s = jwkv.wkv6_ref(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in arrs))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(want_y, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(s), np.asarray(want_s), atol=1e-4)


def test_wkv6_one_step_from_a_nonzero_state(rng):
    """T = 1, the decode step: y = r (s0 + u ⊙ kᵀv), S = diag(w) s0 + kᵀv,
    written out by hand, and ``wkv6_heads`` updates the state in place."""
    jnp, jwkv, _ = _jax()
    arrs = _inputs(rng, 3, 1, 16)
    r, k, v, w, u, s0 = arrs
    a = k[:, 0, :, None] * v[:, 0, None, :]
    want_y = np.einsum("bk,bkv->bv", r[:, 0], s0 + u[None, :, None] * a)
    want_s = w[:, 0, :, None] * s0 + a
    y, s = twkv.wkv6(*_t(arrs))
    np.testing.assert_allclose(_np(y)[:, 0], want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), want_s, rtol=1e-6, atol=1e-6)
    jy, js = jwkv.wkv6(*(jnp.asarray(x) for x in arrs), chunk=1)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-5)
    state = torch.from_numpy(s0.copy())[:, None]
    tr, tk, tv, tw = (torch.from_numpy(x)[:, :, None] for x in arrs[:4])
    twkv.wkv6_heads(tr, tk, tv, tw, torch.from_numpy(u)[None], state)
    np.testing.assert_array_equal(_np(state)[:, 0], _np(s))


def test_wkv6_leaves_s0_alone_and_checks_shapes(rng):
    r, k, v, w, u, s0 = _t(_inputs(rng, 2, 8, 8))
    before = s0.clone()
    twkv.wkv6(r, k, v, w, u, s0)
    assert torch.equal(s0, before)
    with pytest.raises(ValueError, match="u must be"):
        twkv.wkv6_heads(*(x[:, :, None] for x in (r, k, v, w)),
                        u[None, :4], s0[:, None])
    with pytest.raises(ValueError, match="the state must be"):
        twkv.wkv6_heads(*(x[:, :, None] for x in (r, k, v, w)), u[None],
                        s0[:1, None])
    with pytest.raises(ValueError, match="k must have"):
        twkv.wkv6(r, k[:, :4], v, w, u, s0)


def test_wkv6_on_cpu_never_launches(rng):
    twkv.reset_launch_counts()
    twkv.wkv6(*_t(_inputs(rng, 2, 8, 8)))
    assert twkv.launch_counts["wkv6"] == 0


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hs", [(2, 100, 3, 16), (1, 70, 2, 64),
                                      (2, 33, 1, 128), (3, 1, 4, 64),
                                      (1, 40, 2, 24)])
def test_cuda_wkv6_matches_plain(dtype, b, t, h, hs, rng, cuda):
    r, k, v, w, u, s0 = _t(_heads(rng, b, t, h, hs), dtype, cuda)
    s0 = s0.float()
    before = twkv.launch_counts["wkv6"]
    state = s0.clone()
    y = twkv.wkv6_heads(r, k, v, w, u, state)
    want_y, want_s = tref.wkv6_heads_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert twkv.launch_counts["wkv6"] == before + 1
    assert y.dtype == dtype and y.shape == r.shape
    np.testing.assert_array_equal(_np(y), _np(want_y))
    np.testing.assert_array_equal(_np(state), _np(want_s))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,t,hs,chunk", SHAPES)
def test_cuda_wkv6_jax_layout_matches_plain(bh, t, hs, chunk, rng, cuda):
    arrs = _t(_inputs(rng, bh, t, hs), device=cuda)
    y, s = twkv.wkv6(*arrs)
    want_y, want_s = tref.wkv6_ref(*arrs)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_np(y), _np(want_y))
    np.testing.assert_array_equal(_np(s), _np(want_s))


@pytest.mark.cuda
def test_cuda_wkv6_strided_inputs(rng, cuda):
    """r, k, v, w as slices of one (B, T, 4, H, hs) buffer: read through
    their strides without a copy."""
    buf = torch.from_numpy(rng.standard_normal((2, 50, 4, 3, 32))
                           .astype(np.float32)).to(cuda)
    r, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    w = torch.sigmoid(buf[:, :, 3])
    u = torch.randn(3, 32, device=cuda)
    state = torch.zeros(2, 3, 32, 32, device=cuda)
    y = twkv.wkv6_heads(r, k, v, w, u, state)
    want_y, want_s = tref.wkv6_heads_ref(r, k, v, w, u,
                                         torch.zeros_like(state))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_np(y), _np(want_y))
    np.testing.assert_array_equal(_np(state), _np(want_s))


@pytest.mark.cuda
def test_cuda_wkv6_refuses_what_it_does_not_take(rng, cuda):
    r, k, v, w, u, s0 = _t(_heads(rng, 1, 4, 1, 160), device=cuda)
    with pytest.raises(ValueError, match="head size 160"):
        twkv.wkv6_heads(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = _t(_heads(rng, 1, 4, 2, 16), device=cuda)
    with pytest.raises(TypeError, match="CUDA kernel takes"):
        twkv.wkv6_heads(r.half(), k.half(), v.half(), w.half(), u, s0)
    with pytest.raises(TypeError, match="s0 must be"):
        twkv.wkv6_heads(r, k, v, w, u, s0.double())
