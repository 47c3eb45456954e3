"""WKV6's chunked form: the route, its plain version, its CUDA kernel.

``wkv6.route(dtype, t, hs)`` sends bf16 at head size 64 and T >= 128 (the
rwkv6-1.6b prefill) to the chunked kernel (``csrc/wkv6_chunked.cu``) and
everything else to the recurrent one (``csrc/wkv6.cu``).  On the CPU both
wrappers run the recurrent plain version whatever the route.

The chunked plain version, ``ref.wkv6_chunked_heads_ref``, computes the
kernel's algebra in its blocking.  In f32 it rounds nothing, so it is held
to the JAX package's ``wkv6_ref`` and its Pallas ``wkv6`` in interpret
mode (with that kernel's own ``chunk``) at ``tests/test_wkv6_kernel.py``'s
atol 1e-4, and to the port's recurrent plain version.  In bf16 it forms
every product from bf16 operands as the kernel does, so against the
recurrence it is held to the bf16 limits of ``chip_smoke.py``'s WKV6
checks (elementwise |Δ| <= 1e-2·(|plain| + rms(plain)) and relative L2
<= 1e-2, y and the state alike), which three planted faults must fail.

The tests marked ``cuda`` hold the chunked kernel against both plain
versions on the card, as ``chip_smoke.py``'s ``wkv6_chunked_vs_plain``
does: against the chunked plain version y within one bf16 step and the
state within 1e-5 relative L2 (only the order of the sums inside the
matrix products differs); against the recurrent one the bf16 limits.
They skip without a card and need no jax (on the card: ``python -m
pytest -q -m cuda tests/test_torch_wkv6_chunked.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv6 as twkv  # noqa: E402

BF16_TOL = 1e-2      # chip_smoke.WKV_TOL["bfloat16"], WKV_REL_L2["bfloat16"]
# (BH, T, hs, the Pallas kernel's chunk), as tests/test_wkv6_kernel.py
SHAPES = [(4, 128, 16, 32), (2, 64, 32, 64), (3, 96, 8, 16),
          (1, 200, 16, 50)]


def _heads(rng, b, t, h, hs, decays="model"):
    """Model layout, float32 numpy: r, k, v ~ N(0, 1) (B, T, H, hs); w by
    ``decays``: "model" exp(-exp(U(-6, -1))), rwkv6's init range (0.9975
    down to 0.69); "strong" U(0.4, 0.9), as tests/test_wkv6_kernel.py;
    "extreme" 10^U(-6, 0) with one w in 16 set to 0; u (H, hs) ~ N(0,
    0.25); s0 (B, H, hs, hs) ~ N(0, 0.01)."""
    r, k, v = (rng.standard_normal((b, t, h, hs)).astype(np.float32)
               for _ in range(3))
    x = rng.random((b, t, h, hs))
    if decays == "model":
        w = np.exp(-np.exp(x * 5 - 6))
    elif decays == "strong":
        w = x * 0.5 + 0.4
    else:
        w = np.where(rng.random((b, t, h, hs)) < 1 / 16, 0.0, 10 ** (-6 * x))
    u = rng.standard_normal((h, hs)) * 0.5
    s0 = rng.standard_normal((b, h, hs, hs)) * 0.1
    return [r, k, v, w.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32)]


def _t(arrs, dtype=torch.float32, device="cpu"):
    """r, k, v, w, u in ``dtype``; s0 stays f32."""
    out = [torch.from_numpy(a).to(device=device, dtype=dtype)
           for a in arrs[:5]]
    return out + [torch.from_numpy(arrs[5]).to(device)]


def _bf16_limits(got, want):
    """(worst elementwise |Δ| / (|want| + rms(want)), relative L2)."""
    g, w = got.float(), want.float()
    rms = w.square().mean().sqrt()
    return (float(((g - w).abs() / (w.abs() + rms)).max()),
            float((g - w).norm() / w.norm()))


def _within_bf16_limits(got, want) -> bool:
    elem, rel = _bf16_limits(got, want)
    return bool(torch.isfinite(got).all()) and elem <= BF16_TOL and \
        rel <= BF16_TOL


# -- the route ---------------------------------------------------------------


@pytest.mark.parametrize("dtype,t,hs,want", [
    (torch.bfloat16, 1024, 64, "chunked"),
    (torch.bfloat16, 128, 64, "chunked"),
    (torch.bfloat16, 777, 64, "chunked"),
    (torch.bfloat16, 127, 64, "recurrent"),
    (torch.bfloat16, 1, 64, "recurrent"),
    (torch.float32, 1024, 64, "recurrent"),
    (torch.float16, 1024, 64, "recurrent"),
    (torch.bfloat16, 1024, 32, "recurrent"),
    (torch.bfloat16, 1024, 128, "recurrent"),
])
def test_route_picks_chunked_only_for_bf16_hs64_long_prompts(dtype, t, hs,
                                                             want):
    assert twkv.route(dtype, t, hs) == want


# every input of the card tests and smoke cases written for the recurrent
# kernel: tests/test_torch_wkv6.py (dtype, T, hs), its JAX-layout shapes,
# its strided and refused inputs, and a decode step
EXISTING = ([(dt, t, hs) for dt in (torch.float32, torch.bfloat16)
             for t, hs in ((100, 16), (70, 64), (33, 128), (1, 64),
                           (40, 24))]
            + [(torch.float32, t, hs) for _, t, hs, _ in SHAPES]
            + [(torch.float32, 50, 32), (torch.float32, 4, 160),
               (torch.float16, 4, 16), (torch.bfloat16, 1, 64),
               (torch.float32, 1024, 64)])


@pytest.mark.parametrize("dtype,t,hs", EXISTING)
def test_route_keeps_existing_inputs_on_the_recurrent_kernel(dtype, t, hs):
    assert twkv.route(dtype, t, hs) == "recurrent"


# -- the chunked plain version -----------------------------------------------


def _jax():
    jax = pytest.importorskip("jax")
    from repro.kernels import wkv6 as jwkv
    return jax.numpy, jwkv


@pytest.mark.parametrize("bh,t,hs,chunk", SHAPES)
def test_chunked_plain_matches_reference_kernel_f32(bh, t, hs, chunk, rng):
    """f32, the JAX layout (H = 1, one u): the chunked algebra against the
    JAX package's scan and its Pallas kernel, at that file's atol."""
    jnp, jwkv = _jax()
    r, k, v, w, u, s0 = _heads(rng, bh, t, 1, hs, "strong")
    jax_args = [jnp.asarray(x[:, :, 0]) for x in (r, k, v, w)]
    jax_args += [jnp.asarray(u[0]), jnp.asarray(s0[:, 0])]
    y, s = tref.wkv6_chunked_heads_ref(*_t([r, k, v, w, u, s0]))
    for want_y, want_s in (jwkv.wkv6(*jax_args, chunk=chunk),
                           jwkv.wkv6_ref(*jax_args)):
        np.testing.assert_allclose(y[:, :, 0].numpy(), np.asarray(want_y),
                                   atol=1e-4)
        np.testing.assert_allclose(s[:, 0].numpy(), np.asarray(want_s),
                                   atol=1e-4)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 128, 200])
@pytest.mark.parametrize("decays", ["model", "strong", "extreme"])
def test_chunked_plain_matches_recurrence_f32(t, decays, rng):
    """rwkv6's head size, a few heads, per-head u and a nonzero s0: the
    chunked form against the recurrent plain version in f32, where only
    the order of the sums differs."""
    args = _t(_heads(rng, 2, t, 3, 64, decays))
    y, s = tref.wkv6_chunked_heads_ref(*args)
    want_y, want_s = tref.wkv6_heads_ref(*args)
    assert y.dtype == torch.float32 and y.shape == args[0].shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)


def test_zero_decay_cuts_the_past_exactly(rng):
    """w = 0 at step 70 of every channel: from step 71 on, y and the state
    are those of a run that starts there from a zero state (exact zeros,
    no NaN from a logarithm)."""
    r, k, v, w, u, s0 = _t(_heads(rng, 1, 150, 2, 64, "strong"))
    w[:, 70] = 0.0
    y, s = tref.wkv6_chunked_heads_ref(r, k, v, w, u, s0)
    tail = [x[:, 70:] for x in (r, k, v, w)]
    # step 70 itself only adds k_70ᵀv_70 to a zeroed state
    y_tail, s_tail = tref.wkv6_heads_ref(*tail, u, torch.zeros_like(s0))
    torch.testing.assert_close(y[:, 71:], y_tail[:, 1:], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s, s_tail, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,decays", [(200, "model"), (130, "extreme"),
                                      (128, "strong")])
def test_chunked_plain_bf16_within_bf16_limits(t, decays, rng):
    """bf16 inputs: every product from bf16 operands (high part and
    remainder), sums in f32.  y and the state within the bf16 limits of
    the recurrence (read: about 1e-4 relative L2 for y, 2e-6 for the
    state)."""
    args = _t(_heads(rng, 2, t, 3, 64, decays), torch.bfloat16)
    y, s = tref.wkv6_chunked_heads_ref(*args)
    want_y, want_s = tref.wkv6_heads_ref(*args)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert _within_bf16_limits(y, want_y), _bf16_limits(y, want_y)
    assert _within_bf16_limits(s, want_s), _bf16_limits(s, want_s)


def _diag_reads_c_i(r, k, w, u):
    """A planted fault: the diagonal blocks decay by e^{c_i − c_j}, one w
    too many (w_i multiplied in before row i reads k_j)."""
    sub = r.shape[-2]
    a = r.new_zeros(r.shape[:-1] + (sub,))
    kd = k.clone()
    for i in range(sub):
        kd[..., :i, :] *= w[..., i, None, :]
        a[..., i, :i] = (r[..., i, None, :] * kd[..., :i, :]).sum(-1)
        a[..., i, i] = (r[..., i, :] * u * k[..., i, :]).sum(-1)
    return a


@pytest.mark.parametrize("fault", ["u dropped", "last decay skipped",
                                   "diagonal reads c_i"])
def test_planted_faults_fail_the_bf16_limits(fault, rng, monkeypatch):
    """Each fault, in the chunked plain version, must fail the limits the
    correct version passes (on model-like decays: y 7.8e-2 relative L2
    for the diagonal fault)."""
    r, k, v, w, u, s0 = _t(_heads(rng, 2, 256, 3, 64), torch.bfloat16)
    want_y, want_s = tref.wkv6_heads_ref(r, k, v, w, u, s0)
    if fault == "u dropped":
        u = torch.zeros_like(u)
    elif fault == "last decay skipped":
        w = w.clone()
        w[:, -1] = 1.0
    else:
        monkeypatch.setattr(tref, "wkv6_diag_block", _diag_reads_c_i)
    y, s = tref.wkv6_chunked_heads_ref(r, k, v, w, u, s0)
    got, want = (s, want_s) if fault == "last decay skipped" else (y, want_y)
    assert not _within_bf16_limits(got, want), _bf16_limits(got, want)


def test_diag_block_matches_pairwise_decay(rng):
    """The diagonal block against its definition, one (i, j) at a time."""
    r, k, w = (torch.from_numpy(rng.random((2, 16, 8)).astype(np.float32))
               for _ in range(3))
    u = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    a = tref.wkv6_diag_block(r, k, w, u)
    for i in range(16):
        for j in range(16):
            if j < i:
                want = (r[:, i] * k[:, j] * w[:, j + 1:i].prod(1)).sum(-1)
            elif j == i:
                want = (r[:, i] * u * k[:, i]).sum(-1)
            else:
                want = torch.zeros(2)
            torch.testing.assert_close(a[:, i, j], want, rtol=1e-6,
                                       atol=1e-6)


def test_cpu_tensors_never_launch_and_run_the_recurrence(rng):
    """On the CPU a chunked-route input runs the recurrent plain version,
    bit for bit, and launches neither kernel."""
    r, k, v, w, u, s0 = _t(_heads(rng, 1, 130, 2, 64), torch.bfloat16)
    assert twkv.route(r.dtype, 130, 64) == "chunked"
    twkv.reset_launch_counts()
    state = s0.clone()
    y = twkv.wkv6_heads(r, k, v, w, u, state)
    want_y, want_s = tref.wkv6_heads_ref(r, k, v, w, u, s0)
    assert torch.equal(y, want_y) and torch.equal(state, want_s)
    y1, s1 = twkv.wkv6(r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], u[0],
                       s0[:, 0])
    want_y1, want_s1 = tref.wkv6_ref(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                                     w[:, :, 0], u[0], s0[:, 0])
    assert torch.equal(y1, want_y1) and torch.equal(s1, want_s1)
    assert twkv.launch_counts == {"wkv6": 0, "wkv6_recurrent": 0,
                                  "wkv6_chunked": 0, "wkv6_backward": 0,
                                  "wkv6_backward_recurrent": 0,
                                  "wkv6_backward_chunked": 0}


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _one_bf16_step(got, want) -> bool:
    """|Δ| within one bf16 step of max(|want|, rms(want) / 32): the two
    round f32 sums that differ only in order to bf16."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    return bool(((g - w).abs() <= 2.0 ** -7 * torch.clamp(
        w.abs(), min=rms / 32)).all())


def _check_card(args, state, y):
    """The kernel's y and final state against both plain versions."""
    r, k, v, w, u, s0 = args
    want_y, want_s = tref.wkv6_chunked_heads_ref(r, k, v, w, u, s0)
    rec_y, rec_s = tref.wkv6_heads_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == r.shape
    assert _one_bf16_step(y, want_y)
    assert float((state - want_s).norm() / want_s.norm()) <= 1e-5
    assert _within_bf16_limits(y, rec_y), _bf16_limits(y, rec_y)
    assert _within_bf16_limits(state, rec_s), _bf16_limits(state, rec_s)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,decays", [(2, 256, 4, "model"),
                                          (1, 128, 2, "strong"),
                                          (1, 777, 2, "model"),
                                          (2, 300, 3, "extreme")])
def test_cuda_chunked_matches_both_plain_versions(b, t, h, decays, rng,
                                                  cuda):
    args = _t(_heads(rng, b, t, h, 64, decays), torch.bfloat16, cuda)
    before = dict(twkv.launch_counts)
    state = args[5].clone()
    y = twkv.wkv6_heads(*args[:5], state)
    assert twkv.launch_counts["wkv6_chunked"] == before["wkv6_chunked"] + 1
    assert twkv.launch_counts["wkv6"] == before["wkv6"] + 1
    assert twkv.launch_counts["wkv6_recurrent"] == before["wkv6_recurrent"]
    _check_card(args, state, y)


@pytest.mark.cuda
def test_cuda_chunked_strided_inputs_and_decode_after(rng, cuda):
    """r, k, v, w as slices of one (B, T, 4, H, 64) buffer, the state
    updated in place, then one decode step on the recurrent kernel."""
    buf = torch.from_numpy(rng.standard_normal((2, 200, 4, 3, 64))
                           .astype(np.float32)).to(cuda, torch.bfloat16)
    r, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    w = torch.sigmoid(buf[:, :, 3].float() + 3).to(torch.bfloat16)
    u = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)
                         ).to(cuda)
    s0 = torch.from_numpy(rng.standard_normal((2, 3, 64, 64))
                          .astype(np.float32) * 0.1).to(cuda)
    state = s0.clone()
    y = twkv.wkv6_heads(r, k, v, w, u, state)
    _check_card([r, k, v, w, u, s0], state, y)
    one = [x[:, :1].contiguous() for x in (r, k, v, w)]
    before = state.clone()
    n_rec = twkv.launch_counts["wkv6_recurrent"]
    y1 = twkv.wkv6_heads(*one, u, state)
    want_y1, want_s1 = tref.wkv6_heads_ref(*one, u, before)
    torch.cuda.synchronize()
    assert twkv.launch_counts["wkv6_recurrent"] == n_rec + 1
    assert torch.equal(y1, want_y1) and torch.equal(state, want_s1)


@pytest.mark.cuda
def test_cuda_chunked_is_deterministic(rng, cuda):
    args = _t(_heads(rng, 2, 512, 4, 64), torch.bfloat16, cuda)
    outs = []
    for _ in range(2):
        state = args[5].clone()
        outs.append((twkv.wkv6_heads(*args[:5], state), state))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
def test_cuda_recurrent_kernel_still_exact_at_a_chunked_shape(rng, cuda):
    """The private launcher holds the recurrent kernel at an input the
    route sends to the chunked one: bit for bit with its plain version."""
    r, k, v, w, u, s0 = _t(_heads(rng, 1, 256, 2, 64), torch.bfloat16, cuda)
    state = s0.clone()
    y = twkv._launch(r, k, v, w, u, state, state, path="recurrent")
    want_y, want_s = tref.wkv6_heads_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(state, want_s)


@pytest.mark.cuda
def test_cuda_chunked_refuses_unaligned_rows(rng, cuda):
    buf = torch.zeros((1, 130, 2, 65), dtype=torch.bfloat16, device=cuda)
    r = buf[..., 1:]
    args = [r, r, r, r, torch.zeros(2, 64, device=cuda),
            torch.zeros(1, 2, 64, 64, device=cuda)]
    with pytest.raises(ValueError, match="16-byte"):
        twkv.wkv6_heads(*args)
