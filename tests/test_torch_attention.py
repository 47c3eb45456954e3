"""The port's attention vs the JAX package's flash kernel and reference.

On the CPU ``ops.attention`` runs the plain torch version (``mha_ref``,
or ``mha_chunked`` from S = 16384 on); it is held against both of the
JAX package's impls, the Pallas ``flash_attention`` in interpret mode and
``ref.mha_ref``, on the grid of ``tests/test_kernels.py``.
Tolerances as there: 2e-5 in float32 (summation order), 2e-2 in bfloat16
(the score and p roundings).

The ragged non-causal case (S = 100, tiles of 64) shows a fault of the
reference kernel: it pads S to 128 and leaves the padded keys unmasked
when not causal, so it differs from ``mha_ref``; the port (and its CUDA
kernel, which masks every key >= S) equals ``mha_ref``.

The tests marked ``cuda`` hold the hand-written CUDA kernels against the
plain version on the card; they skip without one and need no jax (on the
card: ``python -m pytest -q -m cuda tests/test_torch_attention.py``).
``route`` picks the kernel: bf16 at D 64, 128, 192 and 256 takes the
tensor-core kernel (``test_cuda_tensor_cores_*``, and
``test_cuda_flash_matches_plain``'s bf16 cases at those head dims), f32
and bf16 at the other head dims up to 256 the CUDA-core kernel
(``test_cuda_flash_matches_plain`` at D 16 and 32 and in f32,
``test_cuda_flash_strided_output_layout``); each card test asserts that
its route's launch count moved.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

MASKS = [(True, None), (False, None), (True, 64)]
# S a multiple of the Pallas kernel's 64-row tiles: at a ragged S its
# non-causal fault (above) would fail the comparison
SHAPES = [(2, 4, 2, 256, 64), (1, 2, 1, 128, 32), (1, 2, 1, 192, 256),
          (1, 3, 1, 128, 192)]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(rng, b, h, kv, s, d, dtype, s_kv=None):
    s_kv = s if s_kv is None else s_kv
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kv, s_kv, d)).astype(np.float32),
            rng.standard_normal((b, kv, s_kv, d)).astype(np.float32))


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DT[dtype])
            for a in arrs]


def _f32(t):
    return t.float().cpu().numpy()


def _jax():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jax.numpy, jops, jref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("b,h,kv,s,d", SHAPES)
def test_attention_matches_reference_kernel(dtype, causal, window, b, h,
                                            kv, s, d, rng):
    jnp, jops, _ = _jax()
    arrs = _qkv(rng, b, h, kv, s, d, dtype)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    o_ref = jops.attention(jq, jk, jv, causal=causal, window=window,
                           impl="ref")
    o_pal = jops.attention(jq, jk, jv, causal=causal, window=window,
                           impl="pallas", bq=64, bk=64)
    q, k, v = _torch(arrs, dtype)
    got = _f32(tops.attention(q, k, v, causal=causal, window=window))
    for want in (o_ref, o_pal):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_masks_padded_keys(causal, rng):
    """S = 100 with 64-row tiles: the reference kernel pads to 128.
    Non-causal, its padded keys attend (its fault); the port equals
    mha_ref either way."""
    jnp, jops, jref = _jax()
    arrs = _qkv(rng, 1, 2, 2, 100, 32, "float32")
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    want = np.asarray(jref.mha_ref(jq, jk, jv, causal=causal))
    pallas = np.asarray(jops.attention(jq, jk, jv, causal=causal,
                                       impl="pallas", bq=64, bk=64))
    got = _f32(tops.attention(*_torch(arrs, "float32"), causal=causal))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pallas_err = float(np.max(np.abs(pallas - want)))
    if causal:
        assert pallas_err < 2e-5
    else:
        assert pallas_err > 1e-2, pallas_err


@pytest.mark.parametrize("causal,window", MASKS)
def test_chunked_matches_exact(causal, window, rng):
    """mha_chunked == mha_ref (and == the JAX package's mha_chunked)."""
    jnp, _, jref = _jax()
    arrs = _qkv(rng, 1, 2, 2, 2048, 32, "float32")
    q, k, v = _torch(arrs, "float32")
    exact = _f32(tref.mha_ref(q, k, v, causal=causal, window=window))
    chunk = _f32(tref.mha_chunked(q, k, v, causal=causal, window=window,
                                  q_chunk=256))
    np.testing.assert_allclose(chunk, exact, rtol=2e-5, atol=2e-5)
    jchunk = np.asarray(jref.mha_chunked(
        *(jnp.asarray(a) for a in arrs), causal=causal, window=window,
        q_chunk=256))
    np.testing.assert_allclose(chunk, jchunk, rtol=2e-5, atol=2e-5)


def test_chunked_aligns_last_query_with_last_key(rng):
    """S < Skv: query i sits at key position i + Skv - S in every chunk."""
    arrs = _qkv(rng, 1, 2, 2, 512, 16, "float32", s_kv=640)
    q, k, v = _torch(arrs, "float32")
    np.testing.assert_allclose(
        _f32(tref.mha_chunked(q, k, v, q_chunk=128)),
        _f32(tref.mha_ref(q, k, v)), rtol=2e-5, atol=2e-5)


def test_decode_shape_takes_plain_path(rng):
    """S != Skv (a decode step) is not the kernel's shape: the plain
    path, as the JAX package's XLA path."""
    jnp, jops, _ = _jax()
    arrs = _qkv(rng, 2, 4, 2, 1, 16, "float32", s_kv=24)
    want = np.asarray(jops.attention(*(jnp.asarray(a) for a in arrs),
                                     causal=True, impl="pallas"))
    got = _f32(tops.attention(*_torch(arrs, "float32"), causal=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cpu_tensors_never_launch(rng):
    """CPU tensors of either route take the plain version: no count
    moves, the per-route counts included."""
    tfa.reset_launch_counts()
    for dtype, d in (("float32", 16), ("bfloat16", 64), ("bfloat16", 128)):
        q, k, v = _torch(_qkv(rng, 1, 4, 2, 64, d, dtype), dtype)
        tops.attention(q, k, v)
        tfa.flash_attention(q, k, v)
    assert set(tfa.launch_counts) == {"flash_attention",
                                      "flash_attention_tensor_cores",
                                      "flash_attention_cuda_cores"}
    assert all(n == 0 for n in tfa.launch_counts.values())


@pytest.mark.parametrize("dtype,d,want", [
    ("bfloat16", 64, "tensor_cores"), ("bfloat16", 128, "tensor_cores"),
    ("float32", 64, "cuda_cores"), ("float32", 128, "cuda_cores"),
    ("bfloat16", 32, "cuda_cores"), ("bfloat16", 16, "cuda_cores"),
    ("bfloat16", 192, "tensor_cores"), ("bfloat16", 256, "tensor_cores"),
    ("float32", 256, "cuda_cores"), ("bfloat16", 96, "cuda_cores"),
    ("float32", 192, "cuda_cores")])
def test_route_picks_kernel_by_dtype_and_head_dim(dtype, d, want):
    assert tfa.route(TORCH_DT[dtype], d) == want
    assert tfa.LIBRARIES[want].source.exists()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_rejects_head_dim_over_256(dtype):
    with pytest.raises(ValueError, match="head dim 257"):
        tfa.route(TORCH_DT[dtype], 257)
    with pytest.raises(TypeError):
        tfa.route(torch.float16, 64)


def test_gqa_reads_grouped_heads(rng):
    """Hkv | H: head h reads kv head h // (H / Hkv), the repeat's order."""
    q, k, v = _torch(_qkv(rng, 1, 6, 2, 40, 16, "float32"), "float32")
    rep = [t.repeat_interleave(3, dim=1) for t in (k, v)]
    np.testing.assert_array_equal(_f32(tops.attention(q, k, v)),
                                  _f32(tref.mha_ref(q, *rep)))


def test_bad_window_and_heads_raise(rng):
    q, k, v = _torch(_qkv(rng, 1, 4, 3, 16, 8, "float32"), "float32")
    with pytest.raises(ValueError, match="divide"):
        tops.attention(q, k, v)
    q, k, v = _torch(_qkv(rng, 1, 4, 2, 16, 8, "float32"), "float32")
    with pytest.raises(ValueError, match="window"):
        tops.attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, window=-1)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _check_card(q, k, v, dtype, causal, window):
    """One launch against the plain version; returns the route taken."""
    path = tfa.route(q.dtype, q.shape[-1])
    before = dict(tfa.launch_counts)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launch_counts["flash_attention"] == \
        before["flash_attention"] + 1
    key = "flash_attention_" + path
    assert tfa.launch_counts[key] == before[key] + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS + [(False, 40)])
@pytest.mark.parametrize("b,h,kv,s,d", SHAPES + [
    (1, 4, 4, 100, 64), (2, 4, 1, 200, 128), (1, 2, 2, 70, 16)])
def test_cuda_flash_matches_plain(dtype, causal, window, b, h, kv, s, d,
                                  rng, cuda):
    q, k, v = _torch(_qkv(rng, b, h, kv, s, d, dtype), dtype, cuda)
    _check_card(q, k, v, dtype, causal, window)


def _model_layout(t):
    """(B, H, S, D) values in (B, S, H, D) memory, as the model passes
    them: seen through transpose(1, 2), read through strides."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.cuda
def test_cuda_flash_strided_output_layout(rng, cuda):
    """The model's layout on the CUDA-core route (D 32)."""
    arrs = _qkv(rng, 2, 4, 2, 96, 32, "bfloat16")
    q, k, v = (_model_layout(t) for t in _torch(arrs, "bfloat16", cuda))
    assert _check_card(q, k, v, "bfloat16", True, None) == "cuda_cores"


TC_MASKS = [(True, None), (False, None), (True, 40), (True, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 16])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("s", [64, 100, 777, 1024])
@pytest.mark.parametrize("causal,window", TC_MASKS)
def test_cuda_tensor_cores_match_plain(causal, window, s, d, group, rng,
                                       cuda):
    """bf16 at D 64, 128, 192 and 256 on the tensor-core route: 16 query
    heads reading 16 / group kv heads, ragged and tile-aligned S."""
    q, k, v = _torch(_qkv(rng, 1, 16, 16 // group, s, d, "bfloat16"),
                     "bfloat16", cuda)
    assert _check_card(q, k, v, "bfloat16", causal, window) == \
        "tensor_cores"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("causal,window", TC_MASKS)
def test_cuda_tensor_cores_model_layout(causal, window, d, rng, cuda):
    """The model's (B, S, H, D) memory on the tensor-core route, through
    the TMA descriptors' strides."""
    arrs = _qkv(rng, 2, 8, 2, 300, d, "bfloat16")
    q, k, v = (_model_layout(t) for t in _torch(arrs, "bfloat16", cuda))
    assert _check_card(q, k, v, "bfloat16", causal, window) == \
        "tensor_cores"


@pytest.mark.cuda
def test_cuda_tensor_cores_refuse_unaligned_rows(rng, cuda):
    """Rows that TMA cannot read raise before any launch; nothing falls
    back to the other kernel or to the plain version."""
    q, k, v = _torch(_qkv(rng, 1, 4, 2, 64, 72, "bfloat16"), "bfloat16",
                     cuda)
    q = q[..., 4:68]  # D 64 at an address 8 bytes past the row's start
    k, v = k[..., :64], v[..., :64]
    before = dict(tfa.launch_counts)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q, k, v)
    assert tfa.launch_counts == before
