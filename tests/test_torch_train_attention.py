"""The flash kernel's autograd wrapper and the train step's launches.

``flash_attention_train`` runs the hand kernel forward and, in the
backward, the plain attention's autograd recomputed from the saved q, k
and v (the reference trains through ``mha_ref`` and has no backward
kernel).  On the CPU the kernel call is replaced by a counting plain
version; the tests marked ``cuda`` run the kernel, and a train step of
reduced granite, on the card (``python -m pytest -q -m cuda
tests/test_torch_train_attention.py``; no jax needed).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


def _batch(rng, cfg, b, s):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "loss_mask": np.ones((b, s), np.float32)}


def _qkv(rng, b=2, h=4, kv=2, s=40, d=16):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .requires_grad_(True)
            for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d))]


def _grads_of(fn, q, k, v, do):
    o = fn(q, k, v)
    return (o, *torch.autograd.grad(o, (q, k, v), do))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8)])
def test_kernel_forward_plain_backward(causal, window, rng, monkeypatch):
    """The wrapper on the card's path, the kernel replaced by a counting
    plain version: one launch a forward, none in the backward, and the
    gradients of the plain attention."""
    launches = []

    def kernel(q, k, v, causal, window, scale):
        launches.append(1)
        with torch.no_grad():
            return tref.attention_ref(q, k, v, causal, window, scale)

    monkeypatch.setattr(tfa, "on_cpu", lambda *t: False)
    monkeypatch.setattr(tfa, "flash_attention", kernel)
    q, k, v = _qkv(rng)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    got = _grads_of(lambda *a: tops.attention(*a, causal=causal,
                                              window=window), q, k, v, do)
    assert len(launches) == 1
    want = _grads_of(lambda *a: tref.attention_ref(*a, causal, window),
                     q, k, v, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # without a gradient to record, the kernel alone
    with torch.no_grad():
        tops.attention(q, k, v, causal=causal, window=window)
    assert len(launches) == 2


def test_attention_grads_on_cpu_are_the_plain_ones(rng):
    q, k, v = _qkv(rng)
    do = torch.ones_like(q)
    for a, b in zip(_grads_of(tops.attention, q, k, v, do),
                    _grads_of(tref.attention_ref, q, k, v, do)):
        assert torch.equal(a, b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 32)])
def test_cuda_kernel_forward_plain_backward(dtype, d, rng, cuda):
    q, k, v = (t.detach().to(cuda, dtype).requires_grad_(True)
               for t in _qkv(rng, 2, 8, 2, 256, d))
    do = torch.randn(q.shape, device=cuda, dtype=dtype)
    tfa.reset_launch_counts()
    got = _grads_of(tops.attention, q, k, v, do)
    assert tfa.launch_counts["flash_attention"] == 1
    want = _grads_of(tref.attention_ref, q, k, v, do)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)     # the same plain backward from q, k, v
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_train_step_launches_the_kernel(cuda):
    """Reduced granite (D 16, the CUDA-core route in bf16) on the card:
    each step's forward launches the kernel once a layer and remat's
    recompute once more."""
    cfg = tget("granite-3-2b").reduced()
    opt = topt.AdamW(lr=topt.warmup_cosine(1e-3, 1, 4))
    masters = tstep.init_masters(cfg, 0, cuda)
    state = opt.init(masters)
    step = tstep.make_train_step(cfg, opt, device=cuda)
    batch = _batch(np.random.default_rng(0), cfg, 4, 64)
    tfa.reset_launch_counts()
    _, _, m = step(masters, state, batch)
    assert tfa.launch_counts["flash_attention"] == 2 * cfg.num_layers
    assert np.isfinite(float(m["loss"]))
