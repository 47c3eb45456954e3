"""The port's Griffin hybrid (recurrentgemma-9b) vs the JAX package's, on
the CPU.

The reduced recurrentgemma-9b config (d_model 64, 4 heads of 16, 1 kv
head, d_ff 128, vocab 512, lru_dim 64, conv width 4, window 32), at its
default 6 layers (two superblocks of recurrent, recurrent, local_attn)
and at 8, where the two remainder layers (recurrent, recurrent) run too.
The JAX package's ``lm.init`` weights go through
``convert.params_from_jax`` with the constant leaves perturbed from numpy
(``lam`` and ``conv_b``), so that a dropped bias or a wrong softplus
changes the logits.  Prompts of 40 tokens are longer than the window, so
the local layers mask and their ring buffers hold the last 32 keys.

Both packages compute in float32: the RG-LRU state and outputs agree to
1e-5, logits to 1e-4 (summation order through up to 8 layers; logits are
O(1)), ``pos_of_slot`` exactly.  Greedy tokens are compared in float32
too, where the two frameworks' bf16 roundings cannot flip a near tie.
The bf16 model is held against its own f32 upcast.

The test marked ``cuda`` holds the flash kernels at head dims 192 and
256 against their plain version on the card, each on its route (f32: the
CUDA-core kernel; bf16: the tensor-core kernel); it needs no jax.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import griffin as tgriffin  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tserve  # noqa: E402

ARCH = "recurrentgemma-9b"
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
PROMPT = 40        # > the reduced window of 32
CPU = "cpu"
DEPTHS = [6, 8]    # 8: two remainder layers
# bf16 model vs its f32 upcast: relative L2 of the last logits at
# lm.init's constants.  bf16 rounds by up to 2^-9 ≈ 2e-3 at every
# operation; through the 6 layers the port reads 0.027 and the JAX
# package's own bf16 model 0.025 from its f32 one on the same weights
BF16_REL_TOL = 5e-2


@pytest.fixture(scope="module")
def ref():
    """The JAX package, for the parity tests; they skip where JAX is
    absent (the card's machine runs only the ``-m cuda`` test)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import griffin, layers, lm
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, get_config=get_config,
                                 griffin=griffin, layers=layers, lm=lm,
                                 serve=engine)


_MODELS = {}


def _cfgs(ref, **over):
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(ref.get_config(ARCH).reduced(), **over),
            dataclasses.replace(tget(ARCH).reduced(), **over))


def _perturbed_params(ref, jcfg, seed=0):
    """The JAX ``lm.init`` tree as numpy, with ``lam`` drawn in [-2, 7)
    (a = σ(Λ) from 0.12 to 0.999) and one channel at -25, and ``conv_b``
    ~ N(0, 0.1²)."""
    params, _ = ref.lm.init(jcfg, ref.jax.random.PRNGKey(seed))
    tree = ref.jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 1)
    groups = [tree["blocks"]] + ([tree["rem"]] if "rem" in tree else [])
    for g in groups:
        for blk in g.values():
            if "rec" not in blk:
                continue
            rec = blk["rec"]
            lam = rng.uniform(-2.0, 7.0, rec["lam"].shape)
            lam[..., 0] = -25.0
            rec["lam"] = lam.astype(np.float32)
            rec["conv_b"] = (0.1 * rng.standard_normal(
                rec["conv_b"].shape)).astype(np.float32)
    return tree


def _models(ref, layers=6):
    """(jax cfg, jax params, port cfg, port model), f32 compute."""
    if layers not in _MODELS:
        jcfg, tcfg = _cfgs(ref, num_layers=layers)
        tree = _perturbed_params(ref, jcfg)
        params = ref.jax.tree.map(ref.jnp.asarray, tree)
        _MODELS[layers] = (jcfg, params, tcfg,
                           convert.params_from_jax(tcfg, tree, device=CPU))
    return _MODELS[layers]


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# -- the block ----------------------------------------------------------------


def test_recurrent_apply_matches_reference(ref, rng):
    """Outputs and the new h / conv state from a nonzero state."""
    jcfg, params, tcfg, model = _models(ref)
    p = ref.jax.tree.map(lambda t: t[1], params["blocks"]["b0"]["rec"])
    b, s, ld = 2, 13, tcfg.lru_dim
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((b, ld)).astype(np.float32)
    conv0 = rng.standard_normal((b, tcfg.conv_width - 1, ld)).astype(
        np.float32)
    want, wst = ref.griffin.recurrent_apply(
        jcfg, p, ref.jnp.asarray(x),
        {"h": ref.jnp.asarray(h0), "conv": ref.jnp.asarray(conv0)})
    state = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv0)}
    got, st = tgriffin.recurrent_apply(tcfg, model.blocks[3].rec,
                                       torch.from_numpy(x), state)
    _close(got, want, STATE_TOL)
    _close(st["h"], wst["h"], STATE_TOL)
    _close(st["conv"], wst["conv"], STATE_TOL)
    assert st["h"].dtype == torch.float32
    assert torch.equal(state["h"], torch.from_numpy(h0))  # not written


def test_softplus_equals_reference_for_any_lam(ref):
    lam = np.array([-100.0, -30.0, -20.5, -1.0, 0.0, 1e-3, 4.0, 20.5, 30.0,
                    100.0], np.float32)
    want = np.asarray(ref.jax.nn.softplus(ref.jnp.asarray(lam)))
    got = tgriffin._softplus(torch.from_numpy(lam)).numpy()
    # atol: JAX on the CPU flushes softplus(-100) = 3.7e-44, a subnormal,
    # to 0
    np.testing.assert_allclose(got, want, rtol=1e-7,
                               atol=np.finfo(np.float32).tiny)


def test_conv_state_continuity(ref, rng):
    """After tests/test_serve.py:79: the block over two chunks, carrying
    the state, equals one pass over the whole sequence."""
    _, _, tcfg, model = _models(ref)
    p = model.blocks[0].rec
    b, s = 2, 24
    x = torch.from_numpy(rng.standard_normal((b, s, tcfg.d_model))
                         .astype(np.float32))
    y_full, st_full = tgriffin.recurrent_apply(
        tcfg, p, x, tgriffin.recurrent_state_init(tcfg, b))
    y1, st = tgriffin.recurrent_apply(
        tcfg, p, x[:, :12], tgriffin.recurrent_state_init(tcfg, b))
    y2, st2 = tgriffin.recurrent_apply(tcfg, p, x[:, 12:], st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(st2["h"].numpy(), st_full["h"].numpy(),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(st2["conv"], st_full["conv"])


def test_ring_buffer_decode_matches_windowed(ref, rng):
    """After tests/test_serve.py:96: the ring-buffer decode of the last
    token equals full-sequence windowed attention, once the context
    exceeds the window (8 here)."""
    _, _, tcfg, model = _models(ref)
    cfg = dataclasses.replace(tcfg, window=8)
    p = model.blocks[2].attn
    b, s = 1, 20
    x = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model))
                         .astype(np.float32))
    positions = torch.arange(s)[None]
    full = tlayers.attn_apply(cfg, p, x, positions=positions,
                              window=cfg.window)
    cache = tcache.local_cache_init(cfg, b, torch.float32)
    _, cache = tlm._local_prefill(cfg, p, x[:, :-1], positions[:, :-1],
                                  cache)
    out, cache = tlm._local_decode(cfg, p, x[:, -1:], cache,
                                   torch.tensor([s - 1]))
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-5, atol=2e-5)
    assert sorted(cache["pos_of_slot"][0].tolist()) == list(range(12, 20))


# -- the stack ----------------------------------------------------------------


@pytest.mark.parametrize("layers", DEPTHS)
def test_forward_logits_match_reference(layers, ref, rng):
    jcfg, params, tcfg, model = _models(ref, layers)
    toks = _tokens(rng, tcfg, 2, PROMPT)
    want, _ = ref.lm.forward_train(jcfg, params,
                                   {"tokens": ref.jnp.asarray(toks)})
    _close(tlm.forward(tcfg, model, _t(toks)), want)


@pytest.mark.parametrize("layers", DEPTHS)
def test_prefill_logits_and_cache_match_reference(layers, ref, rng):
    jcfg, params, tcfg, model = _models(ref, layers)
    toks = _tokens(rng, tcfg, 2, PROMPT)
    want, jcache = ref.lm.prefill(jcfg, params,
                                  {"tokens": ref.jnp.asarray(toks)},
                                  cache_len=PROMPT + 4)
    got, cache = tlm.prefill(tcfg, model, _t(toks), cache_len=PROMPT + 4)
    _close(got, want)
    kinds = {**{("blocks", f"b{j}"): k
                for j, k in enumerate(tcfg.block_pattern)},
             **{("rem", f"r{j}"): k
                for j, k in enumerate(tcfg.remainder_layers)}}
    assert ("rem" in cache) == (layers == 8)
    for (group, key), kind in kinds.items():
        got_c, want_c = cache[group][key], jcache[group][key]
        assert set(got_c) == set(want_c)
        if kind == "local_attn":
            np.testing.assert_array_equal(got_c["pos_of_slot"].numpy(),
                                          np.asarray(want_c["pos_of_slot"]))
            assert got_c["pos_of_slot"].dtype == torch.int32
        for n in set(got_c) - {"pos_of_slot"}:
            _close(got_c[n], want_c[n], STATE_TOL)
            assert got_c[n].dtype == (torch.float32 if kind == "recurrent"
                                      else got.dtype)


@pytest.mark.parametrize("layers,prompt,steps", [(6, PROMPT, 5),
                                                 (8, 28, 7)])
def test_decode_wraps_ring_and_matches_reference(layers, prompt, steps, ref,
                                                 rng):
    """Decode steps past the window: from a full ring (prompt 40: every
    step overwrites the oldest slot) and from a partly empty one (prompt
    28: the ring fills at 32, then wraps)."""
    jcfg, params, tcfg, model = _models(ref, layers)
    toks = _tokens(rng, tcfg, 2, prompt + steps)
    _, jcache = ref.lm.prefill(jcfg, params,
                               {"tokens": ref.jnp.asarray(toks[:, :prompt])},
                               cache_len=prompt + steps)
    _, cache = tlm.prefill(tcfg, model, _t(toks[:, :prompt]),
                           cache_len=prompt + steps)
    for i in range(prompt, prompt + steps):
        want, jcache = ref.lm.decode_step(jcfg, params, jcache,
                                          ref.jnp.asarray(toks[:, i]), i)
        got, cache = tlm.decode_step(tcfg, model, cache, _t(toks[:, i]), i)
        _close(got, want)
    ring = cache["blocks"]["b2"]["pos_of_slot"]
    np.testing.assert_array_equal(
        ring.numpy(), np.asarray(jcache["blocks"]["b2"]["pos_of_slot"]))
    assert int(ring.max()) == prompt + steps - 1
    assert int(ring.min()) == prompt + steps - tcfg.window
    for n in ("h", "conv"):
        _close(cache["blocks"]["b0"][n], jcache["blocks"]["b0"][n],
               STATE_TOL)


def test_prefill_decode_consistency(ref, rng):
    """Prefill + decode == the teacher-forced forward, within the JAX
    package's own tolerance (tests/test_models.py)."""
    _, _, tcfg, model = _models(ref, 8)
    b, s, extra = 2, PROMPT, 4
    toks = _t(_tokens(rng, tcfg, b, s + extra))
    full = tlm.forward(tcfg, model, toks)
    lg, cache = tlm.prefill(tcfg, model, toks[:, :s], cache_len=s + extra)
    errs = [float((lg - full[:, s - 1]).abs().max())]
    for i in range(extra):
        lg, cache = tlm.decode_step(tcfg, model, cache, toks[:, s + i],
                                    s + i)
        errs.append(float((lg - full[:, s + i]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_cache_tree_matches_reference(ref):
    for layers in DEPTHS:
        jcfg, tcfg = _cfgs(ref, num_layers=layers)
        assert tlm.cache_axes(tcfg) == ref.lm.cache_axes(jcfg)
        tc = tlm.init_cache(tcfg, 3, 10, device=CPU)
        jc = ref.lm.init_cache(jcfg, 3, 10)
        shapes = ref.jax.tree.map(lambda t: tuple(t.shape), tc)
        assert shapes == ref.jax.tree.map(lambda a: tuple(a.shape), jc)
        for got, want in zip(ref.jax.tree.leaves(tc),
                             ref.jax.tree.leaves(jc)):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
    assert int(tc["blocks"]["b2"]["pos_of_slot"].max()) == -1


# -- weights ------------------------------------------------------------------


@pytest.mark.parametrize("layers", DEPTHS)
def test_params_round_trip(layers, ref):
    jcfg, params, tcfg, model = _models(ref, layers)
    back = convert.params_to_jax(tcfg, model)
    want = ref.jax.tree.map(np.asarray, params)
    assert ref.jax.tree.structure(back) == ref.jax.tree.structure(want)
    for a, b in zip(ref.jax.tree.leaves(back), ref.jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_lam_and_conv_b_stay_f32_in_bf16(ref):
    jcfg, tcfg = _cfgs(ref, compute_dtype="bfloat16")
    tree = _perturbed_params(ref, jcfg, seed=1)
    model = convert.params_from_jax(tcfg, tree, device=CPU)
    rec = model.blocks[1].rec
    assert rec.wr.dtype == rec.conv_w.dtype == torch.bfloat16
    for name in ("lam", "conv_b"):
        leaf = getattr(rec, name)
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(
            leaf.numpy(), tree["blocks"]["b1"]["rec"][name][0])
    back = convert.params_to_jax(tcfg, model)
    np.testing.assert_array_equal(back["blocks"]["b0"]["rec"]["lam"],
                                  tree["blocks"]["b0"]["rec"]["lam"])


def test_full_width_param_count():
    cfg = tget(ARCH)
    model = tlm.LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    n_rec = sum(k == "recurrent" for k in tlm.layer_kinds(cfg))
    # param_count counts three lru_dim vectors a recurrent layer (the
    # block has two: conv_b and lam) and leaves out ln_f
    assert cfg.param_count() == 9_396_297_728
    assert n == cfg.param_count() - n_rec * cfg.lru_dim + cfg.d_model
    assert (cfg.num_layers, n_rec) == (38, 26)
    assert model.blocks[2].kind == "local_attn"
    assert model.blocks[0].rec.lam.dtype == torch.float32


def test_init_is_seeded_with_reference_constants():
    cfg = tget(ARCH).reduced()
    a = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    b = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    rec = a.blocks[0].rec
    # σ(log(expm1(4))) = 1 - e^-4
    assert torch.allclose(torch.sigmoid(rec.lam),
                          torch.full_like(rec.lam, 1 - np.exp(-4.0)))
    assert not rec.conv_b.any()
    assert abs(float(rec.wr.float().std()) - cfg.lru_dim ** -0.5) < 0.02


# -- bf16 ---------------------------------------------------------------------


def test_bf16_model_near_its_f32_upcast(ref, rng):
    jcfg, tcfg = _cfgs(ref, compute_dtype="bfloat16")
    params, _ = ref.lm.init(jcfg, ref.jax.random.PRNGKey(0))
    model = convert.params_from_jax(
        tcfg, ref.jax.tree.map(np.asarray, params), device=CPU)
    m32 = copy.deepcopy(model).float()
    toks = _t(_tokens(rng, tcfg, 2, PROMPT))
    got, cache = tlm.prefill(tcfg, model, toks, cache_len=PROMPT)
    want, _ = tlm.prefill(tcfg, m32, toks, cache_len=PROMPT)
    assert got.dtype == torch.bfloat16
    assert cache["blocks"]["b2"]["k"].dtype == torch.bfloat16
    assert cache["blocks"]["b0"]["h"].dtype == torch.float32
    rel = float((got.float() - want).norm() / want.norm())
    assert rel < BF16_REL_TOL, rel


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("layers", DEPTHS)
def test_generate_matches_reference(layers, ref, rng):
    jcfg, params, tcfg, model = _models(ref, layers)
    prompts = rng.integers(2, tcfg.vocab_size, (3, PROMPT)).astype(np.int32)
    want = ref.serve.generate(jcfg, params, ref.jnp.asarray(prompts),
                              max_new_tokens=6)
    got = tserve.generate(tcfg, model, prompts, max_new_tokens=6)
    assert got.shape == (3, PROMPT + 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_loop_matches_reference(ref, rng):
    """Slot surgery over the ring buffers and the RG-LRU states, waves and
    oversubscription: every request's tokens equal the JAX package's
    ServeLoop's (bf16 ring, f32 state, as there)."""
    jcfg, params, tcfg, model = _models(ref, 8)
    slots, cache_len, n, max_new = 2, 48, 5, 5
    prompts = rng.integers(2, tcfg.vocab_size, (n, 36)).astype(np.int32)
    loops = (ref.serve.ServeLoop(jcfg, params, num_slots=slots,
                                 cache_len=cache_len),
             tserve.ServeLoop(tcfg, model, num_slots=slots,
                              cache_len=cache_len))
    out = []
    for sl, mod in zip(loops, (ref.serve, tserve)):
        reqs = [mod.Request(rid=i, prompt=prompts[i], max_new=max_new)
                for i in range(n)]
        for r in reqs:
            sl.submit(r)
        steps = sl.run()
        assert all(r.done and len(r.generated) == max_new for r in reqs)
        out.append((steps, [r.generated for r in reqs]))
    assert out[1] == out[0]
    ring = loops[1].cache["blocks"]["b2"]
    assert ring["k"].dtype == torch.bfloat16
    assert ring["pos_of_slot"].dtype == torch.int32


def test_serve_loop_matches_static_bf16(rng):
    """In bf16, the requests of a wave equal the static batch of the same
    prompts, the ring buffers past their window."""
    cfg = tget(ARCH).reduced()
    model = tlm.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    prompts = rng.integers(2, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
    static = tserve.generate(cfg, model, prompts, max_new_tokens=8)
    sl = tserve.ServeLoop(cfg, model, num_slots=4, cache_len=PROMPT + 16)
    reqs = [tserve.Request(rid=i, prompt=prompts[i], max_new=8)
            for i in range(4)]
    for r in reqs:
        sl.submit(r)
    sl.run()
    for i, r in enumerate(reqs):
        assert r.generated == static[i, PROMPT:].tolist(), i


def test_cpu_tensors_never_launch(rng):
    """A prefill and decode of the reduced model on the CPU, D 16, and
    the CUDA-core route's head dims 192 and 256: no count moves."""
    cfg = tget(ARCH).reduced()
    model = tlm.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    tfa.reset_launch_counts()
    toks = _t(_tokens(rng, cfg, 2, PROMPT))
    _, cache = tlm.prefill(cfg, model, toks, cache_len=PROMPT + 1)
    tlm.decode_step(cfg, model, cache, toks[:, 0], PROMPT)
    for d, dtype in ((192, torch.bfloat16), (256, torch.float32)):
        q = torch.randn(1, 2, 70, d).to(dtype)
        k = torch.randn(1, 1, 70, d).to(dtype)
        tfa.flash_attention(q, k, k, window=32)
    assert all(n == 0 for n in tfa.launch_counts.values())


def test_launch_serve_cli():
    out = tlaunch.main(["--device", "cpu", "--arch", ARCH, "--requests",
                        "3", "--slots", "2", "--prompt-len", "36",
                        "--max-new", "4"])
    assert all(r.done and len(r.generated) == 4 for r in out)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,hkv,s,causal,window", [
    (256, 16, 1, 300, True, 128), (256, 4, 1, 777, False, None),
    (192, 8, 2, 200, True, None), (192, 4, 4, 130, False, 40)])
def test_cuda_flash_wide_heads_match_plain(dtype, d, h, hkv, s, causal,
                                           window, cuda):
    """The flash kernels at D 192 and 256 against the plain version:
    recurrentgemma's MQA under a window, nemotron's D 192.  f32 takes the
    CUDA-core kernel's DP 192 and 256 instances, bf16 the tensor-core
    kernel's."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, n, s, d), generator=gen, device=cuda)
               .to(dtype) for n in (h, hkv, hkv))
    path = "cuda_cores" if dtype == torch.float32 else "tensor_cores"
    assert tfa.route(dtype, d) == path
    before = dict(tfa.launch_counts)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    for key in ("flash_attention", "flash_attention_" + path):
        assert tfa.launch_counts[key] == before[key] + 1
    other = {"cuda_cores": "flash_attention_tensor_cores",
             "tensor_cores": "flash_attention_cuda_cores"}[path]
    assert tfa.launch_counts[other] == before[other]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
