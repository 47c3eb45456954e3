"""The port's cross-attention families vs the JAX package's, on the CPU.

Reduced llama-3.2-vision-11b (10 layers: two superblocks of four ``attn``
blocks and a tanh-gated ``cross_attn`` block over 16 image tokens; d_model
64, 4 heads of 16, 2 kv heads, SwiGLU, vocab 512) and reduced whisper-tiny
(2 ``decoder`` blocks and a 2-layer encoder over 24 frames; LayerNorm,
GELU, tied embeddings, learned positions over 128 rows).  The JAX
package's ``lm.init`` weights go through ``convert.params_from_jax`` with
every ``gate`` and ``gate_mlp`` drawn from numpy (at init they are 0, and
tanh(0) would hide the whole cross path), and the frontend stubs
(``img_embeds``, ``enc_embeds``) are drawn from the seed too (zero stubs
would make every cross K/V zero).

Both packages compute in float32: logits agree to 1e-4 (``LOGIT_TOL`` of
tests/test_torch_lm.py), caches and the encoder's states to 1e-5.  Greedy
tokens are compared in float32 too and must be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tserve  # noqa: E402

VISION, WHISPER = "llama-3.2-vision-11b", "whisper-tiny"
ARCHS = [VISION, WHISPER]
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
CPU = "cpu"

_MODELS = {}


def _cfgs(arch, **over):
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


def _models(arch):
    """(jax cfg, jax params, port cfg, port model), f32 compute, the
    gates drawn from numpy."""
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        params, _ = jlm.init(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        rng = np.random.default_rng(11)
        for block in tree["blocks"].values():
            for g in ("gate", "gate_mlp"):
                if g in block:
                    block[g] = rng.normal(0.0, 1.0, block[g].shape).astype(
                        np.float32)
        _MODELS[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                         convert.params_from_jax(tcfg, tree, device=CPU))
    return _MODELS[arch]


def _stubs(rng, cfg, b):
    """The frontend stubs of a batch of b, drawn from ``rng``."""
    if cfg.encdec:
        return {"enc_embeds": rng.normal(
            0.0, 1.0, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {"img_embeds": rng.normal(
        0.0, 1.0, (b, cfg.img_seq, cfg.d_model)).astype(np.float32)}


def _stub_fn(cfg, seed):
    """A ServeLoop ``extras_fn``: each wave's stubs from one seeded
    stream, so two loops that admit the same waves see the same stubs."""
    rng = np.random.default_rng(seed)
    return lambda n: _stubs(rng, cfg, n)


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _batch(toks, extras):
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in extras.items()}}


def _close_cache(got, want):
    """Every leaf of the JAX package's cache tree, nested ones too."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got_flat] == [p for p, _ in flat]
    for (path, w), (_, g) in zip(flat, got_flat):
        assert tuple(g.shape) == tuple(w.shape), path
        _close(g, w, CACHE_TOL)


# -- configs and weights -------------------------------------------------------


@pytest.mark.parametrize("arch,count,extra", [
    # param_count leaves out ln_f and the two gates of each of the 8
    # cross_attn layers
    (VISION, 9_791_930_368, 4096 + 8 * 2),
    # LayerNorm holds a scale and a bias, and param_count counts one d a
    # norm in the decoder blocks (3 each) and leaves out both ln_f
    (WHISPER, 49_600_896, 4 * 3 * 384 + 2 * 2 * 384)])
def test_full_configs_build(arch, count, extra):
    cfg = tget(arch)
    model = tlm.LM(cfg, device="meta")
    assert cfg.param_count() == count
    assert sum(p.numel() for p in model.parameters()) == count + extra


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_with_zero_gates(arch):
    cfg = tget(arch).reduced()
    a = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    b = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n
    gates = [p for n, p in a.named_parameters() if "gate" in n]
    assert len(gates) == (4 if cfg.img_seq else 0)
    assert all(g.dtype == torch.float32 and float(g) == 0.0 for g in gates)
    w = (a.pos_emb if cfg.encdec else a.img_proj).float()
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.02


def test_zero_gates_hide_the_image(rng):
    """At init tanh(0) = 0: the image stub changes nothing; a nonzero
    gate lets it through."""
    cfg = tget(VISION).reduced()
    model = tlm.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    toks = _t(_tokens(rng, cfg, 2, 8))
    a, b = (tlm.forward(cfg, model, toks, extras=_stubs(rng, cfg, 2))
            for _ in range(2))
    assert torch.equal(a, b)
    model.blocks[4].gate.fill_(0.5)
    a, b = (tlm.forward(cfg, model, toks, extras=_stubs(rng, cfg, 2))
            for _ in range(2))
    assert not torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    _, params, tcfg, model = _models(arch)
    back = convert.params_to_jax(tcfg, model)
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    assert tlm.cache_axes(tcfg) == jlm.cache_axes(jcfg)
    tc = tlm.init_cache(tcfg, 3, 10, device=CPU)
    jc = jlm.init_cache(jcfg, 3, 10)
    assert jax.tree.map(lambda t: tuple(t.shape), tc) == \
        jax.tree.map(lambda a: tuple(a.shape), jc)


def test_extras_are_required(rng):
    _, _, tcfg, model = _models(WHISPER)
    with pytest.raises(ValueError, match="enc_embeds"):
        tlm.prefill(tcfg, model, _t(_tokens(rng, tcfg, 1, 4)), cache_len=8)


# -- the pieces ----------------------------------------------------------------


def test_encode_matches_reference(rng):
    jcfg, params, tcfg, model = _models(WHISPER)
    frames = _stubs(rng, tcfg, 2)["enc_embeds"]
    want = jlm.encode(jcfg, params, jnp.asarray(frames))
    got = tlm.encode(tcfg, model, frames)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    _close(got, want, CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_cross_attn_decode_matches_reference(arch, cache_dtype, rng):
    """One token against static K/V, GQA (2 kv heads of 4), in the
    cache's dtype: f32, or bf16 beside the f32 query as in ServeLoop."""
    jcfg, params, tcfg, model = _models(arch)
    jp = params["blocks"]["b4" if arch == VISION else "b0"]
    jp = jax.tree.map(lambda t: t[1], jp["attn" if arch == VISION
                                       else "xattn"])
    blk = model.blocks[9 if arch == VISION else 1]
    tp = blk.attn if arch == VISION else blk.xattn
    enc = rng.normal(0.0, 1.0, (2, 24, tcfg.d_model)).astype(np.float32)
    x = rng.normal(0.0, 1.0, (2, 1, tcfg.d_model)).astype(np.float32)
    jkv = jlayers.cross_attn_kv(jcfg, jp, jnp.asarray(enc))
    tkv = tlayers.cross_attn_kv(tcfg, tp, torch.as_tensor(enc))
    _close_cache(tkv, jkv)
    dt = getattr(jnp, cache_dtype)
    jkv = {n: t.astype(dt) for n, t in jkv.items()}
    tkv = {n: t.to(getattr(torch, cache_dtype)) for n, t in tkv.items()}
    want = jlayers.cross_attn_decode(jcfg, jp, jnp.asarray(x), jkv)
    got = tlayers.cross_attn_decode(tcfg, tp, torch.as_tensor(x), tkv)
    # a bf16 cache makes the output bf16 in both (V's dtype, wo cast to it)
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = LOGIT_TOL if cache_dtype == "float32" else 1e-2
    _close(got, want, tol)


# -- logits and caches ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    toks, extras = _tokens(rng, tcfg, 2, 20), _stubs(rng, tcfg, 2)
    want, _ = jlm.forward_train(jcfg, params, _batch(toks, extras))
    _close(tlm.forward(tcfg, model, _t(toks), extras=extras), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    toks, extras = _tokens(rng, tcfg, 2, 16), _stubs(rng, tcfg, 2)
    want, jcache = jlm.prefill(jcfg, params, _batch(toks, extras),
                               cache_len=20)
    got, cache = tlm.prefill(tcfg, model, _t(toks), cache_len=20,
                             extras=extras)
    _close(got, want)
    _close_cache(cache, jcache)
    cross = cache["blocks"]["b4" if arch == VISION else "b0"]
    cross = cross["k"] if arch == VISION else cross["cross_k"]
    assert float(cross.abs().max()) > 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_and_cache_match_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    toks, extras = _tokens(rng, tcfg, 2, 20), _stubs(rng, tcfg, 2)
    _, jcache = jlm.prefill(jcfg, params, _batch(toks[:, :16], extras),
                            cache_len=20)
    _, cache = tlm.prefill(tcfg, model, _t(toks[:, :16]), cache_len=20,
                           extras=extras)
    for i in range(16, 20):
        want, jcache = jlm.decode_step(jcfg, params, jcache,
                                       jnp.asarray(toks[:, i]), i)
        got, cache = tlm.decode_step(tcfg, model, cache, _t(toks[:, i]), i)
        _close(got, want)
    _close_cache(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, rng):
    """Prefill + decode == the teacher-forced forward (the learned
    positions by index at every step)."""
    _, _, tcfg, model = _models(arch)
    s, extra = 12, 4
    toks, extras = _t(_tokens(rng, tcfg, 2, s + extra)), _stubs(rng, tcfg, 2)
    full = tlm.forward(tcfg, model, toks, extras=extras)
    lg, cache = tlm.prefill(tcfg, model, toks[:, :s], cache_len=s + extra,
                            extras=extras)
    errs = [float((lg - full[:, s - 1]).abs().max())]
    for i in range(extra):
        lg, cache = tlm.decode_step(tcfg, model, cache, toks[:, s + i],
                                    s + i)
        errs.append(float((lg - full[:, s + i]).abs().max()))
    assert max(errs) < LOGIT_TOL, errs


@pytest.mark.parametrize("prompt_len,flash_calls", [(24, 6), (16, 4)])
def test_prompt_as_long_as_the_encoder(prompt_len, flash_calls, rng,
                                       monkeypatch):
    """A whisper prompt as long as the reduced encoder_seq (24): the
    cross call has S == Skv, so ``ops.attention`` sends it to the flash
    wrapper (the plain version here) as the encoder's and the self
    calls; at 16 it takes the plain path.  Both agree with the JAX
    package."""
    jcfg, params, tcfg, model = _models(WHISPER)
    assert tcfg.encoder_seq == 24
    calls = []
    flash = tlayers.ops._flash.flash_attention

    def counted(q, k, v, causal, window, scale):
        calls.append((q.shape[2], k.shape[2], causal))
        return flash(q, k, v, causal, window, scale)

    monkeypatch.setattr(tlayers.ops._flash, "flash_attention", counted)
    toks, extras = _tokens(rng, tcfg, 2, prompt_len), _stubs(rng, tcfg, 2)
    want, jcache = jlm.prefill(jcfg, params, _batch(toks, extras),
                               cache_len=prompt_len + 2)
    got, cache = tlm.prefill(tcfg, model, _t(toks),
                             cache_len=prompt_len + 2, extras=extras)
    _close(got, want)
    _close_cache(cache, jcache)
    assert len(calls) == flash_calls
    # 2 encoder layers unmasked, 2 causal self calls, then the cross ones
    assert calls.count((24, 24, False)) == (4 if prompt_len == 24 else 2)
    assert calls.count((prompt_len, prompt_len, True)) == 2


# -- serving -------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    prompts = rng.integers(2, tcfg.vocab_size, (3, 8)).astype(np.int32)
    extras = _stubs(rng, tcfg, 3)
    want = jserve.generate(jcfg, params, jnp.asarray(prompts),
                           max_new_tokens=6, extras=extras)
    got = tserve.generate(tcfg, model, prompts, max_new_tokens=6,
                          extras=extras)
    assert got.shape == (3, 14) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots,cache_len,lens,max_new", [
    (3, 32, (8, 8), 6), (2, 24, (6, 3, 6, 5, 6), 4)])
def test_serve_loop_matches_reference(slots, cache_len, lens, max_new,
                                      arch, rng):
    """Waves with their own stubs, slot surgery of the cross caches,
    oversubscription and ragged (left-padded) prompts: every request's
    tokens equal the JAX package's ServeLoop's (bf16 cache, as there)."""
    jcfg, params, tcfg, model = _models(arch)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    loops = (jserve.ServeLoop(jcfg, params, num_slots=slots,
                              cache_len=cache_len,
                              extras_fn=_stub_fn(tcfg, 5)),
             tserve.ServeLoop(tcfg, model, num_slots=slots,
                              cache_len=cache_len,
                              extras_fn=_stub_fn(tcfg, 5)))
    out = []
    for sl, mod in zip(loops, (jserve, tserve)):
        reqs = [mod.Request(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sl.submit(r)
        steps = sl.run()
        assert all(r.done and len(r.generated) == max_new for r in reqs)
        out.append((steps, [r.generated for r in reqs]))
    assert out[1] == out[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_cross_cache_follows_its_slot(arch, rng):
    """A second wave into slot 1 writes its own cross K/V there and leaves
    the other slots' rows as the first wave wrote them.  The cross K/V
    depend on the stubs alone, so a prefill of any tokens with a wave's
    stubs gives the rows that wave wrote."""
    _, _, tcfg, model = _models(arch)
    stubs, seen = _stub_fn(tcfg, 9), []

    def extras_fn(n):
        seen.append(stubs(n))
        return seen[-1]

    sl = tserve.ServeLoop(tcfg, model, num_slots=3, cache_len=16,
                          extras_fn=extras_fn)
    for i, n in enumerate((5, 2, 5)):
        sl.submit(tserve.Request(rid=i, prompt=_tokens(rng, tcfg, 1, 6)[0],
                                 max_new=n))
    sl.step()                   # the first wave, then request 1 is done
    assert sl.slot_req[1] is None and len(seen) == 1
    sl.submit(tserve.Request(rid=3, prompt=_tokens(rng, tcfg, 1, 6)[0],
                             max_new=3))
    sl.step()
    assert len(seen) == 2 and sl.slot_req[1].rid == 3
    key, leaf = ("b4", "k") if arch == VISION else ("b0", "cross_k")
    got = sl.cache["blocks"][key][leaf]
    want = [tlm.prefill(tcfg, model, torch.zeros((len(w[next(iter(w))]), 6),
                                                 dtype=torch.long),
                        cache_len=16, extras=w)[1]["blocks"][key][leaf]
            for w in seen]
    for slot, wave, row in ((0, 0, 0), (1, 1, 0), (2, 0, 2)):
        assert torch.equal(got[:, slot], want[wave][:, row].to(got.dtype)), \
            (slot, wave)
    assert not torch.equal(got[:, 1], want[0][:, 1].to(got.dtype))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["static", "continuous"])
def test_launch_serve_cli(arch, mode):
    out = tlaunch.main(["--device", "cpu", "--arch", arch, "--mode", mode,
                        "--requests", "3", "--slots", "2", "--prompt-len",
                        "6", "--max-new", "4"])
    if mode == "static":
        assert out.shape == (3, 10)
    else:
        assert all(r.done and len(r.generated) == 4 for r in out)
