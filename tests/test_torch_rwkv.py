"""The port's RWKV-6 model and its serving vs the JAX package's, on the CPU.

The reduced rwkv6-1.6b config (2 layers, d_model 64, 4 heads of 16,
d_ff 128, vocab 512, ddlerp rank 8, decay rank 8).  The JAX package's
``lm.init`` weights go through ``convert.params_from_jax`` with the
constant leaves perturbed from numpy (u, the 5 rows of mu, the 2 of
mu_c, w0, ln_x), so that a swapped ddlerp row or a dropped u changes the
logits.  Both packages compute in float32: there the JAX model's
rounding of its WKV state to the compute dtype is the identity, and
logits agree to 1e-4 (summation order through two layers; logits are
O(1)).  In bf16 the two cannot agree to a useful tolerance (the JAX
model rounds the state to bf16 at every step, the port keeps it in f32),
so the bf16 model is held against its own f32 upcast instead.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import wkv6 as twkv  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.serve import engine as tserve  # noqa: E402

ARCH = "rwkv6-1.6b"
LOGIT_TOL = 1e-4
CPU = "cpu"
F32_LEAVES = ("mu", "w0", "dec_b", "u", "ln_x", "mu_c")
STATE = ("wkv", "tm_x", "cm_x")

_MODELS = {}


def _cfgs(**over):
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(jget(ARCH).reduced(), **over),
            dataclasses.replace(tget(ARCH).reduced(), **over))


def _perturbed_params(jcfg, seed=0):
    """The JAX ``lm.init`` tree as numpy, with the constant leaves drawn
    around their init values (mu, mu_c in [0, 1); w0 in [-6, -1), decays
    from 0.9975 down to 0.69; u ~ N(0, 0.5²); ln_x in [0.5, 1.5))."""
    params, _ = jlm.init(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    p = tree["blocks"]["b0"]["rwkv"]
    rng = np.random.default_rng(seed)
    draws = {"mu": lambda s: rng.random(s),
             "mu_c": lambda s: rng.random(s),
             "w0": lambda s: rng.uniform(-6.0, -1.0, s),
             "u": lambda s: rng.normal(0.0, 0.5, s),
             "ln_x": lambda s: rng.uniform(0.5, 1.5, s)}
    for name, draw in draws.items():
        p[name] = draw(p[name].shape).astype(np.float32)
    return tree


def _models():
    """(jax cfg, jax params, port cfg, port model), f32 compute."""
    if not _MODELS:
        jcfg, tcfg = _cfgs()
        tree = _perturbed_params(jcfg)
        _MODELS["f32"] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                          convert.params_from_jax(tcfg, tree, device=CPU))
    return _MODELS["f32"]


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


# -- config and weights ------------------------------------------------------


def test_full_width_param_count():
    cfg = tget(ARCH)
    assert cfg.param_count() == jget(ARCH).param_count() == 1_490_649_088
    model = tlm.LM(cfg, device="meta")
    d, r, n_layers = cfg.d_model, cfg.ddlerp_rank, cfg.num_layers
    n = sum(p.numel() for p in model.parameters())
    # param_count leaves out wg (d²), ddl_b (5rd), the f32 vectors of a
    # block (mu 5d, w0, u, ln_x, mu_c 2d: 10d) and ln_f (d)
    assert n == cfg.param_count() + n_layers * (d * d + 5 * r * d + 10 * d) \
        + d == 1_599_670_272
    blk = model.blocks[0]
    assert blk.rwkv.wr.dtype == torch.bfloat16
    for name in F32_LEAVES:
        assert getattr(blk.rwkv, name).dtype == torch.float32, name


def test_params_round_trip():
    _, params, tcfg, model = _models()
    back = convert.params_to_jax(tcfg, model)
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_params_keep_f32_leaves_in_bf16():
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    tree = _perturbed_params(jcfg, seed=1)
    model = convert.params_from_jax(tcfg, tree, device=CPU)
    p = model.blocks[1].rwkv
    src = tree["blocks"]["b0"]["rwkv"]
    for name in F32_LEAVES:
        assert getattr(p, name).dtype == torch.float32, name
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      src[name][1])
    assert p.wk.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(src["wk"][1]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(p.wk.float().numpy(), want)
    back = convert.params_to_jax(tcfg, model)["blocks"]["b0"]["rwkv"]
    for name in F32_LEAVES:
        np.testing.assert_array_equal(back[name], src[name])


def test_init_fills_the_reference_constants():
    cfg = tget(ARCH).reduced()
    model = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    p = model.blocks[0].rwkv
    assert torch.equal(p.mu, torch.full_like(p.mu, 0.5))
    assert torch.equal(p.w0, torch.full_like(p.w0, -6.0))
    assert torch.equal(p.u, torch.zeros_like(p.u))
    assert torch.equal(p.ln_x, torch.ones_like(p.ln_x))
    assert torch.equal(p.mu_c, torch.full_like(p.mu_c, 0.5))
    for w, fan_in in ((p.wr, cfg.d_model), (p.ddl_b, cfg.ddlerp_rank),
                      (p.dec_b, cfg.decay_rank), (p.cv, cfg.d_ff)):
        assert abs(float(w.float().std()) - fan_in ** -0.5) \
            < 0.25 * fan_in ** -0.5


def test_u_rounded_once_per_dtype_and_value(rng):
    """u reaches the recurrence rounded to the compute dtype, as the
    reference's ``u.astype(cd)``, but held in f32 and made once: the same
    tensor until u changes in place."""
    p = trwkv.RWKV(tget(ARCH).reduced(), device=CPU)
    with torch.no_grad():
        p.u.copy_(torch.from_numpy(rng.standard_normal(p.u.shape)
                                   .astype(np.float32)))
    assert p.u_rounded(torch.float32) is p.u
    got = p.u_rounded(torch.bfloat16)
    assert got.dtype == torch.float32
    assert torch.equal(got, p.u.to(torch.bfloat16).float())
    assert not torch.equal(got, p.u)
    assert p.u_rounded(torch.bfloat16) is got
    with torch.no_grad():
        p.u.mul_(2.0)
    again = p.u_rounded(torch.bfloat16)
    assert again is not got
    assert torch.equal(again, p.u.to(torch.bfloat16).float())


def test_cache_axes_and_dtypes_match_reference():
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    assert tlm.cache_axes(tcfg) == jlm.cache_axes(jcfg)
    tc = tlm.init_cache(tcfg, 3, 10, device=CPU)
    jc = jlm.init_cache(jcfg, 3, 10)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tc)
    assert got == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jc)
    assert all(t.dtype == torch.float32 for t in tc["blocks"]["b0"].values())


# -- the block's halves ------------------------------------------------------


def test_time_and_channel_mix_match_reference(rng):
    """One block's halves from a nonzero state and token shift: the
    kernel's module (``rwkv_time_mix`` through ``ops.wkv6``), the channel
    mix, and ``rwkv_block_apply``."""
    jcfg, params, tcfg, model = _models()
    jp = jax.tree.map(lambda a: a[1], params["blocks"]["b0"]["rwkv"])
    tp = model.blocks[1].rwkv
    b, s, d = 2, 7, tcfg.d_model
    h, hs = d // tcfg.rwkv_head_size, tcfg.rwkv_head_size
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    st = (rng.standard_normal((b, h, hs, hs)) * 0.3).astype(np.float32)
    last = rng.standard_normal((b, d)).astype(np.float32)
    out_j, st_j, x_j = jrwkv.rwkv_time_mix(jcfg, jp, jnp.asarray(x),
                                           jnp.asarray(st),
                                           jnp.asarray(last))
    state = torch.from_numpy(st.copy())
    out, st_t, x_t = trwkv.rwkv_time_mix(tcfg, tp, torch.from_numpy(x),
                                         state, torch.from_numpy(last))
    assert st_t is state
    _close(out, out_j)
    _close(state, st_j)
    _close(x_t, x_j)
    cm_j, _ = jrwkv.rwkv_channel_mix(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(last))
    cm, _ = trwkv.rwkv_channel_mix(tcfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(last))
    _close(cm, cm_j)
    jst = {"wkv": jnp.asarray(st), "tm_x": jnp.asarray(last),
           "cm_x": jnp.zeros((b, d))}
    tst = {"wkv": torch.from_numpy(st.copy()),
           "tm_x": torch.from_numpy(last), "cm_x": torch.zeros(b, d)}
    ob_j, nst_j = jrwkv.rwkv_block_apply(jcfg, jp, jnp.asarray(x), jst)
    ob, nst = trwkv.rwkv_block_apply(tcfg, tp, torch.from_numpy(x), tst)
    _close(ob, ob_j)
    for n in STATE:
        _close(nst[n], nst_j[n])


# -- logits and state --------------------------------------------------------


def test_forward_logits_match_reference(rng):
    jcfg, params, tcfg, model = _models()
    toks = _tokens(rng, tcfg, 2, 24)
    want, _ = jlm.forward_train(jcfg, params, {"tokens": jnp.asarray(toks)})
    _close(tlm.forward(tcfg, model, _t(toks)), want)


def test_prefill_logits_and_state_match_reference(rng):
    jcfg, params, tcfg, model = _models()
    toks = _tokens(rng, tcfg, 2, 16)
    want, jcache = jlm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                               cache_len=20)
    got, cache = tlm.prefill(tcfg, model, _t(toks), cache_len=20)
    _close(got, want)
    for n in STATE:
        assert cache["blocks"]["b0"][n].dtype == torch.float32
        _close(cache["blocks"]["b0"][n], jcache["blocks"]["b0"][n])


def test_decode_logits_and_state_match_reference(rng):
    jcfg, params, tcfg, model = _models()
    toks = _tokens(rng, tcfg, 2, 21)
    _, jcache = jlm.prefill(jcfg, params,
                            {"tokens": jnp.asarray(toks[:, :16])},
                            cache_len=21)
    _, cache = tlm.prefill(tcfg, model, _t(toks[:, :16]), cache_len=21)
    for i in range(16, 21):
        want, jcache = jlm.decode_step(jcfg, params, jcache,
                                       jnp.asarray(toks[:, i]), i)
        got, cache = tlm.decode_step(tcfg, model, cache, _t(toks[:, i]), i)
        _close(got, want)
        for n in STATE:
            _close(cache["blocks"]["b0"][n], jcache["blocks"]["b0"][n])


def test_prefill_decode_consistency(rng):
    """Prefill + decode == the teacher-forced forward, within the JAX
    package's own tolerance (tests/test_models.py)."""
    _, _, tcfg, model = _models()
    b, s, extra = 2, 16, 4
    toks = _t(_tokens(rng, tcfg, b, s + extra))
    full = tlm.forward(tcfg, model, toks)
    lg, cache = tlm.prefill(tcfg, model, toks[:, :s], cache_len=s + extra)
    errs = [float((lg - full[:, s - 1]).abs().max())]
    for i in range(extra):
        lg, cache = tlm.decode_step(tcfg, model, cache, toks[:, s + i],
                                    s + i)
        errs.append(float((lg - full[:, s + i]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_bf16_against_its_f32_upcast(rng):
    """The served dtype: the bf16 model against the same weights upcast
    to f32, prefill and three decode steps, in relative L2.  Every matmul
    input and the recurrence's r, k, v, w and u round to bf16, w near 1
    to steps of 2⁻⁸, through two layers: 1.9e-2 to 5.2e-2 for weights and
    tokens from seeds 0-3.  Dropping u (the f32 model without it, against
    the f32 model) reads 0.34 to 0.55 there.  The limit, 1e-1, lies
    between the two."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    model = convert.params_from_jax(tcfg, _perturbed_params(jcfg),
                                    device=CPU)
    m32 = copy.deepcopy(model).float()
    toks = _t(_tokens(rng, tcfg, 2, 24))
    got, cache = tlm.prefill(tcfg, model, toks[:, :20], cache_len=24)
    want, cache32 = tlm.prefill(tcfg, m32, toks[:, :20], cache_len=24)
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    errs = [_rel(got, want)]
    for i in range(20, 23):
        got, cache = tlm.decode_step(tcfg, model, cache, toks[:, i], i)
        want, cache32 = tlm.decode_step(tcfg, m32, cache32, toks[:, i], i)
        errs.append(_rel(got, want))
    assert max(errs) < 1e-1, errs
    want, _ = tlm.prefill(tcfg, m32, toks[:, :20], cache_len=24)
    for blk in m32.blocks:
        blk.rwkv.u.zero_()
    no_u, _ = tlm.prefill(tcfg, m32, toks[:, :20], cache_len=24)
    assert _rel(no_u, want) > 1e-1


# -- serving -----------------------------------------------------------------


def test_generate_matches_reference(rng):
    jcfg, params, tcfg, model = _models()
    prompts = rng.integers(2, tcfg.vocab_size, (3, 8)).astype(np.int32)
    want = jserve.generate(jcfg, params, jnp.asarray(prompts),
                           max_new_tokens=6)
    got = tserve.generate(tcfg, model, prompts, max_new_tokens=6)
    assert got.shape == (3, 14) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("slots,cache_len,lens,max_new", [
    (3, 32, (8, 5, 7), 6), (2, 24, (6, 3, 6, 4, 5), 4)])
def test_ragged_serve_loop_matches_reference(slots, cache_len, lens,
                                             max_new, rng):
    """Ragged prompts, left-padded with token 0 that runs through the
    recurrence, as in the JAX package; waves and oversubscription: every
    request's tokens equal the JAX package's ServeLoop's."""
    jcfg, params, tcfg, model = _models()
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    loops = (jserve.ServeLoop(jcfg, params, num_slots=slots,
                              cache_len=cache_len),
             tserve.ServeLoop(tcfg, model, num_slots=slots,
                              cache_len=cache_len))
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
    assert all(t.dtype == torch.float32
               for t in loops[1].cache["blocks"]["b0"].values())


def test_serve_loop_matches_static_bf16(rng):
    """In bf16, the requests of a wave equal the static batch of the same
    prompts: the slot surgery copies the f32 state without rounding."""
    cfg = tget(ARCH).reduced()
    model = tlm.init(cfg, torch.Generator().manual_seed(0), device=CPU)
    prompts = rng.integers(2, cfg.vocab_size, (4, 12)).astype(np.int32)
    static = tserve.generate(cfg, model, prompts, max_new_tokens=8)
    sl = tserve.ServeLoop(cfg, model, num_slots=4, cache_len=20)
    reqs = [tserve.Request(rid=i, prompt=prompts[i], max_new=8)
            for i in range(4)]
    for r in reqs:
        sl.submit(r)
    sl.run()
    for i, r in enumerate(reqs):
        assert r.generated == static[i, 12:].tolist(), i


def test_prefill_and_decode_on_cpu_never_launch(rng):
    _, _, tcfg, model = _models()
    twkv.reset_launch_counts()
    toks = _t(_tokens(rng, tcfg, 2, 8))
    _, cache = tlm.prefill(tcfg, model, toks, cache_len=9)
    tlm.decode_step(tcfg, model, cache, toks[:, 0], 8)
    assert twkv.launch_counts["wkv6"] == 0


@pytest.mark.parametrize("mode", ["static", "continuous"])
def test_launch_serve_cli(mode):
    out = tlaunch.main(["--arch", ARCH, "--device", "cpu", "--mode", mode,
                        "--requests", "3", "--slots", "2", "--prompt-len",
                        "6", "--max-new", "4"])
    if mode == "static":
        assert out.shape == (3, 10)
    else:
        assert all(r.done and len(r.generated) == 4 for r in out)
