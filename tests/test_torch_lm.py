"""The port's LM stack and serving vs the JAX package's, on the CPU.

Reduced configs (2 layers, d_model 64, 4 heads of 16, 2 kv heads, vocab
512) of the dense GQA families the port builds: granite-3-2b (SwiGLU),
chatglm3-6b (RoPE on half the head dim) and nemotron-4-340b (squared
ReLU); of the MoE families: dbrx-132b (every layer MoE, 4 experts top 2,
group 64) and llama4-maverick-400b-a17b (4 layers, attn and moe
alternating, top 1 with a shared expert); and of MLA: minicpm3-4b
(q_lora and kv_lora 16, nope 8, rope 8, v_head 16).  The JAX package's
``lm.init`` weights go through
``convert.params_from_jax``, and both packages compute in float32:
logits agree to 1e-4 (summation order through two layers; logits are
O(1)).  Greedy tokens are compared in float32 too, where the two
frameworks' bf16 roundings cannot flip a near tie; they must be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jserve  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import engine as tserve  # noqa: E402

ARCHS = ["granite-3-2b", "chatglm3-6b", "nemotron-4-340b", "dbrx-132b",
         "llama4-maverick-400b-a17b", "minicpm3-4b"]
MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
# generate and ServeLoop: one model of each kind of block
SERVE_ARCHS = ["granite-3-2b", "dbrx-132b", "llama4-maverick-400b-a17b",
               "minicpm3-4b"]
# rwkv6-1.6b, recurrentgemma-9b, llama-3.2-vision-11b and whisper-tiny are
# ported too: tests/test_torch_rwkv.py, tests/test_torch_griffin.py,
# tests/test_torch_crossattn.py
CROSS_ARCHS = ["llama-3.2-vision-11b", "whisper-tiny"]
LOGIT_TOL = 1e-4
CPU = "cpu"

_MODELS = {}


def _cfgs(arch, **over):
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


def _models(arch):
    """(jax cfg, jax params, port cfg, port model), f32 compute."""
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        params, _ = jlm.init(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        _MODELS[arch] = (jcfg, params, tcfg,
                         convert.params_from_jax(tcfg, tree, device=CPU))
    return _MODELS[arch]


def _tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    j, t = jget(arch), tget(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.param_count() == j.param_count()


def test_granite_full_width_param_count():
    cfg = tget("granite-3-2b")
    model = tlm.LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    # param_count counts the two norms of each layer but not ln_f
    assert n == cfg.param_count() + cfg.d_model == 2_533_531_648
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks[0].ln1.scale.dtype == torch.float32


# -- weights -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    _, params, tcfg, model = _models(arch)
    back = convert.params_to_jax(tcfg, model)
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_params_cast_once_to_compute_dtype():
    jcfg, tcfg = _cfgs("granite-3-2b", compute_dtype="bfloat16")
    params, _ = jlm.init(jcfg, jax.random.PRNGKey(1))
    model = convert.params_from_jax(
        tcfg, jax.tree.map(np.asarray, params), device=CPU)
    assert model.blocks[1].attn.wq.dtype == torch.bfloat16
    want = np.asarray(params["blocks"]["b0"]["attn"]["wq"][1]
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(model.blocks[1].attn.wq.float().numpy(),
                                  want)
    assert model.ln_f.scale.dtype == torch.float32


def test_init_is_seeded():
    cfg = tget("granite-3-2b").reduced()
    a = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    b = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    w = a.blocks[0].attn.wq.float()
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.02


# -- logits ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    toks = _tokens(rng, tcfg, 2, 24)
    want, _ = jlm.forward_train(jcfg, params, {"tokens": jnp.asarray(toks)})
    _close(tlm.forward(tcfg, model, _t(toks)), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    toks = _tokens(rng, tcfg, 2, 16)
    want, jcache = jlm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                               cache_len=20)
    got, cache = tlm.prefill(tcfg, model, _t(toks), cache_len=20)
    _close(got, want)
    for key, leaves in jcache["blocks"].items():
        assert set(cache["blocks"][key]) == set(leaves)
        for n, leaf in leaves.items():
            _close(cache["blocks"][key][n], leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    toks = _tokens(rng, tcfg, 2, 19)
    _, jcache = jlm.prefill(jcfg, params,
                            {"tokens": jnp.asarray(toks[:, :16])},
                            cache_len=19)
    _, cache = tlm.prefill(tcfg, model, _t(toks[:, :16]), cache_len=19)
    for i in range(16, 19):
        want, jcache = jlm.decode_step(jcfg, params, jcache,
                                       jnp.asarray(toks[:, i]), i)
        got, cache = tlm.decode_step(tcfg, model, cache, _t(toks[:, i]), i)
        _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, rng):
    """Prefill + decode == the teacher-forced forward, within the JAX
    package's own tolerance (tests/test_models.py), which also sets the
    MoE capacity factor to 64 so that no token drops in either."""
    _, _, tcfg, model = _models(arch)
    tcfg = dataclasses.replace(tcfg, capacity_factor=64.0)
    b, s, extra = 2, 16, 3
    toks = _t(_tokens(rng, tcfg, b, s + extra))
    full = tlm.forward(tcfg, model, toks)
    lg, cache = tlm.prefill(tcfg, model, toks[:, :s], cache_len=s + extra)
    errs = [float((lg - full[:, s - 1]).abs().max())]
    for i in range(extra):
        lg, cache = tlm.decode_step(tcfg, model, cache, toks[:, s + i],
                                    s + i)
        errs.append(float((lg - full[:, s + i]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_decode_past_cache_end_writes_nothing(rng):
    """The JAX package's one-hot write drops a position >= S; so does the
    port's in-place write."""
    _, _, tcfg, model = _models("granite-3-2b")
    toks = _t(_tokens(rng, tcfg, 2, 8))
    _, cache = tlm.prefill(tcfg, model, toks, cache_len=8)
    before = {n: t.clone() for n, t in cache["blocks"]["b0"].items()}
    tlm.decode_step(tcfg, model, cache, toks[:, 0], torch.tensor([8, 3]))
    after = cache["blocks"]["b0"]
    for n in ("k", "v"):
        assert torch.equal(after[n][:, 0], before[n][:, 0])
        assert not torch.equal(after[n][:, 1, 3], before[n][:, 1, 3])


def test_cache_axes_match_reference():
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        assert tlm.cache_axes(tcfg) == jlm.cache_axes(jcfg)
        tc = tlm.init_cache(tcfg, 3, 10, device=CPU)
        jc = jlm.init_cache(jcfg, 3, 10)
        got = jax.tree.map(lambda t: tuple(t.shape), tc)
        assert got == jax.tree.map(lambda a: tuple(a.shape), jc)


# -- serving -----------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_generate_matches_reference(arch, rng):
    jcfg, params, tcfg, model = _models(arch)
    prompts = rng.integers(2, tcfg.vocab_size, (3, 8)).astype(np.int32)
    want = jserve.generate(jcfg, params, jnp.asarray(prompts),
                           max_new_tokens=6)
    got = tserve.generate(tcfg, model, prompts, max_new_tokens=6)
    assert got.shape == (3, 14) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_stops_at_eos(rng):
    _, _, tcfg, model = _models("granite-3-2b")
    prompts = rng.integers(2, tcfg.vocab_size, (2, 8)).astype(np.int32)
    free = tserve.generate(tcfg, model, prompts, max_new_tokens=6)
    eos = int(free[0, 8])
    got = tserve.generate(tcfg, model, prompts, max_new_tokens=6, eos=eos)
    assert got.shape == free.shape
    if (free[1, 8:] == eos).any():
        pytest.skip("both rows hit eos at once")
    np.testing.assert_array_equal(got[:, :9], free[:, :9])


def test_temperature_sampling_uses_generator(rng):
    _, _, tcfg, model = _models("granite-3-2b")
    prompts = rng.integers(2, tcfg.vocab_size, (2, 8)).astype(np.int32)
    runs = [tserve.generate(tcfg, model, prompts, max_new_tokens=5,
                            temperature=1.0,
                            generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].min() >= 0 and runs[0].max() < tcfg.vocab_size


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("slots,cache_len,n,plen,max_new", [
    (3, 32, 2, 8, 6), (2, 24, 5, 6, 4)])
def test_serve_loop_matches_reference(slots, cache_len, n, plen, max_new,
                                      arch, rng):
    """Slot surgery, waves and oversubscription: every request's tokens
    equal the JAX package's ServeLoop's (bf16 cache, as there)."""
    jcfg, params, tcfg, model = _models(arch)
    prompts = rng.integers(2, tcfg.vocab_size, (n, plen)).astype(np.int32)
    loops = (jserve.ServeLoop(jcfg, params, num_slots=slots,
                              cache_len=cache_len),
             tserve.ServeLoop(tcfg, model, num_slots=slots,
                              cache_len=cache_len))
    out = []
    for sl, mod in zip(loops, (jserve, tserve)):
        reqs = [mod.Request(rid=i, prompt=prompts[i], max_new=max_new)
                for i in range(n)]
        for r in reqs:
            sl.submit(r)
        steps = sl.run()
        assert all(r.done and len(r.generated) == max_new for r in reqs)
        out.append((steps, [r.generated for r in reqs]))
    assert out[1] == out[0]


def test_serve_loop_matches_static_bf16(rng):
    """As examples/serve_lm.py: in bf16, the requests of a wave equal the
    static batch of the same prompts."""
    cfg = tget("granite-3-2b").reduced()
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


def test_prefill_on_cpu_never_launches(rng):
    _, _, tcfg, model = _models("granite-3-2b")
    tfa.reset_launch_counts()
    tlm.prefill(tcfg, model, _t(_tokens(rng, tcfg, 2, 8)), cache_len=8)
    assert tfa.launch_counts["flash_attention"] == 0


@pytest.mark.parametrize("mode", ["static", "continuous"])
def test_launch_serve_cli(mode):
    out = tlaunch.main(["--device", "cpu", "--mode", mode, "--requests",
                        "3", "--slots", "2", "--prompt-len", "6",
                        "--max-new", "4"])
    if mode == "static":
        assert out.shape == (3, 10)
    else:
        assert all(r.done and len(r.generated) == 4 for r in out)


# -- every config builds; an unknown block kind does not -------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds(arch):
    cfg = tget(arch).reduced()
    model = tlm.LM(cfg, device="meta")
    assert len(model.blocks) == cfg.num_layers
    assert set(tlm.init_cache(cfg, 1, 8, device="meta")) >= {"blocks"}


def test_unknown_block_kind_raises():
    cfg = tget("granite-3-2b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcache.check_ported(cfg, "mamba")
    bad = dataclasses.replace(cfg, block_pattern=("attn", "mamba"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlm.LM(bad, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlm.init_cache(bad, 1, 8, device="meta")


@pytest.mark.parametrize("arch", SERVE_ARCHS + CROSS_ARCHS)
def test_entry_points_need_cuda_without_device(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init(tget(arch))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", arch])
