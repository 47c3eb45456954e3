"""The port's LM at the published head geometry of the three models
``chip_smoke.py`` serves at a cut, vs the JAX package's, on the CPU.

``tests/test_torch_lm.py`` runs these families at ``reduced()``'s heads
(4 of 16, group 2).  Here each case keeps the model's own heads and
narrows the rest (d_model 128, 2 layers, vocab 512, prompts of 64):

- chatglm3-6b: 32 heads of 128 over 2 kv heads (group 16), RoPE on half
  of each head (``rope_fraction`` 0.5);
- nemotron-4-340b: 24 heads of 192 over 2 kv heads (group 12, the
  model's 96 / 8), squared ReLU;
- llama4-maverick-400b-a17b: 10 heads of 128 over 2 kv heads (group 5,
  the model's 40 / 8), one dense and one MoE layer of 32 experts, top 1,
  a shared expert, groups of 64 tokens: capacity 2 an expert, so pairs
  drop at prefill.

The port's ``lm.init`` weights (a seeded generator) go to the JAX
package through ``convert.params_to_jax`` (its ``lm.init`` takes seconds
a model here), tokens come from a numpy seed, and both compute in
float32: the prefill's logits and 4 greedy decode steps' agree within
``tests/test_torch_lm.py``'s 1e-4 and the greedy tokens are equal.  The
reference's decode step is jitted once a model (eagerly it takes half a
second a step).

The parameter counts ``chip_smoke.py`` holds its cuts to are checked
against both packages' ``param_count()`` at the same cut.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4       # tests/test_torch_lm.py's
BATCH, PROMPT, STEPS = 2, 64, 4
NARROW = dict(num_layers=2, d_model=128, vocab_size=512, d_ff=256,
              max_seq=128, compute_dtype="float32")
# arch: the published head geometry kept, the rest narrowed
GEOMETRY = {
    "chatglm3-6b": dict(num_heads=32, num_kv_heads=2, head_dim=128),
    "nemotron-4-340b": dict(num_heads=24, num_kv_heads=2, head_dim=192),
    "llama4-maverick-400b-a17b": dict(num_heads=10, num_kv_heads=2,
                                      head_dim=128, num_experts=32,
                                      moe_group_size=64),
}


def _cfgs(arch):
    over = {**NARROW, **GEOMETRY[arch]}
    return (dataclasses.replace(jget(arch), **over),
            dataclasses.replace(tget(arch), **over))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


class _routes:
    """Records the port's ``moe.router`` calls within the block."""

    def __enter__(self):
        self.saved, self.calls = tmoe.router, []

        def record(*args, **kwargs):
            r = self.saved(*args, **kwargs)
            self.calls.append(r)
            return r

        tmoe.router = record
        return self

    def __exit__(self, *exc):
        tmoe.router = self.saved


@pytest.mark.parametrize("arch", list(GEOMETRY))
def test_prefill_and_decode_match_reference_at_published_heads(arch):
    jcfg, tcfg = _cfgs(arch)
    group = tcfg.num_heads // tcfg.num_kv_heads
    assert group == {"chatglm3-6b": 16, "nemotron-4-340b": 12,
                     "llama4-maverick-400b-a17b": 5}[arch]
    model = tlm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree.map(jnp.asarray, convert.params_to_jax(tcfg, model))
    decode = jax.jit(functools.partial(jlm.decode_step, jcfg))
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    cache_len = PROMPT + STEPS

    want, jcache = jlm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                               cache_len=cache_len)
    with _routes() as routes:
        got, cache = tlm.prefill(tcfg, model, torch.as_tensor(
            toks, dtype=torch.long), cache_len=cache_len)
    _close(got, want)
    if tcfg.num_experts:
        assert tmoe.capacity(tcfg, tcfg.moe_group_size, False) == 2
        assert len(routes.calls) == 1
        assert not bool(routes.calls[0].keep.all()), "no pair dropped"

    jtok, ttok = jnp.argmax(want, -1), got.argmax(-1)
    for i in range(STEPS):
        assert ttok.tolist() == np.asarray(jtok).tolist(), i
        want, jcache = decode(params, jcache, jtok, jnp.int32(PROMPT + i))
        got, cache = tlm.decode_step(tcfg, model, cache, ttok, PROMPT + i)
        _close(got, want)
        jtok, ttok = jnp.argmax(want, -1), got.argmax(-1)
    assert ttok.tolist() == np.asarray(jtok).tolist()


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CUT_PARAM_COUNTS = _load_chip_smoke().CUT_PARAM_COUNTS


@pytest.mark.parametrize("cut", list(CUT_PARAM_COUNTS),
                         ids=lambda c: "-".join(map(str, c)))
def test_cut_param_counts_match_both_packages(cut):
    """chip_smoke.py's parameter count of each served or gated cut, (arch,
    layers, experts or None for all), is ``param_count()`` of both
    packages' config at that cut."""
    arch, layers, experts = cut
    over = {"num_layers": layers}
    if experts is not None:
        over["num_experts"] = experts
    for get in (jget, tget):
        assert dataclasses.replace(get(arch), **over).param_count() == \
            CUT_PARAM_COUNTS[cut]
