"""The port's MoE layer (``repro_torch.models.moe``) vs the JAX package's,
on the CPU in float32.

Reduced dbrx-132b (4 experts, top 2, group 64, SwiGLU) and reduced
llama4-maverick-400b-a17b (4 experts, top 1, a shared expert), with the
reference's ``moe_init`` weights copied into the port's module.  Cases:
dropless, forced drops (capacity factor 0.5), a remainder (B·S not a
multiple of the group), B·S below the group size, and planted gate ties
(two equal router columns; a zero router, where every gate ties).  The
routing must be the reference's exactly: top-k indices, GShard positions,
kept pairs, slots, the dropped fraction and the expert load; ``out``
within 1e-5 (the expert products' summation order) and ``aux_loss``
within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402,F401 (import order)
from repro_torch.models import moe as tmoe  # noqa: E402

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
OUT_TOL, AUX_TOL = 1e-5, 1e-6

# name: (B, S, dropless, config overrides, router edit)
CASES = {
    "dropless": (2, 64, True, {}, None),
    "drops": (2, 64, False, {"capacity_factor": 0.5}, None),
    "remainder": (3, 50, False, {}, None),        # 150 = 2 groups + 22
    "below_group": (2, 20, False, {}, None),      # one group of 40
    "tie_columns": (2, 64, False, {}, "columns"),
    "tie_all": (2, 64, False, {"capacity_factor": 0.5}, "zero"),
}


def _setup(arch, over, edit, seed=0):
    over = {"compute_dtype": "float32", **over}
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    p, _ = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    p = jax.tree.map(np.asarray, p)
    router = np.array(p["router"])
    if edit == "columns":      # experts 1 and 3 tie on every token
        router[:, 3] = router[:, 1]
    elif edit == "zero":       # every gate 1/E
        router[:] = 0.0
    p["router"] = router
    m = tmoe.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for name, param in m.named_parameters():
            leaf = p
            for k in name.split("."):
                leaf = leaf[k]
            param.copy_(torch.from_numpy(np.asarray(leaf, np.float32)))
    return jcfg, p, tcfg, m


def _jax_routes(cfg, p, x, dropless):
    """The reference's routing, as ``src/repro/models/moe.py:89-108``
    computes it inside ``moe_apply`` (which does not return it)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gs = min(cfg.moe_group_size, b * s)
    tokens = x.reshape(-1, d)
    ng = tokens.shape[0] // gs
    xt = tokens[: ng * gs].reshape(ng, gs, d)
    logits = jnp.einsum("gsd,de->gse", xt.astype(jnp.float32), p["router"])
    gates = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(gates, k)
    cap = gs if dropless else int(max(1, gs * k * cfg.capacity_factor / e))
    oh = jax.nn.one_hot(topi, e, dtype=jnp.float32)
    flat = oh.transpose(0, 2, 1, 3).reshape(ng, k * gs, e)
    pos_flat = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos_flat.reshape(ng, k, gs, e).transpose(0, 2, 1, 3)
                  * oh, axis=-1).astype(jnp.int32)
    keep = pos < cap
    slot = jnp.where(keep, topi * cap + pos, e * cap)
    return {"topi": topi, "pos": pos, "keep": keep, "slot": slot,
            "cap": cap, "xt": xt}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, case):
    b, s, dropless, over, edit = CASES[case]
    jcfg, p, tcfg, m = _setup(arch, over, edit)
    x = np.random.default_rng(1).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_apply(jcfg, p, jnp.asarray(x), dropless=dropless)
    got, taux = tmoe.moe_apply(tcfg, m, torch.from_numpy(x),
                               dropless=dropless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=AUX_TOL,
                               atol=AUX_TOL)
    assert float(taux["frac_dropped"]) == float(jaux["frac_dropped"])
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))

    jr = _jax_routes(jcfg, p, jnp.asarray(x), dropless)
    tr = tmoe.router(tcfg, m, torch.from_numpy(np.asarray(jr["xt"])),
                     dropless)
    assert tr.cap == jr["cap"]
    for name in ("topi", "pos", "keep", "slot"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(jr[name]), err_msg=name)
    if case == "drops":
        assert 0 < float(taux["frac_dropped"]) < 1
    if case == "remainder":   # the tail tokens' output is their input
        tail = b * s - (b * s) // 64 * 64
        np.testing.assert_array_equal(
            got.reshape(-1, tcfg.d_model)[-tail:].numpy(),
            x.reshape(-1, tcfg.d_model)[-tail:])


def test_ties_take_the_lower_expert_first():
    """Every gate equal: the top-k are experts 0..k-1 in order, as
    ``lax.top_k`` gives (``torch.topk`` on the CPU does not)."""
    _, _, tcfg, m = _setup("dbrx-132b", {}, "zero")
    xt = torch.randn((1, 8, tcfg.d_model), generator=torch.Generator()
                     .manual_seed(0))
    r = tmoe.router(tcfg, m, xt)
    assert torch.equal(r.topi, torch.arange(tcfg.top_k).expand(1, 8, -1))
    # GShard priority: the 8 first choices fill expert 0's slots 0..7
    assert torch.equal(r.pos[0, :, 0], torch.arange(8))


def test_capacity_matches_reference_float_arithmetic():
    cfg = tget("dbrx-132b")
    assert tmoe.capacity(cfg, 1024, False) == 320      # 1024·4·1.25/16
    assert tmoe.capacity(cfg, 4, True) == 4
    small = dataclasses.replace(cfg, capacity_factor=0.001)
    assert tmoe.capacity(small, 4, False) == 1         # max(1, ·)
