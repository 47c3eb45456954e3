"""The port's loss and gradients vs ``jax.value_and_grad`` of the JAX
package's ``lm.loss_fn``, for every architecture the port trains.

Reduced configs in f32 compute, where the reference's ``cast_low`` tree
is its f32 parameters: the port starts from that tree
(``convert.masters_from_jax``) and takes ``train.step.make_grad_fn``'s
gradients (the working model, remat on as in the configs).  A batch of 2
x 32 tokens with a random loss mask; the vision and audio models get
their frontend stubs from the seed, and their ``gate``/``gate_mlp``
drawn in [0.5, 1.5) (0 at init would hide the cross path's gradients).
Loss and its metrics within 1e-5 relative, every parameter's gradient
within 1e-4 relative L2 (summation order through two layers, forward and
backward), and nonzero.  rwkv6-1.6b and recurrentgemma-9b train through
their scans' autograd Functions (``wkv6_train``, ``rg_lru_scan``), whose
CPU path runs the plain backwards the card's kernels are held to.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

TRAINED = list(ARCH_IDS)
LOSS_TOL = 1e-5
GRAD_REL_L2 = 1e-4


def test_every_arch_but_the_scans_trains():
    """Every architecture trains, the scan families included (the name
    is older than their training): each reduced config builds a train
    step, and every block kind is held to the reference below."""
    from repro_torch.train import optimizer as topt
    assert TRAINED == list(ARCH_IDS)
    kinds = set()
    for arch in ARCH_IDS:
        cfg = tget(arch).reduced()
        kinds.update(tlm.layer_kinds(cfg))
        assert callable(tstep.make_train_step(
            cfg, topt.AdamW(lr=lambda c: 1e-3), device="cpu"))
    assert {"rwkv", "recurrent", "local_attn"} <= kinds


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _draw_gates(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw_gates(v, rng)
        elif k in ("gate", "gate_mlp"):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_match_reference(arch, rng):
    over = {"compute_dtype": "float32"}
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    params, _ = jlm.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    _draw_gates(tree, rng)
    b, s = 2, 32
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (b, s)).astype(
                 np.int32),
             "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    if jcfg.img_seq:
        batch["img_embeds"] = rng.standard_normal(
            (b, jcfg.img_seq, jcfg.d_model)).astype(np.float32)
    if jcfg.encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (b, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)

    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    masters = convert.masters_from_jax(tcfg, tree, device="cpu")
    loss, metrics, grads = tstep.make_grad_fn(tcfg, device="cpu")(masters,
                                                                   batch)

    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    for k in ("ce", "zloss", "aux", "ppl"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    if "moe" in tlm.layer_kinds(tcfg):
        assert float(metrics["aux"]) > 0
    want = dict(T.items(jax.tree.map(np.asarray, jg)))
    assert want.keys() == dict(T.items(grads)).keys()
    for path, g in T.items(grads):
        name = "/".join(path)
        assert g.dtype == torch.float32, name
        assert float(g.abs().sum()) > 0, name
        assert _rel_l2(g.numpy(), want[path]) < GRAD_REL_L2, name


@pytest.mark.parametrize("arch,over", [
    ("dbrx-132b", {"capacity_factor": 0.5}),          # pairs dropped
    ("dbrx-132b", {}),
    # a shared expert; top 2, since at its top 1 the output's gradient
    # to the router is x / x's, 0 up to each framework's rounding
    ("llama4-maverick-400b-a17b", {"top_k": 2}),
])
def test_moe_dispatch_carries_gradients(arch, over, rng):
    """``moe_apply``'s output and aux loss differentiated through the
    dispatch (``index_copy_`` into the capacity buffer) and the gather
    back: the gradients of x, the router and every expert leaf against
    ``jax.grad`` of the reference's ``moe_apply``, 1e-4 relative L2."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    over = {"compute_dtype": "float32", **over}
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jcfg, jax.random.PRNGKey(3))[0])
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, info = jmoe.moe_apply(jcfg, p, x)
        return jnp.sum(out * w) + info["aux_loss"], info["frac_dropped"]

    (_, dropped), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    m = tmoe.MoE(tcfg, device="cpu")
    with torch.no_grad():
        for name, param in m.named_parameters():
            param.copy_(torch.from_numpy(np.asarray(T.get(
                p, tuple(name.split("."))), np.float32)))
            param.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, info = tmoe.moe_apply(tcfg, m, tx)
    (out * torch.from_numpy(w)).sum().add(info["aux_loss"]).backward()
    if "capacity_factor" in over:
        assert float(dropped) > 0.1
    assert _rel_l2(tx.grad.numpy(), jgx) < GRAD_REL_L2
    for name, param in m.named_parameters():
        want = T.get(jax.tree.map(np.asarray, jgp), tuple(name.split(".")))
        assert float(param.grad.abs().sum()) > 0, name
        assert _rel_l2(param.grad.numpy(), want) < GRAD_REL_L2, name
