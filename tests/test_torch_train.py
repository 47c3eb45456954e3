"""The port's training half vs the JAX package's, on the CPU.

Optimizers (AdamW, Adafactor, the global-norm clip, ``warmup_cosine``)
take the same seeded numpy parameters and gradients in both packages and
must agree to rtol 1e-6 over three steps, their slice-by-slice update of
large leaves included.  One ``make_train_step`` step on reduced configs
in f32 compute, from the JAX package's ``lm.init`` tree
(``convert.masters_from_jax``), against the reference's step: loss 1e-5
relative, every updated master leaf 1e-4 relative L2 (at AdamW's first
step the update is lr · g / (|g| + eps), so a gradient element near eps
moves by up to lr: a relative L2 over the leaf, not an elementwise
limit), accumulation over 2 microbatches too.  The synthetic corpus gives
the same batches bit for bit; the int8 compression the same codes.  The
loss and every parameter's gradient of each architecture are held to
``jax.value_and_grad`` in tests/test_torch_train_grads.py.

The kernel's autograd wrapper and the train step on the card are in
tests/test_torch_train_attention.py, which needs no jax.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import compress as jcomp  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.train import compress as tcomp  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

CPU = "cpu"
OPT_RTOL = 1e-6
LOSS_TOL = 1e-5
PARAM_REL_L2 = 1e-4


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(tree):
    return T.tree_map(lambda t: t.detach().float().cpu().numpy()
                      if torch.is_tensor(t) else np.asarray(t), tree)


def _jnp(tree):
    return T.tree_map(jnp.asarray, tree)


def _t(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_tree(got, want, rtol=OPT_RTOL, atol=0.0):
    want = dict(T.items(jax.tree.map(np.asarray, want)))
    for path, g in T.items(_np(got)):
        np.testing.assert_allclose(g, want[path], rtol=rtol, atol=atol,
                                   err_msg="/".join(path))


# -- schedules, clipping ------------------------------------------------------


@pytest.mark.parametrize("base,warmup,total,final", [
    (1.0, 10, 100, 0.1), (3e-3, 0, 7, 0.1), (2e-3, 5, 40, 0.0)])
def test_warmup_cosine_matches_reference(base, warmup, total, final):
    jl = jopt.warmup_cosine(base, warmup, total, final)
    tl = topt.warmup_cosine(base, warmup, total, final)
    for step in range(total + 3):
        np.testing.assert_allclose(float(tl(step)), float(jl(step)),
                                   rtol=OPT_RTOL, atol=1e-12)
        assert tl(torch.tensor(step, dtype=torch.int32)).dtype == \
            torch.float32


def _grads(rng, shapes, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("max_norm", [1e9, 1.0, 0.05])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(max_norm, dtype, rng):
    g = _grads(rng, {"a": (7, 5), "b": (3,), "d": (2, 4, 6)})
    jg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
    tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in g.items()}
    jc, jn = jopt.clip_by_global_norm(jg, max_norm)
    tc, tn = topt.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    for k in g:
        assert tc[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(jc[k], np.float32))


# -- optimizers ---------------------------------------------------------------

SHAPES = {"embed": (48, 8), "blocks": {"b0": {"w": (3, 8, 6),
                                              "scale": (3, 8)}},
          "ln_f": {"scale": (8,)}}


def _tree_of(rng, shapes, scale=1.0):
    return T.tree_map(lambda s: (scale * rng.standard_normal(s)).astype(
        np.float32), shapes)


def _run_both(jo, to, rng, steps=3, grad_dtype="float32"):
    params = _tree_of(rng, SHAPES)
    jp, tp = _jnp(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(steps):
        g = _tree_of(rng, SHAPES, 0.3)
        jp, js, jm = jo.update(T.tree_map(
            lambda a: jnp.asarray(a).astype(grad_dtype), g), js, jp)
        tp, ts, tm = to.update(T.tree_map(
            lambda a: torch.from_numpy(a).to(getattr(torch, grad_dtype)),
            g), ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=OPT_RTOL)
    return jp, js, tp, ts


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [None, 40])
def test_adamw_matches_reference(grad_dtype, chunk, rng, monkeypatch):
    """Three steps on a stacked leaf, a matrix and vectors; ``chunk``
    sends every leaf above 40 elements through the slice-by-slice
    update."""
    if chunk:
        monkeypatch.setattr(topt, "_CHUNK_UPDATE_ELEMS", chunk)
    lr = jopt.warmup_cosine(1e-2, 1, 5)
    jo = jopt.AdamW(lr=lr, weight_decay=0.1, clip=1.0)
    to = topt.AdamW(lr=topt.warmup_cosine(1e-2, 1, 5), weight_decay=0.1,
                    clip=1.0)
    jp, js, tp, ts = _run_both(jo, to, rng, grad_dtype=grad_dtype)
    _close_tree(tp, jp)
    _close_tree({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]},
                atol=1e-12)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["count"].dtype == torch.int32


def test_adamw_slices_give_the_same_bits(rng, monkeypatch):
    lr = topt.warmup_cosine(1e-2, 1, 5)
    outs = []
    for chunk in (topt._CHUNK_UPDATE_ELEMS, 40, 1):
        monkeypatch.setattr(topt, "_CHUNK_UPDATE_ELEMS", chunk)
        r = np.random.default_rng(5)
        params = _t(_tree_of(r, SHAPES))
        opt = topt.AdamW(lr=lr)
        st = opt.init(params)
        for _ in range(2):
            params, st, _ = opt.update(_t(_tree_of(r, SHAPES, 0.3)), st,
                                       params)
        outs.append(params)
    for other in outs[1:]:
        for a, b in zip(T.leaves(outs[0]), T.leaves(other)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [None, 40])
def test_adafactor_matches_reference(chunk, rng, monkeypatch):
    """Factored stats of the stacked leaf and the matrices, an unfactored
    vector, the update-RMS clip (0.5: the first steps' RMS is about 1)
    and weight decay; ``chunk`` takes the stacked leaf slice by slice."""
    if chunk:
        monkeypatch.setattr(topt, "_CHUNK_UPDATE_ELEMS", chunk)
    kw = dict(clip_update=0.5, weight_decay=0.01)
    jo = jopt.Adafactor(lr=jopt.warmup_cosine(0.05, 1, 5), **kw)
    to = topt.Adafactor(lr=topt.warmup_cosine(0.05, 1, 5), **kw)
    jp, js, tp, ts = _run_both(jo, to, rng)
    # XLA's rsqrt and torch's differ by an ulp on a third of the inputs,
    # so u does (|u| <= 2: 1.2e-7); lr · that, 6e-9 a step, is below
    # rtol 1e-6 except on a parameter near 0
    _close_tree(tp, jp, atol=1e-7)
    _close_tree(ts["stats"], js["stats"])
    assert T.tree_map(lambda t: tuple(t.shape), ts["stats"]) == \
        jax.tree.map(lambda a: tuple(a.shape), js["stats"])


def test_make_optimizer():
    lr = topt.warmup_cosine(1.0, 1, 2)
    assert isinstance(topt.make_optimizer("adamw", lr), topt.AdamW)
    assert isinstance(topt.make_optimizer("adafactor", lr), topt.Adafactor)
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd", lr)


# -- the train step -------------------------------------------------------------


def _cfgs(arch, **over):
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


def _batch(rng, cfg, b, s):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}


@pytest.mark.parametrize("arch,accum", [("granite-3-2b", 1),
                                        ("granite-3-2b", 2),
                                        ("dbrx-132b", 1)])
def test_train_step_matches_reference(arch, accum, rng):
    """One step of each package's ``make_train_step`` (the config's
    optimizer: AdamW for granite, Adafactor for dbrx) from the same
    parameters and batch."""
    jcfg, tcfg = _cfgs(arch)
    params, _ = jlm.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    batch = _batch(rng, jcfg, 4, 32)
    jo = jopt.make_optimizer(jcfg.optimizer, jopt.warmup_cosine(1e-3, 1, 10))
    to = topt.make_optimizer(tcfg.optimizer, topt.warmup_cosine(1e-3, 1, 10))
    jp, _, jm = jax.jit(jstep.make_train_step(jcfg, jo, accum))(
        params, jo.init(params), _jnp(batch))
    masters = convert.masters_from_jax(tcfg, tree, device=CPU)
    step = tstep.make_train_step(tcfg, to, accum, device=CPU)
    tp, ts, tm = step(masters, to.init(masters), batch)
    assert tp is masters                       # updated in place
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        LOSS_TOL * abs(float(jm["loss"]))
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for k in ("ce", "zloss", "aux", "ppl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    want = dict(T.items(jax.tree.map(np.asarray, jp)))
    for path, got in T.items(_np(tp)):
        assert _rel_l2(got, want[path]) < PARAM_REL_L2, "/".join(path)


def test_accumulation_matches_one_batch(rng):
    """2 microbatches of 4 against one batch of 8 in the port, the
    gradients accumulated in f32: the reference's own equivalence
    check."""
    _, tcfg = _cfgs("granite-3-2b")
    masters = tstep.init_masters(tcfg, 0, CPU)
    batch = _batch(rng, tcfg, 8, 32)
    batch["loss_mask"][:] = 1.0
    outs = []
    for accum in (1, 2):
        g = tstep.make_grad_fn(tcfg, accum, CPU,
                               grad_accum_dtype=torch.float32)
        outs.append(g(masters, batch))
    assert abs(float(outs[0][0]) - float(outs[1][0])) < 1e-5
    for (path, a), b in zip(T.items(outs[0][2]), T.leaves(outs[1][2])):
        assert _rel_l2(b.numpy(), a.numpy()) < 1e-5, "/".join(path)


def test_working_copy_holds_rounded_leaves(rng):
    """bf16 compute: every f32 leaf (the MoE router, the norm scales)
    reaches the model rounded to bf16, whatever dtype the module keeps,
    and every gradient comes back in bf16."""
    cfg = tget("dbrx-132b").reduced()
    masters = tstep.init_masters(cfg, 0, CPU)
    g = tstep.make_grad_fn(cfg, device=CPU)
    _, _, grads = g(masters, _batch(rng, cfg, 2, 32))
    assert {t.dtype for t in T.leaves(grads)} == {torch.bfloat16}
    w = tstep.Working(cfg, CPU)
    w.load(masters)
    blk = w.model.blocks[0]
    assert blk.mlp.router.dtype == torch.float32
    router = masters["blocks"]["b0"]["mlp"]["router"][0]
    assert torch.equal(blk.mlp.router, router.to(torch.bfloat16).float())
    assert not torch.equal(blk.mlp.router, router)
    assert torch.equal(blk.attn.wq, masters["blocks"]["b0"]["attn"]["wq"][0]
                       .to(torch.bfloat16))


def test_init_masters_are_the_serving_draws():
    """The f32 masters rounded to bf16 are the weights ``lm.init`` gives
    the serving model at the same seed."""
    cfg = tget("granite-3-2b").reduced()
    masters = tstep.init_masters(cfg, 3, CPU)
    assert {t.dtype for t in T.leaves(masters)} == {torch.float32}
    model = tlm.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    back = convert.masters_from_model(cfg, model)
    for (path, a), b in zip(T.items(masters), T.leaves(back)):
        assert torch.equal(a.to(torch.bfloat16).float(), b), path


def test_remat_options_give_the_same_gradients(rng):
    """No remat, one level and two levels (remat_group 2 of 4 repeats),
    each against the reference's gradients of the same config."""
    batch = _batch(rng, tget("granite-3-2b").reduced(), 2, 16)
    for remat, group in ((False, 1), (True, 1), (True, 2)):
        jcfg, tcfg = _cfgs("granite-3-2b", num_layers=4, remat=remat,
                           remat_group=group)
        params, _ = jlm.init(jcfg, jax.random.PRNGKey(1))
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jlm.loss_fn(jcfg, p, _jnp(batch)), has_aux=True))(
                params)
        masters = convert.masters_from_jax(
            tcfg, jax.tree.map(np.asarray, params), device=CPU)
        loss, _, grads = tstep.make_grad_fn(tcfg, device=CPU)(masters, batch)
        assert abs(float(loss) - float(jl)) <= LOSS_TOL * float(jl)
        want = dict(T.items(jax.tree.map(np.asarray, jg)))
        for path, g in T.items(grads):
            assert _rel_l2(g.numpy(), want[path]) < 1e-4, (remat, group,
                                                           path)


# -- data, compression, the loop -----------------------------------------------


@pytest.mark.parametrize("index,shard,shards", [(0, 0, 1), (7, 1, 4),
                                                (3, 3, 4)])
def test_synthetic_corpus_is_bit_equal(index, shard, shards):
    j = jpipe.SyntheticCorpus(vocab_size=512, seed=3)
    t = tpipe.SyntheticCorpus(vocab_size=512, seed=3)
    np.testing.assert_array_equal(t.perm, j.perm)
    a, b = j.batch(index, 4, 64, shard, shards), t.batch(index, 4, 64,
                                                           shard, shards)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_iterators_resume_with_extras_bit_equal():
    jcfg, tcfg = jget("whisper-tiny").reduced(), tget("whisper-tiny").reduced()
    j = jpipe.make_iterator(jpipe.SyntheticCorpus(512, seed=1), 2, 16,
                            start_step=3,
                            extras=jloop._extras_for(jcfg, 2))
    t = tpipe.make_iterator(tpipe.SyntheticCorpus(512, seed=1), 2, 16,
                            start_step=3,
                            extras=tloop._extras_for(tcfg, 2))
    for _ in range(3):
        a, b = next(j), next(t)
        assert sorted(a) == sorted(b) == ["enc_embeds", "labels",
                                          "loss_mask", "tokens"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_compress_round_trip_matches_reference(rng):
    tree = {"a": rng.standard_normal((8, 8)).astype(np.float32),
            "b": {"c": (3 * rng.standard_normal(16)).astype(np.float32)}}
    jq, js, je = jcomp.compress_tree(_jnp(tree), jcomp.zeros_error(
        _jnp(tree)))
    tq, ts, te = tcomp.compress_tree(_t(tree), tcomp.zeros_error(_t(tree)))
    for (path, q), jqq in zip(T.items(tq), jax.tree.leaves(jq)):
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    _close_tree(ts, js)
    _close_tree(te, je, atol=1e-7)
    deq = tcomp.decompress_tree(tq, ts)
    for path, x in T.items(tree):
        assert np.abs(T.get(deq, path).numpy() - x).max() <= \
            0.02 * np.abs(x).max()
    assert tcomp.compressed_bytes(tq) == jcomp.compressed_bytes(jq) == \
        64 + 16 + 16


def test_loss_decreases_end_to_end():
    """The reference's test_loss_decreases_end_to_end on the port."""
    cfg = tget("granite-3-2b").reduced()
    out = tloop.train(cfg, tloop.TrainArgs(steps=40, batch_size=8,
                                           seq_len=64, lr=2e-3, warmup=5,
                                           log_every=10), device=CPU)
    h = out["history"]
    assert all(np.isfinite(r["loss"]) for r in h)
    assert h[-1]["loss"] < h[0]["loss"] - 0.3


def test_local_sgd_trains_and_compresses():
    cfg = tget("granite-3-2b").reduced()
    out = tloop.train_local_sgd(
        cfg, tloop.TrainArgs(steps=10, batch_size=4, seq_len=32, lr=2e-3,
                             warmup=2), workers=2, sync_period=5,
        device=CPU)
    assert out["history"][-1]["loss"] < out["history"][0]["loss"] + 0.5
    n_params = sum(x.numel() for x in T.leaves(out["params"]))
    assert 0.9 * n_params * 4 < out["comm_bytes"] < \
        1.05 * n_params * 4 + 1e4


def test_launch_train_on_the_cpu(tmp_path, capsys):
    out = tlaunch.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--out", str(tmp_path / "h.json")])
    assert out["final_step"] == 3
    assert "final loss" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "h.json")
    out = tlaunch.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                        "--seq", "16", "--ckpt-dir", str(tmp_path / "c"),
                        "--ckpt-every", "2", "--fail-at", "3"])
    assert out["restarts"] == 1 and out["final_step"] == 4
    out = tlaunch.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--local-sgd", "2",
                        "--sync-period", "1"])
    assert out["comm_bytes"] > 0
