"""The port's checkpoints and restarts, on the CPU.

Both packages write the same format (``params.npz``, ``opt.npz``,
``meta.json`` under ``step_XXXXXXXX``, each leaf under its key path), so
a checkpoint written by the JAX package's ``train`` restores into the
port, bit for bit, and trains on there, and one written by the port
restores into the JAX package and trains on there.  Retention, the
async writer, a shape mismatch and a missing leaf as in the reference;
a run that fails and restarts from its checkpoint gives the
uninterrupted run's masters and optimizer state bit for bit on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import ckpt as jckpt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

CPU = "cpu"
ARCH = "granite-3-2b"
ARGS = dict(batch_size=2, seq_len=16, lr=1e-3, warmup=1, log_every=1)


def _equal_trees(got, want):
    want = dict(T.items(jax.tree.map(np.asarray, want)))
    got = dict(T.items(got))
    assert got.keys() == want.keys()
    for path, g in got.items():
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.dtype == want[path].dtype, path
        np.testing.assert_array_equal(g, want[path], err_msg=str(path))


def _port_templates(cfg):
    masters = tstep.init_masters(cfg, 1, CPU)
    opt = topt.make_optimizer(cfg.optimizer, topt.warmup_cosine(1, 1, 2))
    return masters, opt.init(masters)


def test_repro_checkpoint_restores_into_the_port(tmp_path):
    cfg = jget(ARCH).reduced()
    out = jloop.train(cfg, jloop.TrainArgs(steps=2, ckpt_dir=str(tmp_path),
                                           ckpt_every=2, **ARGS))
    tcfg = tget(ARCH).reduced()
    params, opt_state, meta = tckpt.restore(str(tmp_path),
                                            *_port_templates(tcfg))
    assert meta["step"] == 2
    _equal_trees(params, out["params"])
    _equal_trees(opt_state, out["opt_state"])
    assert opt_state["count"].dtype == torch.int32
    # and trains on in the port from step 2
    more = tloop.train(tcfg, tloop.TrainArgs(
        steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, **ARGS), device=CPU)
    assert [h["step"] for h in more["history"]] == [3, 4]
    assert all(np.isfinite(h["loss"]) for h in more["history"])
    assert tckpt.latest_step(str(tmp_path)) == 4


def test_port_checkpoint_restores_into_repro(tmp_path):
    tcfg = tget(ARCH).reduced()
    out = tloop.train(tcfg, tloop.TrainArgs(
        steps=2, ckpt_dir=str(tmp_path), ckpt_every=2, **ARGS), device=CPU)
    cfg = jget(ARCH).reduced()
    params, _ = jlm.init(cfg, jax.random.PRNGKey(0))
    opt = jopt.make_optimizer(cfg.optimizer, jopt.warmup_cosine(1, 1, 2))
    jp, js, meta = jckpt.restore(str(tmp_path), params, opt.init(params))
    assert meta["step"] == 2
    _equal_trees(T.tree_map(lambda t: t, out["params"]), jp)
    _equal_trees(out["opt_state"], js)
    more = jloop.train(cfg, jloop.TrainArgs(
        steps=3, ckpt_dir=str(tmp_path), ckpt_every=3, **ARGS))
    assert [h["step"] for h in more["history"]] == [3]
    assert np.isfinite(more["history"][0]["loss"])


def test_opt_state_converts_both_ways():
    cfg = jget(ARCH).reduced()
    params, _ = jlm.init(cfg, jax.random.PRNGKey(2))
    for name in ("adamw", "adafactor"):
        st = jax.tree.map(np.asarray, jopt.make_optimizer(
            name, jopt.warmup_cosine(1, 1, 2)).init(params))
        port = convert.opt_state_from_jax(st, device=CPU)
        assert port["count"].dtype == torch.int32
        _equal_trees(T.tree_map(lambda t: t, convert.opt_state_to_jax(
            port)), st)


def test_masters_from_jax_checks_the_tree():
    cfg = jget(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jlm.init(cfg, jax.random.PRNGKey(0))[0])
    tcfg = tget(ARCH).reduced()
    masters = convert.masters_from_jax(tcfg, tree, device=CPU)
    _equal_trees(masters, tree)
    del tree["ln_f"]
    with pytest.raises(ValueError, match="ln_f"):
        convert.masters_from_jax(tcfg, tree, device=CPU)


def test_retention_latest_and_async(tmp_path, rng):
    d = str(tmp_path)
    p = {"a": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32)), "nest": {"b": torch.arange(5)}}
    for step in (1, 2, 3, 4):
        tckpt.save(d, step, p, meta={"x": 1}, keep=2,
                   async_save=step % 2 == 0)
    tckpt.wait_for_async_saves()
    assert tckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    q, opt, meta = tckpt.restore(d, p)
    assert opt is None and meta == {"x": 1, "step": 4}
    _equal_trees(q, T.tree_map(lambda t: t.numpy(), p))
    # a template of shapes alone, the leaves put on the named device
    meta_t = T.tree_map(lambda t: torch.empty(t.shape, device="meta"), p)
    q, _, _ = tckpt.restore(d, meta_t, step=3, device=CPU)
    assert q["a"].device.type == "cpu"


def test_restore_raises_on_a_bad_template(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(d, {"a": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing b"):
        tckpt.restore(d, {"a": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), {"a": torch.zeros(3)})
    with pytest.raises(TypeError, match="bfloat16"):
        tckpt.save(d, 2, {"a": torch.zeros(3, dtype=torch.bfloat16)})


@pytest.mark.parametrize("arch", [ARCH, "dbrx-132b"])
def test_restart_is_bit_exact(arch, tmp_path):
    """train(6) == train(6) failing at step 4, restarted from the
    checkpoint of step 3 (AdamW for granite, Adafactor for dbrx)."""
    cfg = tget(arch).reduced()
    base = tloop.TrainArgs(steps=6, ckpt_every=3, **ARGS)
    a = tloop.train(cfg, base, device=CPU)
    args = dataclasses.replace(base, ckpt_dir=str(tmp_path),
                               fail_at_step=4)
    b = tloop.train_with_restarts(cfg, args, device=CPU)
    assert b["restarts"] == 1 and b["final_step"] == 6
    for x, y in zip(T.leaves(a["params"]) + T.leaves(a["opt_state"]),
                    T.leaves(b["params"]) + T.leaves(b["opt_state"])):
        assert torch.equal(x, y)
    assert a["history"][-1]["loss"] == b["history"][-1]["loss"]


def test_npz_files_are_numpys(tmp_path, rng):
    """The archives read and write as ``np.savez``/``np.load``'s, 0-d
    and empty leaves included, and a flipped data byte fails the CRC."""
    import zipfile

    from repro_torch.ckpt import checkpoint as C
    flat = {"m/w": rng.standard_normal((6, 5)).astype(np.float32),
            "count": np.array(7, np.int32), "e": np.zeros((0, 3)),
            "i": np.arange(4), "f": np.asfortranarray(rng.random((3, 2)))}
    ours, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    C._write_npz(ours, flat)
    np.savez(theirs, **flat)
    for path in (ours, theirs):
        with np.load(path) as z:
            got = C._Npz(path)
            for k, v in flat.items():
                for a in (z[k], got[k]):
                    assert a.dtype == v.dtype and a.shape == v.shape, k
                    np.testing.assert_array_equal(a, v)
    info = zipfile.ZipFile(ours).getinfo("m/w.npy")
    raw = bytearray(open(ours, "rb").read())
    raw[info.header_offset + info.compress_size] ^= 1   # inside the data
    bad = str(tmp_path / "c.npz")
    open(bad, "wb").write(raw)
    with pytest.raises(ValueError, match="CRC"):
        C._Npz(bad)["m/w"]
