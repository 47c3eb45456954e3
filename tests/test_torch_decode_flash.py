"""Flash-decoding across a mesh (``models/layers._decode_attend_flash``)
against the JAX package's single-shard decode attention.

Four processes on the CPU form a gloo world; each lays the same numpy
inputs (seeded) out as DTensors on a ("data", "model") mesh — (2, 2) and
(1, 4) — with the cache's time axis split over "model", as the rule
table lays a decode cache out ("batch kv_seq kv_heads head_dim").  With
the mesh in force, ``_decode_attend`` takes the flash path (S 4,096 ≥
4,096 and divisible by "model"): each shard attends over its chunk and
the partials are combined by all-reduces.  The gathered output must
equal the reference's ``_decode_attend_local`` over the whole cache
(f32, rtol 1e-5), with and without a window; the sharded write of a new
K/V row (``_scatter_time``) must equal the plain one exactly.  The world
lives in a subprocess, so no process group reaches this one.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, H, KV, HD = 4, 4096, 8, 2, 16
POS = (4095, 3001, 17, 2053)
WINDOWS = (None, 700)
MESHES = ((2, 2), (1, 4))

_WORLD = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, data_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm  # noqa: F401 (before layers)
    from repro_torch.models import layers
    from repro_torch.sharding import rules as R
    cfg = get_config("granite-3-2b")
    a = np.load(os.path.join(data_dir, "inputs.npz"))
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    pos = torch.from_numpy(a["pos"]).long()
    new = torch.from_numpy(a["new"])
    for shape in [tuple(int(x) for x in s) for s in a["meshes"]]:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

        def lay(t, axes):
            return R.distribute(t, R.spec_for(tuple(t.shape), axes, mesh),
                                mesh)

        qd, posd = lay(q, "batch . . ."), lay(pos, "batch")
        kd = lay(k, "batch kv_seq kv_heads head_dim")
        vd = lay(v, "batch kv_seq kv_heads head_dim")
        with R.use_mesh(mesh):
            assert layers._seq_shards(kd) is not None
            for w in a["windows"]:
                w = None if w < 0 else int(w)
                o = layers._decode_attend(cfg, qd, kd, vd, posd, w)
                full = o.full_tensor()
                if rank == 0:
                    tag = f"{shape[0]}x{shape[1]}_{w}"
                    np.save(os.path.join(data_dir, f"o_{tag}.npy"),
                            full.numpy())
            cache = lay(k.clone(), "batch kv_seq kv_heads head_dim")
            layers._scatter_time(cache, lay(new, "batch . . ."), posd)
            got = cache.full_tensor()
        want = k.clone()
        layers._scatter_time(want, new, pos)
        assert torch.equal(got, want), "sharded write differs"
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(run, args=(int(sys.argv[1]), sys.argv[2]),
                       nprocs=4, start_method="fork")
    print("WORLD_OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("flash_decode")
    rng = np.random.default_rng(0)
    arrs = {n: rng.standard_normal(shape).astype(np.float32)
            for n, shape in (("q", (B, 1, H, HD)), ("k", (B, S, KV, HD)),
                             ("v", (B, S, KV, HD)), ("new", (B, 1, KV, HD)))}
    arrs["pos"] = np.asarray(POS, np.int32)
    arrs["windows"] = np.asarray([-1 if w is None else w for w in WINDOWS])
    arrs["meshes"] = np.asarray(MESHES)
    np.savez(d / "inputs.npz", **arrs)
    script = d / "world.py"
    script.write_text(_WORLD)
    out = subprocess.run(
        [sys.executable, str(script), str(_free_port()), str(d)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src"))
    assert out.returncode == 0 and "WORLD_OK" in out.stdout, \
        out.stdout[-2000:] + out.stderr[-4000:]
    return d, arrs


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("window", WINDOWS)
def test_flash_decoding_equals_reference(world, mesh, window):
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as ref
    d, a = world
    want = np.asarray(ref._decode_attend_local(
        jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]),
        jnp.asarray(a["pos"]), window, base=None))
    got = np.load(d / f"o_{mesh[0]}x{mesh[1]}_{window}.npy")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_without_a_mesh_the_path_is_unchanged():
    from repro_torch.models import lm  # noqa: F401 (before layers)
    from repro_torch.models import layers
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 4096, 2, 8), np.float32))
    pos = torch.tensor([4095, 100])
    assert layers._seq_shards(k) is None
    assert torch.equal(layers._decode_attend(None, q, k, k, pos),
                       layers._decode_attend_local(q, k, k, pos, None))
