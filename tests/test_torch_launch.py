"""The port's pod dry run (``launch/{analytic,specs,dryrun,roofline}``,
``core/placement.lower_distributed``) against the JAX package.

``analytic`` and the dump half of ``roofline`` are arithmetic: equal to
the reference's for every (arch × shape) and on the same synthetic dumps
(the port's constants set to the reference's TPU ones).  What needs a
process group — the abstract inputs on a 256-rank fake world, the dry
run's command line, the traced distributed sweep — runs in a
subprocess, so no test in this process sees a process group.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import analytic, roofline  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               **(env_extra or {}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_equals_reference(arch):
    from repro.configs.base import get_config as ref_config
    from repro.launch import analytic as ref
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in S.SHAPES:
        mine, want = analytic.model_flops(cfg, shape), \
            ref.model_flops(rcfg, shape)
        assert set(mine) == set(want)
        for k in want:
            assert _close(mine[k], want[k]), (shape, k)
        assert _close(analytic.prefill_attention_correction(cfg, shape),
                      ref.prefill_attention_correction(rcfg, shape))
        assert _close(analytic.decode_hbm_bytes(cfg, shape),
                      ref.decode_hbm_bytes(rcfg, shape))


def test_shapes_and_accum_equal_reference():
    from types import SimpleNamespace
    from repro.configs.base import get_config as ref_config
    from repro.launch import specs as ref
    assert S.SHAPES == ref.SHAPES and S.ACCUM == ref.ACCUM
    for shape in ({"data": 16, "model": 16},
                  {"pod": 2, "data": 16, "model": 16}, {"data": 1}):
        mesh = SimpleNamespace(shape=shape)
        for arch in ARCH_IDS:
            assert S.accum_for(arch, mesh) == ref.accum_for(arch, mesh)
    for arch in ARCH_IDS:
        for shape in S.SHAPES:
            assert S.cell_applicable(get_config(arch), shape) == \
                ref.cell_applicable(ref_config(arch), shape)


def _cells():
    """Synthetic dumps in the reference's layout: ok cells with and
    without ``composed``, a skip and an error."""
    def cost(f, b, c):
        return {"cost": {"flops": f, "bytes": b},
                "collectives": {"all-gather": c * 0.75,
                                "all-reduce": c * 0.25, "count": 7.0,
                                "total_bytes": c}}
    full = dict(cost(3.1e14, 2.2e12, 4.4e10),
                mem={"peak_est_bytes": 9.5 * 2**30})
    return [
        {"arch": "granite-3-2b", "shape": "train_4k", "mesh": "16x16",
         "status": "ok", "full": full,
         "composed": cost(8.2e14, 5.1e12, 9.9e10)},
        {"arch": "granite-3-2b", "shape": "prefill_32k", "mesh": "16x16",
         "status": "ok", "full": full},
        {"arch": "rwkv6-1.6b", "shape": "decode_32k", "mesh": "16x16",
         "status": "ok", "full": dict(cost(1.2e10, 4.0e9, 0.0),
                                      mem={"peak_est_bytes": 2**30})},
        {"arch": "granite-3-2b", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped", "reason": "full quadratic attention"},
        {"arch": "dbrx-132b", "shape": "prefill_32k", "mesh": "16x16",
         "status": "error", "error": "OpError: aten.index_copy_.default"},
    ]


def test_roofline_rows_and_table_equal_reference(monkeypatch):
    from repro.launch import roofline as ref
    monkeypatch.setattr(roofline, "BF16_PEAK_FLOPS", ref.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(roofline, "ICI_BW", ref.ICI_BW)
    cells = _cells()
    for c in cells:
        mine, want = roofline.roofline_row(c), ref.roofline_row(c)
        if want is None:
            assert mine is None
            continue
        assert mine["chips"] == ref.CHIPS
        for k, v in want.items():
            assert mine[k] == v, k
    assert roofline.make_table(cells) == ref.make_table(cells)


def test_roofline_takes_chips_from_the_mesh():
    cell = dict(_cells()[0], mesh="2x16x16")
    assert roofline.chips_of(cell) == 512
    assert roofline.chips_of(dict(cell, mesh="16x16f")) == 256
    row = roofline.roofline_row(cell)
    assert row["hlo_flops_total"] == cell["composed"]["cost"]["flops"] * 512


def test_roofline_skips_the_chunk_correction_on_port_dumps():
    cell = dict(_cells()[1], package="repro_torch")
    row = roofline.roofline_row(cell)
    assert row["hlo_flops_total"] == cell["full"]["cost"]["flops"] * 256


def test_roofline_main_reads_a_directory(tmp_path, capsys):
    for i, c in enumerate(_cells()):
        (tmp_path / f"{i}.json").write_text(json.dumps(c))
    roofline.main(["--in", str(tmp_path), "--json",
                   str(tmp_path / "rows.out")])
    assert "| granite-3-2b | train_4k |" in capsys.readouterr().out
    rows = json.loads((tmp_path / "rows.out").read_text())
    assert len(rows) == 3


_INPUT_SPECS = r"""
import json, os
import numpy as np
import jax
from repro.configs.base import get_config as ref_config
from repro.launch import mesh as ref_mesh, specs as ref
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh, specs
from repro_torch.sharding import rules as R
from repro_torch.train import tree as T
from torch.distributed.tensor import DTensor


def norm(spec):
    return [None if p is None else p if isinstance(p, str) else list(p)
            for p in spec]


def ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        sh = getattr(leaf, "sharding", None)
        spec = norm(sh.spec) if sh is not None else []
        spec += [None] * (len(leaf.shape) - len(spec))
        out[key] = [list(leaf.shape), str(np.dtype(leaf.dtype)), spec]
    return out


def port_leaves(tree, m):
    out = {}
    def visit(prefix, t):
        if isinstance(t, dict):
            for k in t:
                visit(prefix + (k,), t[k])
            return
        if isinstance(t, tuple):
            for i, x in enumerate(t):
                visit(prefix + (str(i),), x)
            return
        spec = R.spec_of(t.placements, m, t.dim())
        out["/".join(prefix)] = [list(t.shape),
                                 str(t.dtype).replace("torch.", ""),
                                 norm(spec)]
    visit((), tree)
    return out


jm = ref_mesh.make_production_mesh()
tm = mesh.make_production_mesh()
res = {}
for arch in ("granite-3-2b", "rwkv6-1.6b", "whisper-tiny"):
    for shape in specs.SHAPES:
        if not specs.cell_applicable(get_config(arch), shape)[0]:
            continue
        want = ref.input_specs(ref_config(arch), jm, shape)
        if "token" in want:
            want = {"cache": want["cache"],
                    "token_pos": (want["token"], want["pos"])}
        mine = specs.input_specs(get_config(arch), tm, shape)
        if "token" in mine:
            mine = {"cache": mine["cache"],
                    "token_pos": (mine["token"], mine["pos"])}
        res[f"{arch}/{shape}"] = [ref_leaves(want), port_leaves(mine, tm)]
print("RESULT" + json.dumps(res))
"""


def test_input_specs_equal_reference():
    out = _run(_INPUT_SPECS, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=256"})
    res = json.loads(out.split("RESULT", 1)[1])
    assert len(res) == 10
    for cell, (want, mine) in res.items():
        assert set(mine) == set(want), cell
        for k in want:
            assert mine[k] == want[k], (cell, k)


def test_dryrun_single_cell_subprocess():
    """One dry-run cell end to end (whisper decode: cheapest), as the
    reference's ``test_dryrun_single_cell_subprocess``."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--no-pieces"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH="src"))
    assert "ok" in out.stdout and "0 errors" in out.stdout, \
        out.stdout + out.stderr[-2000:]


_LOWER = r"""
import json
import torch
from repro_torch.core import algorithms as A, graph as G, placement as PL
from repro_torch.launch.mesh import device_mesh

g = G.rmat(300, 1500, seed=5)
p = A.sssp(g, 0, mode="async", b=16, num_clusters=8, device="cpu").prepared
out = {"r_pad": p.r_pad, "k_max": p.k_max, "b": p.b}
for name, (d, dq, batch) in {"1d": (8, 1, None), "2d": (2, 4, 5)}.items():
    m = device_mesh((d, dq), ("graph", "query"))
    gm = PL.lower_distributed(p, m, batch=batch)
    groups = {"graph": m.get_group("graph").group_name,
              "query": m.get_group("query").group_name}
    colls = []
    for node in gm.graph.nodes:
        if node.op == "call_function" and \
                isinstance(node.target, torch._ops.OpOverload) and \
                node.target.namespace == "_c10d_functional" and \
                node.target.__name__.split(".")[0] != "wait_tensor":
            colls.append([node.target.__name__, node.args[-1]])
    shapes = [list(n.meta["val"].shape) for n in gm.graph.nodes
              if n.op == "placeholder"]
    out[name] = {"groups": groups, "colls": colls, "shapes": shapes,
                 "code": "all_gather_into_tensor" in gm.code}
    import torch.distributed as dist
    dist.destroy_process_group()
print("RESULT" + json.dumps(out))
"""


def test_lower_distributed_gathers_on_graph_only():
    """The traced sweep's halo is one tiled all-gather on "graph" and
    nothing on "query", at the reference's padded shapes (r_pad rounded
    up to the graph extent, q_pad to the query extent)."""
    res = json.loads(_run(_LOWER).split("RESULT", 1)[1])
    r_pad, k, b = res["r_pad"], res["k_max"], res["b"]
    for name, (d, dq, q) in {"1d": (8, 1, None), "2d": (2, 4, 5)}.items():
        r = res[name]
        assert r["code"]
        assert r["colls"] == [["all_gather_into_tensor.default",
                               r["groups"]["graph"]]], r["colls"]
        rows = ((r_pad + d - 1) // d * d) // d
        x = [rows, b] if q is None else \
            [((q + dq - 1) // dq * dq) // dq, rows, b]
        assert r["shapes"] == [[rows, k, b, b], [rows, k], [rows],
                               [rows, b], x]
