#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of the graph engine on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any mismatch raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off for matmuls and cuDNN;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a) and print the build time and ptxas's register report;
  3. each kernel against its plain torch version on the card: the CA
     stand-in at scale 0.02 for the 4 semirings × B ∈ {16, 32}, the fused
     kernel over 5 update rules × {empty, sparse, dense} frontiers at
     Q = 1 and 4, garbage beyond nnz;
  4. the main path at full width: ``GraphProcessor`` on the full-scale
     CA stand-in (n = 1,962,801) at b=16, 64 clusters, with every query
     checked against the numpy oracles and ``degrade=False``; before the
     queries, both kernels against the plain versions on a 4096-row-block
     slice of each full-scale plan with the full x; then sssp and
     pagerank on the power-law stand-in ``fb`` at scale 0.005, b=32;
  5. times at the full-scale CA plans: each kernel (CUDA events, median),
     its plain version, the bound (bytes / 3.35 TB/s) and, for
     plus_times, ``torch.sparse_csr_tensor`` @ x as a yardstick;
  6. a JSON line per kernel; the last line is
     ``{"ok": true, "device": {...}}``.

Each earlier JSON line carries the card's name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
SEMIRINGS = ("plus_times", "min_plus", "max_min", "min_select")
RULES = ("relax", "pagerank", "pagerank_delta", "kcore", "identity")
FRONTIERS = ("empty", "sparse", "dense")
SCALARS = {"damping": 0.85, "tol": 1e-6, "inv_n": 1e-2}
SLICE_ROWS = 4096
DEVICE = "cuda"
CA_SCALE, FB_SCALE, SMALL_SCALE = 1.0, 0.005, 0.02
# PageRank stop tolerances: ranks average 1/n, so tol scales with n (the
# JAX package's tests use 1e-9 at n ≈ 200); the oracle check allows
# 100·tol/(1-d): the contraction bound tol/(1-d) with room for float32
# rounding and the L1 renormalization
PR_TOL = {"ca": 1e-11, "fb": 1e-10}

CARD = {}


def emit(**rec):
    print(json.dumps(dict(rec, card=CARD.get("name"),
                          power_limit=CARD.get("power_limit"))),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# -- comparisons -------------------------------------------------------------


class Errors:
    """Largest |kernel − plain| seen per kernel."""

    def __init__(self):
        self.max = {"bsr_spmv": 0.0, "bsr_spmv_fused": 0.0}

    def check(self, name, got, want, semiring, rule, what):
        import torch
        got, want = got.float(), want.float()
        both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
        diff = torch.where(both_inf, 0.0, (got - want).abs())
        err = float(diff.max()) if diff.numel() else 0.0
        self.max[name] = max(self.max[name], err)
        inexact = semiring == "plus_times" or rule.startswith("pagerank")
        if inexact:
            scale = torch.where(both_inf, 1.0, want.abs())
            ok = bool((diff <= 2e-6 * scale).all())
        else:
            ok = bool(torch.equal(got, want))
        if not ok:
            raise AssertionError(f"{name} != plain ({what}): max |Δ| {err}")


def random_x(gen, q, c, b, semiring, rule, device):
    import torch
    x = torch.rand((q, c, b), generator=gen, device="cpu")
    if semiring == "max_min" or rule == "kcore":
        x = (x > 0.5).float()  # {0,1} carrier; integer live-counts
    return x.to(device)


def compare_plan(vals, cols, nnz, c_rows, semiring, errs, gen, what,
                 xs_rows=None, rules=RULES):
    """Both kernels vs the plain versions on one plan (or slice of one):
    Q ∈ {1, 4}; the fused kernel over the update rules × frontiers."""
    import torch
    from repro_torch.kernels import bsr_spmv as tk
    from repro_torch.kernels import ref as tref
    dev = vals.device
    r, _, b, _ = vals.shape
    valid = torch.ones((r, b), dtype=torch.bool, device=dev)
    valid[-1, b // 2:] = False
    for q in (1, 4):
        x = random_x(gen, q, c_rows, b, semiring, "relax", dev)
        y = tk.bsr_spmv(vals, cols, nnz, x, semiring)
        want = tref.bsr_spmv_ref(vals, cols, nnz, x, semiring)
        torch.cuda.synchronize()
        errs.check("bsr_spmv", y, want, semiring, "relax",
                   f"{what} {semiring} Q={q}")
        for rule in rules:
            x = random_x(gen, q, c_rows, b, semiring, rule, dev)
            row0 = 0 if xs_rows is None else xs_rows
            xg = x[:, row0:row0 + r].contiguous()
            damping = 3.0 if rule == "kcore" else SCALARS["damping"]
            sc = [torch.tensor(v, dtype=torch.float32) for v in
                  (damping, SCALARS["tol"], SCALARS["inv_n"])]
            for frontier in FRONTIERS:
                act = {"empty": torch.zeros((q, r), dtype=torch.bool),
                       "sparse": torch.rand((q, r), generator=gen) < 0.15,
                       "dense": torch.ones((q, r), dtype=torch.bool)
                       }[frontier].to(dev)
                got = tk.bsr_spmv_fused(vals, cols, nnz, x, xg, valid, act,
                                        *sc, semiring, rule)
                want = tref.bsr_spmv_fused_ref(vals, cols, nnz, x, xg,
                                               valid, act, *sc, semiring,
                                               rule)
                torch.cuda.synchronize()
                tag = f"{what} {semiring} {rule} {frontier} Q={q}"
                errs.check("bsr_spmv_fused", got[0], want[0], semiring,
                           rule, tag)
                for g_, w_ in zip(got[1:], want[1:]):
                    if not torch.equal(g_, w_):
                        raise AssertionError(f"fused flags differ: {tag}")


def garbage_check(vals, cols, nnz, c_rows, semiring, gen):
    """Tiles beyond nnz hold garbage: neither kernel may read them.  The
    rows are the first rows of a plan with c_rows row-blocks."""
    import torch
    from repro_torch.kernels import bsr_spmv as tk
    r, k, b, _ = vals.shape
    dead = torch.arange(k, device=vals.device)[None, :] >= nnz[:, None]
    trash = torch.where(dead[:, :, None, None], -123.0, vals)
    x = random_x(gen, 2, c_rows, b, semiring, "relax", vals.device)
    xg = x[:, :r].contiguous()
    clean = tk.bsr_spmv(vals, cols, nnz, x, semiring)
    dirty = tk.bsr_spmv(trash, cols, nnz, x, semiring)
    act = torch.ones((2, r), dtype=torch.bool, device=vals.device)
    valid = torch.ones((r, b), dtype=torch.bool, device=vals.device)
    sc = [torch.tensor(v, dtype=torch.float32) for v in
          (SCALARS["damping"], SCALARS["tol"], SCALARS["inv_n"])]
    fc = tk.bsr_spmv_fused(vals, cols, nnz, x, xg, valid, act, *sc,
                           semiring, "relax")
    fd = tk.bsr_spmv_fused(trash, cols, nnz, x, xg, valid, act, *sc,
                           semiring, "relax")
    torch.cuda.synchronize()
    if not (torch.equal(clean, dirty) and torch.equal(fc[0], fd[0])
            and torch.equal(fc[1], fd[1])):
        raise AssertionError(f"garbage beyond nnz leaked ({semiring})")


# -- timing ------------------------------------------------------------------


def cuda_ms(fn, reps=10, warmup=2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def spmv_bytes(p, q, act=None) -> int:
    """Least bytes one call must move: each input read once (true tiles
    of the walked rows, their cols, nnz, x), each output written once."""
    b = p.b
    rows = p.nnz if act is None else p.nnz[act]
    tiles = int(rows.sum())
    n_rows = p.r_pad if act is None else int(act.sum())
    return (tiles * (b * b * 4 + 4) + n_rows * 4 + q * p.r_pad * b * 4
            + q * p.r_pad * b * 4)


def fused_bytes(p, q, act) -> int:
    """spmv_bytes for the active rows, plus xg and valid of those rows,
    the act mask, and the changed bits written."""
    b = p.b
    n_act = int(act.sum())
    return spmv_bytes(p, q, act) + n_act * b * (4 + 1) + p.r_pad + p.r_pad


def time_kernels(proc, g, errs, launches):
    """Times at the full-scale plans; returns the kernels line entries."""
    import numpy as np
    import torch
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import bsr_spmv as tk
    from repro_torch.kernels import ref as tref
    out = {}
    for semiring, variant, normalize in (
            ("min_plus", "base", None),
            ("plus_times", "base", "out_stochastic")):
        p = proc.prepare(semiring, variant=variant, normalize=normalize)
        x = torch.rand((1, p.r_pad, p.b), device=p.device)
        if semiring == "plus_times":
            x = x / p.n  # rank-sized values
        args = (p.vals, p.cols, p.nnz, x, semiring)
        ms = cuda_ms(lambda: tk.bsr_spmv(*args))
        plain = cuda_ms(lambda: tref.bsr_spmv_ref(*args), reps=3, warmup=1)
        nbytes = spmv_bytes(p, 1)
        lib = None
        if semiring == "plus_times":
            # the same permuted pull matrix as a CSR tensor: yardstick only
            gn = g
            outdeg = np.maximum(np.diff(gn.indptr), 1)
            w = (1.0 / outdeg)[np.repeat(np.arange(gn.n), np.diff(gn.indptr))]
            gw = Graph(n=gn.n, indptr=gn.indptr, indices=gn.indices,
                       weights=w.astype(np.float32))
            gm = gw.permute(p.perm.astype(np.int32)).transpose()
            n_pad = p.r_pad * p.b
            indptr = np.concatenate([gm.indptr, np.full(
                n_pad - gm.n, gm.indptr[-1], dtype=gm.indptr.dtype)])
            with warnings.catch_warnings():  # "beta state"
                warnings.simplefilter("ignore", UserWarning)
                a = torch.sparse_csr_tensor(
                    torch.from_numpy(indptr), torch.from_numpy(
                        gm.indices.astype(np.int64)),
                    torch.from_numpy(gm.weights), size=(n_pad, n_pad),
                    check_invariants=False).to(DEVICE)
            xf = x.reshape(-1, 1)
            ref_y = (a @ xf).reshape(1, p.r_pad, p.b)
            ker_y = tk.bsr_spmv(*args)
            torch.cuda.synchronize()
            err = float((ref_y - ker_y).abs().max())
            if err > 1e-5:
                raise AssertionError(f"CSR yardstick disagrees: {err}")
            lib = cuda_ms(lambda: a @ xf)
            del a
        rec = dict(kernel="bsr_spmv", semiring=semiring, ms=ms,
                   plain_ms=plain, bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, library_ms=lib,
                   tiles=int(p.nnz.sum()), r_pad=p.r_pad)
        emit(phase="time", **rec)
        out[("bsr_spmv", semiring)] = rec
        # fused: one dense sweep (every valid row active) of the same plan
        act = p.valid.any(dim=1)[None].contiguous()
        rule = "relax" if semiring == "min_plus" else "pagerank"
        sc = [torch.tensor(v, dtype=torch.float32) for v in
              (0.85, 1e-8, 1.0 / p.n)]
        fargs = (p.vals, p.cols, p.nnz, x, x, p.valid, act, *sc, semiring,
                 rule)
        fms = cuda_ms(lambda: tk.bsr_spmv_fused(*fargs))
        fplain = cuda_ms(lambda: tref.bsr_spmv_fused_ref(*fargs), reps=3,
                         warmup=1)
        fb = fused_bytes(p, 1, act[0])
        rec = dict(kernel="bsr_spmv_fused", semiring=semiring, rule=rule,
                   frontier="dense", ms=fms, plain_ms=fplain, bytes=fb,
                   bound_ms=fb / HBM_BYTES_PER_S * 1e3, library_ms=None,
                   active_rows=int(act.sum()))
        emit(phase="time", **rec)
        out[("bsr_spmv_fused", semiring)] = rec
        # and a sparse frontier: 5 % of the rows, the others exit at once
        act = (torch.rand((1, p.r_pad), generator=torch.Generator()
                          .manual_seed(1)) < 0.05).to(p.device)
        fargs = (p.vals, p.cols, p.nnz, x, x, p.valid, act, *sc, semiring,
                 rule)
        fms = cuda_ms(lambda: tk.bsr_spmv_fused(*fargs))
        fb = fused_bytes(p, 1, act[0])
        emit(phase="time", kernel="bsr_spmv_fused", semiring=semiring,
             rule=rule, frontier="sparse", ms=fms, bytes=fb,
             bound_ms=fb / HBM_BYTES_PER_S * 1e3,
             active_rows=int(act.sum()))
        torch.cuda.empty_cache()

    def entry(name, key, replaces, library):
        r = out[(name, key)]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/bsr_spmv.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs.max[name], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": "bytes", "library_ms": library}

    return [
        entry("bsr_spmv", "plus_times", "src/repro/kernels/bsr_spmv.py:136",
              out[("bsr_spmv", "plus_times")]["library_ms"]),
        entry("bsr_spmv_fused", "plus_times",
              "src/repro/kernels/bsr_spmv.py:324", None),
    ]


# -- the main path -----------------------------------------------------------


def run_query(name, fn, tk):
    import torch
    before = dict(tk.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if "degraded" in res.extra:
        raise AssertionError(f"{name} degraded: {res.extra['degraded']}")
    st = res.stats
    emit(phase="query", query=name, wall_s=wall, sweeps=st.sweeps,
         converged=st.converged, tile_work=st.tile_work,
         edge_work=st.edge_work, host_syncs=st.host_syncs,
         host_syncs_per_sweep=st.host_syncs / max(st.sweeps, 1),
         launches={k: tk.launch_counts[k] - before[k] for k in before})
    return res


_PR_ORACLE = {}


def _pagerank_oracle(g):
    from repro_torch.core import oracles as O
    if g.fingerprint() not in _PR_ORACLE:
        _PR_ORACLE[g.fingerprint()] = O.pagerank_oracle(g, tol=1e-14,
                                                        max_iter=1000)
    return _PR_ORACLE[g.fingerprint()]


def device_share(name, fn):
    """Device busy time over one query under torch.profiler: the sum of
    every device op's self time, against the query's wall (the profiler
    adds host overhead, so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    emit(phase="profile", query=name, wall_s=wall,
         device_busy_s=busy if busy > 0 else "not measured",
         idle_share=1 - busy / wall if busy > 0 else "not measured",
         top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
              for e in top])


def check_oracle(algo, g, values, src=None, tol=None):
    import numpy as np
    from repro_torch.core import oracles as O
    if algo == "sssp":
        np.testing.assert_allclose(values, O.sssp_oracle(g, src),
                                   rtol=1e-5, atol=1e-4)
    elif algo == "bfs":
        np.testing.assert_array_equal(values, O.bfs_oracle(g, src))
    elif algo == "reachability":
        np.testing.assert_array_equal(values > 0,
                                      np.isfinite(O.bfs_oracle(g, src)))
    elif algo == "pagerank":
        pr = _pagerank_oracle(g)
        err = float(np.max(np.abs(values - pr)))
        bound = 100 * tol / (1 - 0.85)
        if err > bound or abs(float(values.sum()) - 1.0) >= 1e-5:
            raise AssertionError(
                f"pagerank off the oracle by {err} (bound {bound})")
    elif algo == "cc":
        oracle = O.cc_oracle(g)
        pairs = set(zip(values.tolist(), oracle.tolist()))
        if not (len(pairs) == len(set(oracle.tolist()))
                == len(set(values.tolist()))):
            raise AssertionError("cc partition differs from the oracle")
    elif algo.startswith("kcore"):
        np.testing.assert_array_equal(values,
                                      O.kcore_oracle(g, int(algo[5:])))


def main_path(errs, gen):
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import graph as G
    from repro_torch.kernels import bsr_spmv as tk

    t0 = time.perf_counter()
    g = G.make_paper_graph("ca", scale=CA_SCALE, seed=0)
    proc = api.GraphProcessor(g, b=16, num_clusters=64, device=DEVICE)
    plans = {}
    for key in (("min_plus", "base", None), ("min_plus", "unit", None),
                ("plus_times", "base", "out_stochastic"),
                ("min_select", "undirected", None),
                ("plus_times", "unit_undirected", None),
                ("max_min", "unit", None)):
        t1 = time.perf_counter()
        p = proc.prepare(key[0], variant=key[1], normalize=key[2])
        plans[key] = p
        emit(phase="prepare", plan=list(key), seconds=time.perf_counter() - t1,
             r_pad=p.r_pad, k_max=p.k_max, tiles=p.tiles_total,
             edges=p.edges_total, fill=p.edges_total / max(
                 p.tiles_total * p.b * p.b, 1.0),
             vals_gb=p.vals.numel() * 4 / 1e9)
    emit(phase="graph", n=g.n, nnz=g.nnz, prepare_s=time.perf_counter() - t0,
         device_gb=torch.cuda.memory_allocated() / 1e9)

    # both kernels vs plain on a slice of each full-scale plan, full x
    seen = set()
    for (semiring, _, _), p in plans.items():
        if semiring in seen:
            continue
        seen.add(semiring)
        row0 = p.r_pad // 3
        sl = slice(row0, row0 + SLICE_ROWS)
        compare_plan(p.vals[sl], p.cols[sl], p.nnz[sl], p.r_pad, semiring,
                     errs, gen, "ca-full-slice", xs_rows=row0)
    p = plans[("min_plus", "base", None)]
    garbage_check(p.vals[:SLICE_ROWS], p.cols[:SLICE_ROWS],
                  p.nnz[:SLICE_ROWS], p.r_pad, "min_plus", gen)
    torch.cuda.synchronize()

    fused = api.KernelSpec(impl="pallas", fuse_frontier=True)
    sync = api.ExecutionPolicy(mode="sync", degrade=False)
    asyn = api.ExecutionPolicy(mode="async", degrade=False)

    tk.reset_launch_counts()   # the main path starts here
    res = {}
    for mode, pol in (("sync", sync), ("async", asyn)):
        for kname, kern in (("ref", None), ("fused", fused)):
            name = f"sssp/{mode}/{kname}"
            res[name] = run_query(name, lambda: proc.sssp(
                0, policy=pol.but(kernel=kern, max_sweeps=100_000)), tk)
    bfs_src = [0, g.n // 3, 2 * g.n // 3, g.n - 1]
    res["bfs"] = run_query("bfs/async/fused/batch4", lambda: proc.bfs(
        bfs_src, policy=asyn.but(kernel=fused, max_sweeps=100_000)), tk)
    for kname, kern in (("ref", None), ("fused", fused)):
        res[f"pagerank/{kname}"] = run_query(
            f"pagerank/sync/{kname}", lambda: proc.pagerank(
                policy=sync.but(kernel=kern, tol=PR_TOL["ca"],
                                max_sweeps=500)), tk)
    res["pagerank_delta"] = run_query(
        "pagerank_delta/async/fused", lambda: proc.pagerank_delta(
            policy=asyn.but(kernel=fused, tol=PR_TOL["ca"],
                            max_sweeps=500)), tk)
    res["cc"] = run_query("cc/async/fused", lambda: proc.connected_components(
        policy=asyn.but(kernel=fused, max_sweeps=100_000)), tk)
    res["kcore3"] = run_query("kcore3/async/fused", lambda: proc.kcore(
        3, policy=asyn.but(kernel=fused, max_sweeps=100_000)), tk)
    res["reach"] = run_query(
        "reachability/sync/fused", lambda: proc.reachability(
            0, policy=sync.but(kernel=fused, max_sweeps=100_000)), tk)
    launches = dict(tk.launch_counts)   # the main path ends here
    emit(phase="main_path_launches", **launches)
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was never launched on the main path")
    # the sync engine only: the async one issues ~20 torch ops per group
    # and 64 groups per sweep, more events than the profiler digests fast
    device_share("sssp/sync/fused", lambda: proc.sssp(
        0, policy=sync.but(kernel=fused, max_sweeps=100_000)))

    # values: fused == unfused for the exact rules; oracles for all
    base = res["sssp/sync/ref"]
    for name in ("sssp/sync/fused", "sssp/async/ref", "sssp/async/fused"):
        np.testing.assert_array_equal(res[name].values, base.values)
    for mode in ("sync", "async"):
        a, b = res[f"sssp/{mode}/ref"], res[f"sssp/{mode}/fused"]
        if a.stats.sweeps != b.stats.sweeps:
            raise AssertionError(f"sssp {mode}: fused sweeps differ")
    # the fused loop skips rows whose inputs moved by less than tol
    np.testing.assert_allclose(res["pagerank/fused"].values,
                               res["pagerank/ref"].values, rtol=0,
                               atol=100 * PR_TOL["ca"] / (1 - 0.85))
    t1 = time.perf_counter()
    check_oracle("sssp", g, base.values, 0)
    for q, s in enumerate(bfs_src):
        check_oracle("bfs", g, res["bfs"].values[q], s)
    for name in ("pagerank/ref", "pagerank/fused", "pagerank_delta"):
        check_oracle("pagerank", g, res[name].values, tol=PR_TOL["ca"])
    check_oracle("cc", g, res["cc"].values)
    check_oracle("kcore3", g, res["kcore3"].values)
    check_oracle("reachability", g, res["reach"].values, 0)
    emit(phase="oracles", seconds=time.perf_counter() - t1, ok=True)

    # the power-law stand-in (load imbalance: one hub row sets K)
    gf = G.make_paper_graph("fb", scale=FB_SCALE, seed=0)
    pf = api.GraphProcessor(gf, b=32, num_clusters=64, device=DEVICE)
    pf.prepare("min_plus")  # plans first: the query walls time queries
    pf.prepare("plus_times", normalize="out_stochastic")
    for mode, pol in (("sync", sync), ("async", asyn)):
        r = run_query(f"fb/sssp/{mode}/fused", lambda: pf.sssp(
            0, policy=pol.but(kernel=fused, max_sweeps=100_000)), tk)
        check_oracle("sssp", gf, r.values, 0)
    r = run_query("fb/pagerank/sync/fused", lambda: pf.pagerank(
        policy=sync.but(kernel=fused, tol=PR_TOL["fb"], max_sweeps=500)),
        tk)
    check_oracle("pagerank", gf, r.values, tol=PR_TOL["fb"])
    pfk = pf.prepare("min_plus")
    emit(phase="fb_plan", n=gf.n, nnz=gf.nnz, r_pad=pfk.r_pad,
         k_max=pfk.k_max, tiles=pfk.tiles_total,
         vals_gb=pfk.vals.numel() * 4 / 1e9)
    return proc, g, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bsr_spmv as tk  # the port, not JAX
    from repro_torch.core import engine as E
    from repro_torch.core import graph as G

    # 1. the card
    smi = nvidia_smi()
    name, limit = [s.strip() for s in smi.split(",", 1)]
    CARD.update(name=name, power_limit=limit)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    lib = tk.build()
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib.name)
    print(lib.with_suffix(".log").read_text(), flush=True)

    # 3. kernel vs plain at the scale-0.02 CA plans
    gen = torch.Generator().manual_seed(0)
    errs = Errors()
    g02 = G.make_paper_graph("ca", scale=SMALL_SCALE, seed=0)
    for b in (16, 32):
        for semiring in SEMIRINGS:
            p = E.prepare(g02, semiring, b=b, num_clusters=64,
                          device=DEVICE)
            compare_plan(p.vals, p.cols, p.nnz, p.r_pad, semiring, errs,
                         gen, f"ca-0.02 b={b}")
            if semiring == "min_plus":
                garbage_check(p.vals, p.cols, p.nnz, p.r_pad, semiring,
                              gen)
    emit(phase="kernel_vs_plain", ok=True, max_abs_err=errs.max)

    # 4. the main path
    proc, g, launches = main_path(errs, gen)

    # 5. times
    kernels = time_kernels(proc, g, errs, launches)

    # 6. the kernels line, the card, and the result
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
