"""Self-timed asynchronous distributed engine — the paper's thesis at
the distributed level.

The JAX package's ``core/async_dist.py`` in PyTorch, on the same mesh of
slots as the bulk-synchronous engine (``core/placement.py``).  That
engine halo-exchanges every shard on every sweep: each sweep is paced by
the global worst case — the global-clock execution the paper argues
against.  This module is the *self-timed* counterpart, one flavor knob
away (``ExecutionPolicy(mode="distributed", dist_flavor="async",
local_sweeps=k)``):

  * **k local sweeps per halo exchange.**  Each shard runs ``k``
    Gauss-Seidel-style relaxation sweeps between exchanges: local reads
    are always fresh, remote reads come from the halo buffered at the
    start of the round.  For idempotent, monotone update rules
    (``semiring.UPDATE_RULES``) a stale remote value is a not-yet-
    improved bound, so the fixpoint is untouched while the exchange
    count drops by up to ``k``.

  * **Self-timed shard pacing.**  A shard whose local sweep improved
    nothing idles for the rest of the round; ``DistStats.shard_sweeps``
    reports the per-shard active sweep counts.

  * **Interior first.**  The first sweep of a round relaxes *interior*
    rows — rows whose in-tiles all live on this shard — then the
    boundary rows against the landed halo overlaid with the freshened
    interior values.  Each slot keeps its own copy of the gathered
    buffer with its state as a view of its rows there, so the buffer
    always reads that overlay; interior rows read only local columns, so
    they read the same values there as from the JAX engine's local view.
    The JAX engine gathers in two tiles so XLA can overlap them with the
    interior sweep; here one copy per slot does, and overlap across CUDA
    streams is left for later.

  * **Cheap convergence voting.**  The first sweep of every round is a
    complete relaxation pass against the round-start global state, so
    "no improvement anywhere" (one flag per query, OR-ed over "graph") is
    an exact global-fixpoint test.  Per-query freezing matches the sync
    engine, so converged states are **bit-identical** to the bulk-
    synchronous path on every mesh factorization for the *exact* rules
    and tolerance-bounded for accumulation rules like
    ``pagerank_delta``.

On CUDA tensors a slot launches the compacted SpMV kernel twice in a
round's first sweep (interior, then boundary) and once in each of its
``k - 1`` later sweeps, masked where a query or shard idles; the host
reads the device once a round.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import semiring as sr
from .engine import Prepared, _scalars
from .. import resilience
from .placement import (DistStats, GraphMesh,  # noqa: F401 (re-export)
                        ShardedBatch, _Rounds, _Slots, _x0_tensor,
                        shard_batched_inputs)


def distributed_async_run_batched(
        p: Prepared, x0, apply_kind: str = "relax",
        damping: float = 0.85, tol: float = 1e-6, max_sweeps: int = 10_000,
        mesh: Optional[GraphMesh] = None, query_axis: Optional[int] = None,
        local_sweeps: int = 2) -> Tuple[torch.Tensor, DistStats]:
    """Batched self-timed distributed engine: one round loop over the 2-D
    ``("graph", "query")`` mesh, ``local_sweeps`` relaxations per halo
    exchange.

    Same input layout and padding as the bulk-synchronous engine (both
    run on :func:`placement.shard_batched_inputs`); only the sweep /
    exchange schedule differs, so the converged state is bit-identical
    (exact rules) or tolerance-bounded (accumulation rules) while
    ``DistStats.halo_exchanges`` shrinks toward ``sweeps /
    local_sweeps``.

    Eligibility comes from the update-rule registry
    (``semiring.UPDATE_RULES``): the k-local-sweep schedule relies on
    the rule being idempotent and monotone (stale remote values are
    conservative bounds).  Classic PageRank's unconditional damped
    affine sweep is neither — use ``algo="pagerank_delta"`` or the
    bulk-synchronous flavor.
    """
    k = int(local_sweeps)
    if k < 1:
        raise ValueError(f"local_sweeps must be >= 1, got {local_sweeps}")
    if not sr.rule(apply_kind).monotone:
        eligible = sorted(n for n, r in sr.UPDATE_RULES.items()
                          if r.monotone)
        raise ValueError(
            "dist_flavor='async' requires an idempotent monotone update "
            f"rule ({', '.join(repr(e) for e in eligible)}); "
            f"apply_kind={apply_kind!r} is order-sensitive and needs the "
            "bulk-synchronous distributed engine (for PageRank, "
            "algo='pagerank_delta' is the flavor-eligible form)")
    sb = shard_batched_inputs(p, x0, mesh=mesh, query_axis=query_axis)
    # host-level fault sites (after eligibility validation, so real API
    # misuse still surfaces as ValueError, never as an injected fault):
    # a straggling shard (delay) and a failed exchange round (raise)
    resilience.fire("dist.straggler", flavor="async", batched=True,
                    shards=sb.d_g)
    resilience.fire("dist.dispatch", flavor="async", batched=True,
                    shards=sb.d_g)
    ring = sr.get(p.semiring)
    scalars = _scalars(p, damping, tol)
    st = _Slots(p, sb, own_halo=True)
    rd = _Rounds(sb, st.root)
    # per-slot counters on the slots' devices: local sweeps per query,
    # and their sum over the slot's queries
    lsw = {(s, j): torch.zeros(st.q_l, dtype=torch.int32, device=dev)
           for s, j, dev in st.slots}
    sls = {(s, j): torch.zeros((), dtype=torch.int32, device=dev)
           for s, j, dev in st.slots}
    interior = {(s, dev): r.interior[None, :, None]
                for (s, dev), r in st.rows.items()}
    while rd.open(-(-int(max_sweeps) // k)):
        live = st.to_devices(~rd.done_dev)
        st.exchange()
        imp0 = {}
        for s, j, dev in st.slots:
            x, lq = st.x[s, j], live[j, dev][:, None, None]
            # sweep 0a — interior rows against the round-start state
            x_i, imp_i = st.relax(s, j, dev, apply_kind, ring, scalars)
            upd_i = lq & interior[s, dev]
            torch.where(upd_i, x_i, x, out=x)
            # sweep 0b — boundary rows: the landed halo overlaid with the
            # freshly relaxed interior values (Gauss-Seidel order)
            x_b, imp_b = st.relax(s, j, dev, apply_kind, ring, scalars)
            upd_b = lq & ~interior[s, dev]
            torch.where(upd_b, x_b, x, out=x)
            imp0[s, j] = ((imp_i & upd_i) | (imp_b & upd_b)).flatten(1) \
                .any(dim=1)
            lsw[s, j] += live[j, dev]
            sls[s, j] += live[j, dev].sum(dtype=torch.int32)
        # sweep 0 is exact w.r.t. the round-start global state, so this
        # is the same convergence vote the bulk-synchronous engine takes
        imp0_g = st.vote(imp0)
        # sweeps 1..k-1 — self-timed: each shard re-relaxes against the
        # buffered halo only while ITS local work keeps landing; a
        # settled shard idles until the next exchange
        if k > 1:
            active = st.to_devices(~rd.done_dev & imp0_g)
            for s, j, dev in st.slots:
                x, still = st.x[s, j], imp0[s, j]
                for _ in range(k - 1):
                    go = active[j, dev] & still
                    x_n, imp = st.relax(s, j, dev, apply_kind, ring,
                                        scalars)
                    torch.where(go[:, None, None], x_n, x, out=x)
                    still = imp.flatten(1).any(dim=1) & go
                    lsw[s, j] += go
                    sls[s, j] += go.sum(dtype=torch.int32)
        rd.close(imp0_g)
    # per-query sweeps are the straggler shard's; per-shard totals sum
    # the query axis
    d_g, d_q = sb.d_g, sb.d_q
    sweeps_q = torch.cat([
        torch.stack([lsw[s, j].to(st.root) for s in range(d_g)]).amax(0)
        for j in range(d_q)]).cpu().numpy()[: sb.q]
    shard_sweeps = torch.stack([
        sum(sls[s, j].to(st.root) for j in range(d_q)) for s in range(d_g)
    ]).cpu().numpy()
    stats = DistStats(
        sweeps=int(sweeps_q.max(initial=0)),
        converged=bool(rd.done[: sb.q].all()),
        halo_bytes_per_sweep=sb.halo_bytes_per_exchange(p.b),
        cut_fraction=p.clustering.cut_fraction,
        mesh_shape=(d_g, d_q), query_sweeps=sweeps_q,
        halo_exchanges=rd.rounds, local_sweeps=k,
        shard_sweeps=shard_sweeps, host_syncs=rd.syncs,
        copy_bytes_per_exchange=st.copy_bytes)
    return st.gather()[: sb.q], stats


def distributed_async_run(
        p: Prepared, x0, apply_kind: str = "relax",
        damping: float = 0.85, tol: float = 1e-6, max_sweeps: int = 10_000,
        mesh: Optional[GraphMesh] = None,
        local_sweeps: int = 2) -> Tuple[torch.Tensor, DistStats]:
    """Single-source self-timed distributed run: the batched engine with
    a query axis of one (``query_axis=1`` keeps the whole device grid on
    "graph", matching ``distributed_sync_run``'s 1-D layout)."""
    x, stats = distributed_async_run_batched(
        p, _x0_tensor(p, x0)[None], apply_kind=apply_kind, damping=damping,
        tol=tol, max_sweeps=max_sweeps, mesh=mesh, query_axis=1,
        local_sweeps=local_sweeps)
    return x[0], stats
