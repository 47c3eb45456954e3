"""Semiring algebra for graph computation — the NALE datapath abstraction.

The paper's NALE (Node Arithmetic Logic Engine) is "optimized for fast MAC
operations with a three-state output comparator".  Algebraically that is a
semiring (⊕, ⊗): the MAC is the ⊗-then-⊕-accumulate, and the three-state
comparator (smaller / equal / larger) is realized by comparing the new
⊕-reduced value against the node's current value, producing both the update
decision and the "changed" bit that feeds the asynchronous frontier.

Semirings implemented (all the paper's six algorithms reduce to these):

  plus_times : (+, ×)  — PageRank, general SpMV
  min_plus   : (min,+) — SSSP, BFS-by-level
  max_min    : (max,min) over {0,1} — boolean or_and reachability
  min_select : (min, select-right) — connected-components label propagation

The ops are torch functions on tensors.  User-defined semirings register
through :func:`register`; the reduction is a field on the dataclass (with
a generic ⊕-fold fallback), so a custom ring runs through every engine
and the plain SpMV without touching dispatch code.

This module also hosts the :class:`UpdateRule` registry — the engine-side
half of an algorithm's identity.  A rule names the apply step (how the
⊕-reduced neighbourhood value ``y`` combines with the node's current
value) and carries the scheduling properties every engine flavor keys on:

  bias     — the rule has a constant term (PageRank's (1−d)/n, k-core's
             threshold test), so every valid row must be touched at
             least once even when none of its inputs changed.
  monotone — the update is idempotent and monotone, so a stale input is
             just a not-yet-improved bound; these rules are eligible for
             the self-timed schedules (async engine skipping).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _reducer(fn):
    """Adapt a torch reduction to the ``reduce_fn(x, axis=None)`` field
    signature (``axis=None`` reduces everything)."""
    def reduce_fn(x: Tensor, axis=None) -> Tensor:
        return fn(x) if axis is None else fn(x, dim=axis)
    return reduce_fn


@dataclasses.dataclass(frozen=True)
class Semiring:
    """An (⊕, ⊗) pair with identities, driving both engines and kernels.

    Attributes:
      name:      stable identifier used for kernel dispatch.
      add:       ⊕, the reduction (MAC accumulate / comparator side).
      mul:       ⊗, the edge combine (MAC multiply side). mul(edge_w, x_src).
      zero:      ⊕-identity; also the padding value for absent edges, chosen
                 so that padded lanes are no-ops without explicit masks.
      one:       ⊗-identity.
      improves:  strict order test improves(new, old) -> bool tensor; the
                 "three-state comparator" output used for frontier bits.
      reduce_fn: the axis-reduction realizing ⊕ over a tensor (e.g. a
                 sum for plus_times), called as ``reduce_fn(x, axis=...)``.
                 None falls back to a generic ⊕-fold of ``add``.
    """

    name: str
    add: Callable[[Tensor, Tensor], Tensor]
    mul: Callable[[Tensor, Tensor], Tensor]
    zero: float
    one: float
    improves: Callable[[Tensor, Tensor], Tensor]
    reduce_fn: Optional[Callable[..., Tensor]] = None

    def reduce(self, x: Tensor, axis=None) -> Tensor:
        if self.reduce_fn is not None:
            return self.reduce_fn(x, axis=axis)
        # generic ⊕-fold: move the reduced axes to one leading axis, then
        # fold ``add`` over its extent.  Works for any custom ring whose
        # ``add`` is associative — no name-switch involved.
        if axis is None:
            axes = tuple(range(x.dim()))
        elif isinstance(axis, int):
            axes = (axis % x.dim(),)
        else:
            axes = tuple(a % x.dim() for a in axis)
        rest = tuple(a for a in range(x.dim()) if a not in axes)
        t = x.permute(axes + rest)
        t = t.reshape((-1,) + tuple(x.shape[a] for a in rest))
        out = t[0]
        for i in range(1, t.shape[0]):
            out = self.add(out, t[i])
        return out


def _ne(a, b):
    return a != b


PLUS_TIMES = Semiring(
    name="plus_times",
    add=lambda a, b: a + b,
    mul=lambda w, x: w * x,
    zero=0.0,
    one=1.0,
    improves=_ne,
    reduce_fn=_reducer(torch.sum),
)

MIN_PLUS = Semiring(
    name="min_plus",
    add=torch.minimum,
    mul=lambda w, x: w + x,
    zero=np.inf,
    one=0.0,
    improves=lambda new, old: new < old,
    reduce_fn=_reducer(torch.amin),
)

MAX_MIN = Semiring(
    name="max_min",
    add=torch.maximum,
    mul=torch.minimum,
    zero=0.0,  # valid ⊕-identity for the {0,1} boolean carrier
    one=1.0,
    improves=lambda new, old: new > old,
    reduce_fn=_reducer(torch.amax),
)

# CC label propagation: edge weight is ignored, the neighbour label is
# selected and min-reduced.  mul(w, x) = x  (select-right).
MIN_SELECT = Semiring(
    name="min_select",
    add=torch.minimum,
    mul=lambda w, x: x,
    zero=np.inf,
    one=0.0,
    improves=lambda new, old: new < old,
    reduce_fn=_reducer(torch.amin),
)

# the rings the hand-written kernels implement; any other registered ring
# runs on the plain torch path on every device
BUILTIN = ("plus_times", "min_plus", "max_min", "min_select")

SEMIRINGS = {s.name: s for s in (PLUS_TIMES, MIN_PLUS, MAX_MIN, MIN_SELECT)}
# alias: boolean or_and is max_min on the {0,1} carrier
SEMIRINGS["or_and"] = MAX_MIN


def register(ring: Semiring, overwrite: bool = False) -> Semiring:
    """Register a user-defined semiring for engine/kernel dispatch.

    Contract: ``mul(zero, x)`` must equal ``zero`` for every ``x`` (the
    ⊕-identity absorbs, so identity-padded tiles are no-ops without
    masks) and ``add`` must be associative (the generic reduce folds it
    in a fixed but unspecified order).
    """
    if ring.name in SEMIRINGS and not overwrite:
        raise ValueError(
            f"semiring {ring.name!r} is already registered; pass "
            "overwrite=True to replace it")
    SEMIRINGS[ring.name] = ring
    return ring


def get(name: str) -> Semiring:
    try:
        return SEMIRINGS[name]
    except KeyError:
        raise ValueError(f"unknown semiring {name!r}; have {sorted(SEMIRINGS)}")


# ---------------------------------------------------------------------------
# update rules — the engine-facing half of an algorithm's identity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """Scheduling properties of one apply rule (``apply_kind``).

    The arithmetic of a rule lives in ``core/engine._apply`` and its
    kernel mirror ``apply_rule`` in ``kernels/csrc/bsr_spmv.cu``; this
    record is what the *schedulers* consult.

    Attributes:
      name:     the apply_kind identifier.
      bias:     has a constant term — every valid row must be applied at
                least once even if none of its inputs ever change (the
                fused sync loop's sweep-0 all-rows touch, the async
                engine's first-touch activation).
      monotone: idempotent + monotone — stale inputs are conservative
                bounds, so the rule is eligible for self-timed schedules.
      exact:    schedule-independent at convergence — converged states
                are bit-identical across engine flavors (vs. tolerance-
                bounded for accumulation rules, where grouping of float
                adds differs between schedules).
    """

    name: str
    bias: bool
    monotone: bool
    exact: bool


UPDATE_RULES = {r.name: r for r in (
    # x' = y ⊕ x: the semiring relaxation (SSSP/BFS/CC/reachability).
    UpdateRule("relax", bias=False, monotone=True, exact=True),
    # x' = (1−d)/n + d·y, unconditional: classic damped PageRank sweep.
    UpdateRule("pagerank", bias=True, monotone=False, exact=False),
    # x' = max(x, (1−d)/n + d·y): delta-accumulating PageRank; rises
    # monotonically from the (1−d)/n floor, so stale reads are safe.
    UpdateRule("pagerank_delta", bias=False, monotone=True, exact=False),
    # x' = x if (x > 0 and y ≥ k) else 0: k-core membership peeling over
    # unit weights (k rides the damping scalar slot).
    UpdateRule("kcore", bias=True, monotone=True, exact=True),
    # x' = y: plain SpMV assignment (debug/diagnostic).
    UpdateRule("identity", bias=True, monotone=False, exact=False),
)}


def register_rule(r: UpdateRule, overwrite: bool = False) -> UpdateRule:
    if r.name in UPDATE_RULES and not overwrite:
        raise ValueError(
            f"update rule {r.name!r} is already registered; pass "
            "overwrite=True to replace it")
    UPDATE_RULES[r.name] = r
    return r


def rule(name: str) -> UpdateRule:
    try:
        return UPDATE_RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown update rule {name!r}; have {sorted(UPDATE_RULES)}")
