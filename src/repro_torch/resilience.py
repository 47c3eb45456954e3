"""Deterministic fault injection + the transient-error taxonomy.

Same sites, specs and seeded RNG as the JAX package's ``resilience``
module, so one fault plan fires at the same hooks in both packages.  In
this package the local engines fire ``engine.run``, ``kernels.ops.
select_kernel`` fires ``kernel.select``, the plan store (``serve/
graph.py``) ``planstore.disk_write`` and ``planstore.disk_read``, the
wave scheduler (``serve/sched.py``) ``sched.dispatch``, and the
distributed engines (``core/placement.py``, ``core/async_dist.py``)
``dist.straggler`` and ``dist.dispatch`` at their host entry.

The paper's architecture argument is that a self-timed array keeps
making progress at each element's *actual* local behavior instead of
stalling on the global worst case.  The serving stack earns that claim
only if it survives the failure modes a real fleet produces: corrupt
plan bytes on disk, a kernel dispatch that dies at trace time, a
straggling or failed shard exchange, a wave dispatch that hangs.  This
module makes those failures *reproducible* so the recovery machinery
(scheduler retries, the ``ExecutionPolicy`` degradation ladder,
``PlanStore`` quarantine, the wave watchdog) is tested against the
exact events it claims to absorb.

Usage::

    from repro_torch import resilience as rz
    plan = rz.FaultPlan([rz.FaultSpec("kernel.select", count=1,
                                      where={"impl": "pallas"})], seed=7)
    with rz.inject(plan):
        res = proc.sssp(0)          # first pallas dispatch fails,
                                    # the ladder retries with ref
    plan.stats()                    # {"kernel.select": {...}}

Design rules:

  * **Off by default, zero overhead when disabled.**  Every hook first
    reads one module global; with no plan installed that is the whole
    cost.  No site changes work counters, so modeled benchmark numbers
    (``BENCH_graph.json``) are bit-identical with injection disabled.
  * **Deterministic.**  A ``FaultPlan`` owns one seeded RNG; given the
    same seed and the same call sequence it injects at the same hooks.
  * **Sites are host-level.**  Hooks live in Python dispatch/IO code
    (trace time for jitted engines), never inside compiled kernels —
    injection must not perturb the compiled program itself.

Registered sites (``SITES``):

  planstore.disk_read    corrupt the plan payload bytes after a disk
                         read (``mode="corrupt"``) — exercises the
                         checksum + quarantine path
  planstore.disk_write   fail the best-effort disk write
                         (``exc="oserror"`` keeps the store's
                         best-effort contract observable)
  kernel.select          raise at ``kernels.ops.select_kernel`` —
                         kernel dispatch/trace failure; ctx carries
                         ``op``/``impl``/``fused`` for targeting
  engine.run             raise at the local engine entry points
                         (``run_sync``/``run_async`` and batched)
  dist.dispatch          raise at the distributed engines' host entry —
                         a failed exchange round; ctx carries
                         ``flavor``/``batched``
  dist.straggler         sleep at the distributed engines' host entry —
                         a straggling shard delaying the whole dispatch
  sched.dispatch         raise or sleep inside ``WaveScheduler``'s wave
                         dispatch — a crashed or hung wave (the sleep
                         form is what the watchdog reaps)
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Dict, Iterable, Optional, Tuple, Union

SITES = (
    "planstore.disk_read",
    "planstore.disk_write",
    "kernel.select",
    "engine.run",
    "dist.dispatch",
    "dist.straggler",
    "sched.dispatch",
)


class Transient:
    """Marker mixin: errors that MAY succeed on retry (an injected
    fault, a wave that outlived its watchdog).  The scheduler's retry
    budget applies only to these — a deterministic error (bad spec,
    missing kernel registration) re-raised N times is just N times the
    latency for the same failure."""


class FaultInjected(Transient, RuntimeError):
    """An injected fault fired at a named site (see ``FaultPlan``)."""


def is_transient(exc: BaseException) -> bool:
    return isinstance(exc, Transient)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule.

    site:     a ``SITES`` name.
    mode:     "raise" (default) | "delay" (sleep ``delay_s``) |
              "corrupt" (mangle the bytes at a data site).
    p:        injection probability per matching hit (plan-seeded RNG).
    count:    stop after this many injections (None = unlimited).
    after:    skip this many matching hits before injecting.
    delay_s:  sleep length for ``mode="delay"``.
    exc:      "fault" raises ``FaultInjected``; "oserror" raises
              ``OSError`` (for sites whose real-world failure is IO,
              e.g. ``planstore.disk_write``).
    where:    context filter — only hits whose ctx matches every
              (key, value) pair are eligible; a dict is accepted and
              frozen to sorted items.
    """

    site: str
    mode: str = "raise"
    p: float = 1.0
    count: Optional[int] = None
    after: int = 0
    delay_s: float = 0.05
    exc: str = "fault"
    where: Union[Dict[str, object], Tuple[Tuple[str, object], ...]] = ()

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; have {SITES}")
        if self.mode not in ("raise", "delay", "corrupt"):
            raise ValueError(f"mode must be raise|delay|corrupt: "
                             f"{self.mode!r}")
        if self.exc not in ("fault", "oserror"):
            raise ValueError(f"exc must be fault|oserror: {self.exc!r}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1]: {self.p!r}")
        if isinstance(self.where, dict):
            object.__setattr__(
                self, "where", tuple(sorted(self.where.items())))

    def matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.where)


class FaultPlan:
    """A seeded set of ``FaultSpec`` rules plus per-site accounting.

    Thread-safe: hooks fire from scheduler workers, warm threads, and
    client threads concurrently.  ``stats()`` reports, per site, how
    many hook hits matched a rule and how many actually injected —
    the observability half of the acceptance story ("every submitted
    request resolves AND the faults really happened").
    """

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._rng = random.Random(f"repro-faults:{self.seed}")
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._spec_hits = [0] * len(self.specs)
        self._spec_fired = [0] * len(self.specs)

    def _arm(self, site: str, ctx: dict, modes: Tuple[str, ...]
             ) -> Optional[FaultSpec]:
        """The spec that should inject at this hit, or None (counts
        either way)."""
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            for i, s in enumerate(self.specs):
                if (s.site != site or s.mode not in modes
                        or not s.matches(ctx)):
                    continue
                self._spec_hits[i] += 1
                if self._spec_hits[i] <= s.after:
                    continue
                if s.count is not None and self._spec_fired[i] >= s.count:
                    continue
                if s.p < 1.0 and self._rng.random() >= s.p:
                    continue
                self._spec_fired[i] += 1
                self._injected[site] = self._injected.get(site, 0) + 1
                return s
        return None

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            sites = set(self._hits) | set(self._injected)
            return {s: {"hits": self._hits.get(s, 0),
                        "injected": self._injected.get(s, 0)}
                    for s in sorted(sites)}


# the active plan: one module global so the disabled fast path is a
# single attribute read at every hook
_ACTIVE: Optional[FaultPlan] = None
_INSTALL_LOCK = threading.Lock()


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    with _INSTALL_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already installed; "
                               "uninstall() it first")
        _ACTIVE = plan


def uninstall() -> None:
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """``with rz.inject(plan): ...`` — install for the block, always
    uninstall after (also on exceptions, which injection produces by
    design)."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def fire(site: str, **ctx) -> None:
    """Raise/sleep hook.  No-op (one global read) with no plan active."""
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan._arm(site, ctx, ("raise", "delay"))
    if spec is None:
        return
    if spec.mode == "delay":
        time.sleep(spec.delay_s)
        return
    msg = f"injected fault at {site}" + (f" {ctx}" if ctx else "")
    if spec.exc == "oserror":
        raise OSError(msg)
    raise FaultInjected(msg)


def corrupt_bytes(site: str, data: bytes, **ctx) -> bytes:
    """Data-corruption hook: returns ``data`` with one byte flipped when
    a ``mode="corrupt"`` rule fires, else ``data`` unchanged."""
    plan = _ACTIVE
    if plan is None:
        return data
    spec = plan._arm(site, ctx, ("corrupt",))
    if spec is None or not data:
        return data
    # flip a byte in the back half: headers/magic survive, so the
    # corruption is caught by the checksum, not by format parsing
    pos = len(data) // 2 + len(data) // 4
    return data[:pos] + bytes([data[pos] ^ 0xFF]) + data[pos + 1:]
