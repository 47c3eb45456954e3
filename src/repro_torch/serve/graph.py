"""GraphService — the multi-graph serving gateway, on the card.

The JAX package's ``serve/graph.py`` in PyTorch, with the same names,
fields, stats keys and behaviour.  The paper's amortization argument,
taken to system scale: compile-time work (profile → cluster → place →
BSR build, Fig. 4) is done once and *kept*, so the run-time engines serve
queries at run-time speed.  ``GraphProcessor`` holds that split per
session; this module holds it per *fleet*:

  * ``PlanStore`` — a bounded LRU of ``Prepared`` plan images keyed by
    ``(graph_fingerprint, PlanKey)`` with byte-size accounting, shared by
    every graph registered in a service, and backed by a persistent
    on-disk cache so a restarted process warm-loads plans instead of
    re-running the compile pipeline (PIUMA / GraphScale's load-once /
    query-many shape surviving the process boundary).

  * ``GraphService`` — the front door: a named graph registry
    (``register / get / evict``), direct ``run``, and a ``submit(...) →
    ticket`` / ``gather()`` queue that coalesces same-plan single-source
    requests of coalescible algorithms (``AlgorithmSpec.coalescible``:
    SSSP/BFS out of the box) into one batched run (the slot/wave
    pattern of ``serve.engine.ServeLoop``, with the query axis playing
    the slot axis).

    svc = GraphService(cache_dir="~/.cache/repro-plans",
                       max_plan_bytes=256 << 20)      # device="cuda"
    svc.register("roads", g, b=16, num_clusters=64)
    t0 = svc.submit("roads", QuerySpec(algo="sssp", sources=(0,)))
    t1 = svc.submit("roads", QuerySpec(algo="sssp", sources=(9,)))
    out = svc.gather()        # one batched run served both tickets

On the card the store's byte budget is device memory: a plan's tile
image lives on the service's ``device`` (``cuda`` unless named; without
a card and without ``device=`` the constructors raise), the LRU decides
which plans stay there, and an evicted plan leaves the card once no
caller holds it any more (a ``Result`` holds its plan).  A plan loaded
from the disk tier is uploaded to that device and builds its compacted
SpMV index again at its first query.  A wave under ``mode=
"distributed"`` runs as one batched round loop over the session's mesh
(``core/placement.py``), and each of its tickets carries the engine's
``DistStats`` as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import threading
import time
import warnings
import zipfile
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import resilience
from ..core import engine as eng
from ..core.algorithms import get_algorithm
from ..core.api import (ExecutionPolicy, GraphProcessor, PlanKey, QuerySpec,
                        Result, validate_spec)
from ..core.engine import Prepared, resolve_device
from ..core.graph import Graph
from ..kernels.spec import KernelSpec


def _plan_filename(fingerprint: str, key: PlanKey) -> str:
    kd = hashlib.blake2b(repr(key).encode(), digest_size=12).hexdigest()
    return f"{fingerprint}-{kd}.plan.npz"


# the plan access log lives beside the serialized plans; it is what lets
# a restarted server *warm* a graph's hot plans at register() time
# instead of on the first unlucky request (serve.server.GraphServer)
ACCESS_LOG = "plan_access.json"
# kernel tuning records keyed like plans: (fingerprint,
# PlanKey-with-kernel).  ``GraphProcessor._ensure_tuning`` measures a
# record with ``kernels/autotune.py`` at the first query of an
# ``autotune=True`` spec, under ``tuning_lock`` (so once per key, however
# many waves race to it), and stores it here; the sidecar log keeps it
# across restarts.  A log written by the JAX package's store holds knobs
# measured on its Pallas kernel; they are valid knobs here too, and the
# port runs them as they are
TUNINGS_LOG = "plan_tunings.json"
_ACCESS_FLUSH_S = 1.0   # throttle: at most one log write per second
# corrupt cache files are MOVED here (not deleted): evidence survives
# for postmortems while the live path starts fresh
QUARANTINE_DIR = "quarantine"


def _json_checksum(obj) -> str:
    """Content digest for the JSON sidecar logs (tunings / access):
    computed over the canonical serialization of the payload half, so a
    truncated or hand-mangled file fails loudly at load instead of
    feeding half a log back into the warm path."""
    blob = json.dumps(obj, sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def _key_to_json(key: PlanKey) -> dict:
    return dataclasses.asdict(key)  # nested KernelSpec → nested dict


def _key_from_json(d: dict) -> PlanKey:
    kd = d.get("kernel")
    if kd is not None and not isinstance(kd, KernelSpec):
        d = dict(d, kernel=KernelSpec(**kd))
    return PlanKey(**d)


class PlanStore:
    """Bounded LRU of ``Prepared`` images with a persistent disk tier.

    Memory tier: an ordered map ``(fingerprint, PlanKey) → Prepared``
    with byte-size accounting (``Prepared.nbytes``); inserting past
    ``max_bytes`` evicts least-recently-used plans.  Disk tier (optional
    ``cache_dir``): every built plan is serialized on ``put``; a memory
    miss falls through to disk before reporting a miss, so evicted and
    cross-process plans reload without re-running the compile pipeline.
    Plans read from disk are uploaded to ``device`` (``cuda`` unless
    named).
    """

    def __init__(self, max_bytes: int = 256 << 20,
                 cache_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.max_bytes = int(max_bytes)
        self.cache_dir = os.path.expanduser(cache_dir) if cache_dir \
            else None
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
        self._mem: "collections.OrderedDict[Tuple[str, PlanKey], " \
            "Tuple[Prepared, int]]" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        self._stats = dict(mem_hits=0, disk_hits=0, misses=0, puts=0,
                           evictions=0, disk_errors=0, quarantined=0)
        # plan access counts (fingerprint → key → lookups), persisted
        # beside the on-disk plan tier so the next process knows which
        # plans are hot before it has served a single query
        self._access: Dict[str, Dict[PlanKey, int]] = {}
        self._access_dirty = False
        self._access_flushed = 0.0
        # measured kernel tunings, keyed like plans but with the
        # requesting KernelSpec folded into the PlanKey
        self._tunings: Dict[Tuple[str, PlanKey], dict] = {}
        # held while a record is measured (``GraphProcessor.
        # _ensure_tuning``), apart from ``_lock``: a measurement takes
        # seconds, and plan lookups must not wait on it
        self.tuning_lock = threading.Lock()
        if self.cache_dir:
            self._load_access_log()
            self._load_tunings()

    # -- lookup ----------------------------------------------------------

    def get(self, fingerprint: str, key: PlanKey) -> Optional[Prepared]:
        self._record_access(fingerprint, key)
        with self._lock:
            ent = self._mem.get((fingerprint, key))
            if ent is not None:
                self._mem.move_to_end((fingerprint, key))
                self._stats["mem_hits"] += 1
                return ent[0]
        # disk deserialize happens OUTSIDE the lock: a multi-hundred-MB
        # plan load must not stall concurrent memory-tier hits
        p = self._load_disk(fingerprint, key)
        with self._lock:
            ent = self._mem.get((fingerprint, key))
            if ent is not None:  # raced with another loader: prefer it
                self._mem.move_to_end((fingerprint, key))
                self._stats["mem_hits"] += 1
                return ent[0]
            if p is not None:
                self._stats["disk_hits"] += 1
                self._insert(fingerprint, key, p)
                return p
            self._stats["misses"] += 1
            return None

    def put(self, fingerprint: str, key: PlanKey, p: Prepared) -> None:
        path = payload = None
        if self.cache_dir:
            path = os.path.join(self.cache_dir,
                                _plan_filename(fingerprint, key))
            if not os.path.exists(path):
                payload = eng.serialize_prepared(p)  # outside the lock
        with self._lock:
            self._stats["puts"] += 1
            self._insert(fingerprint, key, p)
        if payload is not None:
            # disk tier is best-effort on write, like it is on read: a
            # full/read-only cache dir must not fail a query whose plan
            # is already good in memory
            try:
                resilience.fire("planstore.disk_write", path=path)
                tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
                with open(tmp, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)  # atomic vs concurrent readers
            except (OSError, resilience.FaultInjected):
                with self._lock:
                    self._stats["disk_errors"] += 1

    def __contains__(self, fp_key: Tuple[str, PlanKey]) -> bool:
        with self._lock:
            return fp_key in self._mem

    def peek(self, fingerprint: str, key: PlanKey) -> Optional[Prepared]:
        """Memory-tier lookup WITHOUT stats or access accounting — for
        cost estimation (``GraphService.wave_cost``) and other
        introspection that must not skew hit rates or the warming log."""
        with self._lock:
            ent = self._mem.get((fingerprint, key))
            return ent[0] if ent is not None else None

    # -- internals -------------------------------------------------------

    def _insert(self, fingerprint: str, key: PlanKey, p: Prepared) -> None:
        k = (fingerprint, key)
        if k in self._mem:
            self._bytes -= self._mem[k][1]
            del self._mem[k]
        nb = p.nbytes
        self._mem[k] = (p, nb)
        self._bytes += nb
        # never evict the entry just inserted: a single plan larger than
        # the whole budget must still be servable (the budget overshoots
        # by one plan rather than degrading to rebuild-per-query)
        while self._bytes > self.max_bytes and len(self._mem) > 1:
            _, (_, old_nb) = self._mem.popitem(last=False)
            self._bytes -= old_nb
            self._stats["evictions"] += 1

    def _load_disk(self, fingerprint: str,
                   key: PlanKey) -> Optional[Prepared]:
        if not self.cache_dir:
            return None
        path = os.path.join(self.cache_dir,
                            _plan_filename(fingerprint, key))
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                data = f.read()
            data = resilience.corrupt_bytes("planstore.disk_read", data,
                                            path=os.path.basename(path))
            return eng.deserialize_prepared(data, self.device)
        except eng.PlanIntegrityError as e:
            # checksum says the bytes rotted: keep the evidence aside,
            # rebuild the plan from source — a disk-tier entry is a
            # cache, never the only copy of anything
            self._quarantine(path, str(e))
            return None
        except (ValueError, OSError, KeyError, EOFError,
                zipfile.BadZipFile):
            # stale format / truncated write: drop and rebuild
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def _quarantine(self, path: str, reason: str) -> None:
        """Move a corrupt cache file into ``quarantine/`` (best-effort:
        falls back to deletion), count it, and warn — the live path
        starts fresh either way."""
        qdir = os.path.join(self.cache_dir, QUARANTINE_DIR)
        moved = os.path.join(qdir, f"{os.path.basename(path)}."
                             f"{os.getpid()}")
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(path, moved)
        except OSError:
            try:
                os.remove(path)
            except OSError:
                pass
        with self._lock:
            self._stats["quarantined"] += 1
        warnings.warn(
            f"quarantined corrupt plan-store file "
            f"{os.path.basename(path)!r}: {reason}", RuntimeWarning,
            stacklevel=3)

    # -- kernel tuning records -------------------------------------------

    def get_tuning(self, fingerprint: str, key: PlanKey) -> Optional[dict]:
        with self._lock:
            return self._tunings.get((fingerprint, key))

    def put_tuning(self, fingerprint: str, key: PlanKey,
                   record: dict) -> None:
        with self._lock:
            self._tunings[(fingerprint, key)] = dict(record)
        self._flush_tunings()

    def _flush_tunings(self) -> None:
        if not self.cache_dir:
            return
        with self._lock:
            body = [[fp, _key_to_json(k), rec]
                    for (fp, k), rec in self._tunings.items()]
        doc = {"version": 2, "tunings": body,
               "checksum": _json_checksum(body)}
        path = os.path.join(self.cache_dir, TUNINGS_LOG)
        try:
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)  # atomic vs concurrent readers
        except OSError:
            with self._lock:
                self._stats["disk_errors"] += 1

    def _load_tunings(self) -> None:
        path = os.path.join(self.cache_dir, TUNINGS_LOG)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            self._check_sidecar(doc, "tunings", (1, 2))
            self._tunings = {
                (fp, _key_from_json(kd)): rec
                for fp, kd, rec in doc.get("tunings", [])}
        except (OSError, ValueError, TypeError, KeyError) as e:
            # a corrupt tunings log only costs a re-measure — warn,
            # quarantine the file, start fresh (never raise from the
            # store constructor)
            self._quarantine(path, f"{type(e).__name__}: {e}")
            self._tunings = {}

    @staticmethod
    def _check_sidecar(doc: dict, body_key: str, versions: tuple) -> None:
        """Validate a JSON sidecar log: known version, and (v2+) the
        body matches its recorded checksum.  Raises ValueError —
        callers quarantine and start fresh."""
        v = doc.get("version")
        if v not in versions:
            raise ValueError(f"unknown {body_key} log version {v!r}")
        if v >= 2 and doc.get("checksum") != _json_checksum(
                doc.get(body_key, [] if body_key == "tunings" else {})):
            raise ValueError(f"{body_key} log checksum mismatch")

    # -- plan access log (feeds serve.server plan warming) ---------------

    def _record_access(self, fingerprint: str, key: PlanKey) -> None:
        if not self.cache_dir:
            return   # no disk tier → nowhere to persist, nothing to warm
        with self._lock:
            per = self._access.setdefault(fingerprint, {})
            per[key] = per.get(key, 0) + 1
            self._access_dirty = True
            due = time.monotonic() - self._access_flushed >= _ACCESS_FLUSH_S
        if due:
            self.flush_access_log()

    def hot_keys(self, fingerprint: str,
                 limit: Optional[int] = None) -> List[PlanKey]:
        """A graph's plans, most-requested first — what ``register()``
        should speculatively prepare before traffic arrives."""
        with self._lock:
            per = sorted(self._access.get(fingerprint, {}).items(),
                         key=lambda kv: (-kv[1], repr(kv[0])))
        keys = [k for k, _ in per]
        return keys[:limit] if limit is not None else keys

    def flush_access_log(self) -> None:
        """Persist access counts (best-effort, atomic, throttled by the
        callers; explicit so servers can flush on close)."""
        if not self.cache_dir:
            return
        with self._lock:
            if not self._access_dirty:
                return
            body = {fp: [[_key_to_json(k), c] for k, c in per.items()]
                    for fp, per in self._access.items()}
            doc = {"version": 2, "graphs": body,
                   "checksum": _json_checksum(body)}
            self._access_dirty = False
            self._access_flushed = time.monotonic()
        path = os.path.join(self.cache_dir, ACCESS_LOG)
        try:
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            with self._lock:
                self._stats["disk_errors"] += 1

    def _load_access_log(self) -> None:
        path = os.path.join(self.cache_dir, ACCESS_LOG)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                doc = json.load(f)
            self._check_sidecar(doc, "graphs", (1, 2))
            self._access = {
                fp: {_key_from_json(kd): int(c) for kd, c in per}
                for fp, per in doc.get("graphs", {}).items()}
        except (OSError, ValueError, TypeError, KeyError) as e:
            # a corrupt log only costs warming, never correctness
            self._quarantine(path, f"{type(e).__name__}: {e}")
            self._access = {}

    # -- introspection ---------------------------------------------------

    def keys(self) -> List[Tuple[str, PlanKey]]:
        with self._lock:
            return list(self._mem)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats, plans=len(self._mem),
                     bytes=self._bytes, max_bytes=self.max_bytes,
                     tunings=len(self._tunings))
            lookups = s["mem_hits"] + s["disk_hits"] + s["misses"]
            # per-tier rates: a memory hit is free, a disk hit still
            # pays a deserialize — capacity tuning needs to see both
            s["mem_hit_rate"] = s["mem_hits"] / lookups if lookups \
                else 0.0
            s["disk_hit_rate"] = s["disk_hits"] / lookups if lookups \
                else 0.0
            s["hit_rate"] = s["mem_hit_rate"] + s["disk_hit_rate"]
            return s


@dataclasses.dataclass
class _Pending:
    ticket: int
    name: str
    spec: QuerySpec


class GraphService:
    """Multi-graph serving gateway: registry + shared plan store + a
    coalescing request front door.

    All registered graphs borrow plans from one ``PlanStore`` (one byte
    budget, one eviction policy, one persistence path), so the service —
    not each session — owns the memory/rebuild trade-off.  Every
    processor and the store run on ``device``.
    """

    def __init__(self, max_plan_bytes: int = 256 << 20,
                 cache_dir: Optional[str] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 max_wave: int = 64, device=None):
        self.store = PlanStore(max_bytes=max_plan_bytes,
                               cache_dir=cache_dir, device=device)
        self.device = self.store.device
        self.policy = policy
        self.max_wave = int(max_wave)
        self._procs: Dict[str, GraphProcessor] = {}
        self._pending: List[_Pending] = []
        self._dead: Dict[int, Exception] = {}  # tickets killed by evict()
        self._next_ticket = 0
        self._lock = threading.RLock()
        self._coalesced_queries = 0
        self._batched_runs = 0
        self._degraded_runs = 0

    # -- graph registry --------------------------------------------------

    def register(self, name: str, g: Graph, b: int = 32,
                 num_clusters: Optional[int] = None,
                 clustered: bool = True, seed: int = 0,
                 policy: Optional[ExecutionPolicy] = None
                 ) -> GraphProcessor:
        """Admit a graph under ``name``; returns its processor.

        Re-registering the same name with the identical graph AND
        identical session parameters is a no-op (idempotent restarts);
        any difference — graph contents, tiling, clustering knobs,
        default policy — under a live name is an error: ``evict`` first.
        """
        with self._lock:
            if name in self._procs:
                old = self._procs[name]
                same = (old.g.fingerprint() == g.fingerprint()
                        and (old.b, old.num_clusters, old.clustered,
                             old.seed) == (b, num_clusters, clustered,
                                           seed)
                        and old.policy == (policy or self.policy
                                           or ExecutionPolicy()))
                if same:
                    return old
                raise ValueError(
                    f"graph name {name!r} is already registered with "
                    "different contents or session parameters; "
                    "evict() it first")
            proc = GraphProcessor(
                g, b=b, num_clusters=num_clusters, clustered=clustered,
                seed=seed, policy=policy or self.policy,
                store=self.store, device=self.device)
            self._procs[name] = proc
            return proc

    def get(self, name: str) -> GraphProcessor:
        try:
            return self._procs[name]
        except KeyError:
            raise KeyError(
                f"no graph registered as {name!r}; have "
                f"{sorted(self._procs)}") from None

    def evict(self, name: str) -> None:
        """Drop a graph from the registry.  Its plans stay in the store
        (and on disk) until LRU pressure reclaims them — re-registering
        the same graph later warm-starts.  Pending tickets for the graph
        are not lost: the next ``gather`` resolves them to a KeyError."""
        with self._lock:
            self._procs.pop(name, None)
            keep = []
            for q in self._pending:
                if q.name == name:
                    self._dead[q.ticket] = KeyError(
                        f"graph {name!r} was evicted before the query "
                        "ran")
                else:
                    keep.append(q)
            self._pending = keep

    def graphs(self) -> List[str]:
        return sorted(self._procs)

    def __contains__(self, name: str) -> bool:
        return name in self._procs

    # -- direct execution ------------------------------------------------

    def run(self, name: str, spec: QuerySpec) -> Result:
        return self._note_result(self.get(name).run(spec))

    def _note_result(self, res: Result) -> Result:
        """Service-level accounting on a completed run (degradation
        ladder outcomes — ``stats()['degraded_runs']``)."""
        if "degraded" in res.extra:
            with self._lock:
                self._degraded_runs += 1
        return res

    def wave_cost(self, name: str, algo: str, pol: ExecutionPolicy,
                  rows: int = 1) -> float:
        """Relative cost estimate for one wave: plan tiles × sweep bound
        × rows.  Uses the cached plan when one is resident (``peek`` —
        no store-stats noise), else falls back to the graph's nnz.  The
        scheduler's watchdog scales its per-wave deadline by this, so
        big graphs aren't reaped on the schedule of small ones."""
        proc = self.get(name)
        a = get_algorithm(algo)
        pk = proc.plan_key(a.semiring, variant=a.variant, pull=a.pull,
                           normalize=a.normalize)
        p = self.store.peek(proc.g.fingerprint(), pk)
        tiles = float(p.tiles_total) if p is not None \
            else float(proc.g.nnz)
        return tiles * max(int(pol.max_sweeps), 1) * max(int(rows), 1)

    # -- coalescing front door -------------------------------------------

    def wave_key(self, name: str, spec: QuerySpec) -> Optional[tuple]:
        """Validate a request and resolve its coalescing key.

        Raises ``KeyError`` for unregistered names and ``ValueError``/
        ``TypeError`` for specs that can never execute — at *submit*
        time, so a bad request cannot poison the batch it would have
        ridden in.  Returns ``(name, algo, resolved_policy)`` when the
        request can share a batched wave (single-source queries of an
        algorithm whose ``AlgorithmSpec.coalescible`` is set — same key
        ⇒ same plan ⇒ same wave), else ``None`` (run individually).
        Shared by ``submit``/``gather`` and the background scheduler
        (``serve.sched.WaveScheduler``) so both front doors group
        requests exactly as ``run`` would execute them.
        """
        proc = self.get(name)  # fail fast on unknown graphs
        validate_spec(spec)
        pol = proc.resolve_policy(spec)  # surfaces bad params/fields
        if (get_algorithm(spec.algo).coalescible and not spec.batched
                and len(spec.sources) == 1):
            return (name, spec.algo, pol)
        return None

    def submit(self, name: str, spec: QuerySpec) -> int:
        """Enqueue one query; returns a ticket for ``gather``.

        Invalid requests are rejected here, not at ``gather`` — a bad
        spec must not poison the batch it would have ridden in.
        """
        self.wave_key(name, spec)
        with self._lock:
            t = self._next_ticket
            self._next_ticket += 1
            self._pending.append(_Pending(t, name, spec))
            return t

    def gather(self) -> Dict[int, Union[Result, Exception]]:
        """Run everything pending and return ``{ticket: Result}``.

        Single-source requests of coalescible algorithms that resolve to
        the same
        (graph, algorithm, policy) — hence the same plan — are coalesced
        into batched runs of up to ``max_wave`` sources (waves, as in
        ``ServeLoop``); each ticket gets its own row of the batch.  The
        wave executes on the batched sync or async engine the resolved
        policy names, with the query axis Q = the wave's width.
        Per-query convergence is masked in both engines, so coalesced
        values are identical to what sequential ``run`` calls produce.
        Everything else (PageRank, CC, already-batched specs, …) runs
        individually.

        A query that fails at run time — or whose graph was ``evict``-ed
        while it waited — maps its ticket(s) to the raised exception
        instead of a ``Result``: every issued ticket resolves, and one
        bad request never drops the other tickets in the batch.

        Note: a coalesced ticket's ``Result.stats`` is the WAVE's
        aggregate (work counters total the whole batch; ``sweeps`` is
        the straggler's) — per-ticket only the ``values`` row is
        sliced.  ``extra["coalesced"]`` carries the wave size so
        downstream accounting can tell shared stats from per-query
        ones.
        """
        with self._lock:
            pending, self._pending = self._pending, []
            dead, self._dead = self._dead, {}
        results: Dict[int, Union[Result, Exception]] = dict(dead)
        waves: Dict[tuple, List[_Pending]] = collections.OrderedDict()
        for q in pending:
            try:
                key = self.wave_key(q.name, q.spec)
            except Exception as e:  # may race a concurrent evict()
                results[q.ticket] = e
                continue
            if key is not None:
                waves.setdefault(key, []).append(q)
            else:
                try:
                    results[q.ticket] = self.get(q.name).run(q.spec)
                except Exception as e:  # keep serving the rest
                    results[q.ticket] = e
        for (name, algo, pol), group in waves.items():
            results.update(self._run_wave(name, algo, pol, group))
        return results

    def _run_wave(self, name: str, algo: str, pol: ExecutionPolicy,
                  group: List[_Pending]
                  ) -> Dict[int, Union[Result, Exception]]:
        """Execute one coalescible group (same ``wave_key``) and map
        every ticket to its Result or Exception.

        Chunks the group into waves of at most ``max_wave`` sources and
        runs each as ONE batched dispatch, slicing per-ticket rows out —
        the engine-facing half of ``gather``, factored out so the
        background continuous-batching scheduler
        (``serve.sched.WaveScheduler``) shares the exact same execution
        path.  Thread-safe: plan lookups go through the locked
        ``PlanStore``, engine dispatch holds no service state, and the
        wave counters take ``_lock`` — concurrent callers (a ``gather``
        racing the scheduler thread) at worst build a plan twice, never
        corrupt one.
        """
        results: Dict[int, Union[Result, Exception]] = {}
        try:
            proc = self.get(name)
        except KeyError as e:  # evicted while the group waited
            return {q.ticket: e for q in group}
        for i in range(0, len(group), self.max_wave):
            wave = group[i:i + self.max_wave]
            try:
                if len(wave) == 1:
                    q = wave[0]
                    results[q.ticket] = self._note_result(
                        proc.run(q.spec))
                    continue
                sources = tuple(q.spec.sources[0] for q in wave)
                batch = self._note_result(
                    proc.run(QuerySpec(algo=algo, sources=sources,
                                       batched=True, policy=pol)))
            except Exception as e:
                for q in wave:
                    results[q.ticket] = e
                continue
            with self._lock:
                self._coalesced_queries += len(wave)
                self._batched_runs += 1
            for row, q in enumerate(wave):
                extra = {"algo": algo, "src": sources[row],
                         "coalesced": len(wave)}
                for k in ("dist", "batched_fallback", "degraded"):
                    # distributed waves: surface the engine's mesh
                    # factorization / per-query sweeps per ticket
                    if k in batch.extra:
                        extra[k] = batch.extra[k]
                if "dist" in batch.extra:
                    # which exchange schedule actually served the wave
                    extra["dist_flavor"] = pol.dist_flavor
                results[q.ticket] = Result(
                    np.asarray(batch.values[row]), batch.stats,
                    batch.prepared, extra, policy=pol,
                    graph=proc.g)
        return results

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"graphs": self.graphs(),
                    "pending": len(self._pending),
                    "coalesced_queries": self._coalesced_queries,
                    "batched_runs": self._batched_runs,
                    "degraded_runs": self._degraded_runs,
                    "plan_store": self.store.stats()}
