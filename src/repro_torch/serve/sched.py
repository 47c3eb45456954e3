"""Wave scheduler — continuous batching for the graph front door.

The JAX package's ``serve/sched.py`` with its imports pointed at this
package: pure Python over ``GraphService``, so the waves it closes run
the port's batched engines on the service's device.

The paper's asynchronous thesis applied to *serving*: a self-timed
element fires when its inputs are ready, not on a global clock.
``GraphService.gather`` is the bulk-synchronous version of batching —
only requests one caller queued before its barrier share a wave.
``WaveScheduler`` is the self-timed version: a background thread watches
the request stream from *all* clients, groups requests that resolve to
the same plan (``GraphService.wave_key``), and closes a wave the moment
it is worth dispatching — when a group reaches ``max_wave`` sources, or
when its oldest request has waited ``max_wait_s`` (the classic
continuous-batching policy of LLM serving engines; ``serve.engine.
ServeLoop`` plays the same game with decode slots).

Execution goes through ``GraphService._run_wave`` — the exact code path
``gather`` uses — so scheduled results are bit-identical to direct
``GraphService.run`` calls.  Requests carry an optional *deadline*; a
request that expires while queued resolves to ``DeadlineExceeded``
instead of occupying a row in a wave somebody else is waiting on.
``Future.cancel()`` before the wave closes is honored the same way: the
request is purged from its pending group at wave-close time and never
occupies a wave row (``stats()["cancelled"]`` counts them).

Failure handling (the self-healing half):

  * a wave that raises resolves ONLY that wave's futures — one bad
    request never takes down the scheduler loop or other waves;
  * *transient* failures (``resilience.Transient`` — injected
    faults, wave watchdog timeouts) are retried: the request re-enters
    the queue after an exponential backoff with jitter, up to
    ``WavePolicy.max_retries`` attempts (``stats()["retries"]`` /
    ``["retry_exhausted"]``).  Deterministic errors (bad spec, plain
    ``RuntimeError``) are never retried — they would fail identically;
  * a *wave watchdog* (``WavePolicy.watchdog_s``) abandons dispatches
    that out-run a per-wave deadline scaled by the wave's plan cost
    (``GraphService.wave_cost``): the hung dispatch can no longer
    resolve futures, its worker slot is released so the scheduler keeps
    making progress, and its requests are retried or failed with a
    structured ``WaveTimeout`` (``stats()["watchdog_timeouts"]``);
  * ``stop(drain=False)`` resolves everything still pending with a
    structured ``ServerClosed`` (a ``Backpressure`` subclass) instead of
    leaving futures hanging forever.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from .. import resilience
from ..core.api import QuerySpec
from .graph import GraphService, _Pending


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before a wave could serve it."""


class Backpressure(RuntimeError):
    """Admission control rejected a submit; ``stats`` says why (queue
    depth, plan-store thrash) so clients can back off intelligently."""

    def __init__(self, msg: str, stats: Optional[dict] = None):
        super().__init__(msg)
        self.stats = stats or {}


class ServerClosed(Backpressure):
    """The server/scheduler stopped before this request could run — the
    ultimate admission refusal.  Raised by ``GraphServer.submit`` on a
    closed server and set on every future ``stop(drain=False)``
    abandons, so no client ever blocks forever on a dead scheduler."""


class WaveTimeout(TimeoutError, resilience.Transient):
    """The wave watchdog abandoned a dispatch that out-ran its deadline.

    Transient by definition (a straggling dispatch, an injected hang) — the
    scheduler retries the wave's requests while budget remains."""


#: wave_cost units (plan tiles × sweeps × rows) that map to 1× the base
#: ``watchdog_s`` deadline; costlier waves get proportionally longer.
WATCHDOG_COST_REF = 1e8


@dataclasses.dataclass(frozen=True)
class WavePolicy:
    """Scheduler knobs (one frozen object, like ``ExecutionPolicy``).

    max_wave:    close a wave as soon as a plan-group holds this many
                 requests (rides on top of ``GraphService.max_wave``,
                 which re-chunks oversized groups defensively).
    max_wait_s:  close a wave when its oldest request has waited this
                 long, full or not — the latency half of the
                 continuous-batching trade.
    max_pending: admission control — submits beyond this many queued
                 requests are rejected with ``Backpressure``.
    workers:     dispatch slots.  1 (default) serializes waves (plan
                 builds never race); >1 lets waves for different plans
                 overlap.
    thrash_evictions / thrash_window_s:  reject submits while the shared
                 ``PlanStore`` evicted ≥ this many plans inside the
                 window — batching on top of a store that is re-building
                 plans per query only amplifies the thrash.
    max_retries: per-request retry budget for *transient* failures
                 (``resilience.is_transient``); 0 disables retries.
    backoff_base_s / backoff_cap_s / backoff_jitter:  retry n waits
                 ``min(cap, base·2ⁿ⁻¹)·(1 + jitter·U[0,1))`` before
                 re-entering the queue, so a flapping dependency is not
                 hammered in lockstep.
    watchdog_s:  per-wave deadline at ``WATCHDOG_COST_REF`` plan cost
                 (scaled up for costlier waves); ``None`` (default)
                 disables the watchdog.  An abandoned dispatch's thread
                 cannot be killed — its worker slot is released instead,
                 so true parallelism may briefly exceed ``workers``
                 while a hung wave winds down.
    """

    max_wave: int = 64
    max_wait_s: float = 0.005
    max_pending: int = 1024
    workers: int = 1
    thrash_evictions: int = 64
    thrash_window_s: float = 1.0
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    backoff_jitter: float = 0.25
    watchdog_s: Optional[float] = None

    def __post_init__(self):
        if self.max_wave < 1:
            raise ValueError(f"max_wave must be >= 1: {self.max_wave!r}")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0: {self.max_wait_s!r}")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1: {self.workers!r}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0: {self.max_retries!r}")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0 \
                or self.backoff_jitter < 0:
            raise ValueError(
                "backoff_base_s/backoff_cap_s/backoff_jitter must be "
                f">= 0: {self.backoff_base_s!r}/{self.backoff_cap_s!r}"
                f"/{self.backoff_jitter!r}")
        if self.watchdog_s is not None and self.watchdog_s <= 0:
            raise ValueError(
                f"watchdog_s must be > 0 or None: {self.watchdog_s!r}")

    def but(self, **kw) -> "WavePolicy":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class _Request:
    """One in-flight submit: a ``_Pending`` plus its future/deadline."""

    ticket: int
    name: str
    spec: QuerySpec
    key: Optional[tuple]            # GraphService.wave_key, None=solo
    future: Future
    t_submit: float                 # monotonic
    t_deadline: Optional[float]     # monotonic, None = no deadline
    attempt: int = 0                # retries consumed so far
    settled: bool = False           # resolution claimed (guarded by _cv)


@dataclasses.dataclass
class _Inflight:
    """One dispatched wave: the dispatcher thread races the watchdog
    for the right to resolve its requests (all flags under ``_cv``)."""

    key: Optional[tuple]
    wave: List[_Request]
    deadline: Optional[float]       # monotonic watchdog reap time
    wid: int = -1
    abandoned: bool = False         # watchdog gave up on the dispatcher
    slot_acquired: bool = False
    slot_released: bool = False
    thread: Optional[threading.Thread] = None


class WaveScheduler:
    """Background continuous-batching loop over a ``GraphService``.

    ``offer`` enqueues requests (thread-safe, any number of client
    threads); the scheduler thread closes waves per ``WavePolicy`` and
    dispatches each on its own worker thread (bounded by
    ``policy.workers`` slots), resolving each request's ``Future``.
    Not started until ``start()`` — a paused scheduler just accumulates
    requests, which is also what makes batching deterministic for tests
    and benchmarks.
    """

    def __init__(self, service: GraphService, policy: WavePolicy):
        self.service = service
        self.policy = policy
        self._cv = threading.Condition()
        self._groups: "collections.OrderedDict[tuple, " \
            "collections.deque[_Request]]" = collections.OrderedDict()
        self._singles: "collections.deque[_Request]" = collections.deque()
        self._pending = 0
        self._inflight = 0
        self._backoff = 0            # requests waiting out a retry delay
        self._running = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._entries: Dict[int, _Inflight] = {}
        self._next_wave_id = 0
        self._slots = threading.Semaphore(policy.workers)
        self._timers: Dict[int, Tuple[threading.Timer, _Request]] = {}
        self._rng = random.Random("repro-wave-backoff")
        self._stats = dict(waves=0, wave_queries=0, coalesced_waves=0,
                           max_wave=0, expired=0, cancelled=0,
                           completed=0, failed=0, retries=0,
                           retry_exhausted=0, watchdog_timeouts=0)

    # -- client side -----------------------------------------------------

    def offer(self, req: _Request) -> None:
        with self._cv:
            if not self._stopped:
                self._enqueue_locked(req)
                self._cv.notify_all()
                return
        # a stopped scheduler never leaves a future hanging
        if _claim(req.future):
            self._fail(req, ServerClosed("scheduler stopped",
                                         self.stats()))

    def _enqueue_locked(self, req: _Request) -> None:
        req.settled = False
        if req.key is not None:
            self._groups.setdefault(
                req.key, collections.deque()).append(req)
        else:
            self._singles.append(req)
        self._pending += 1

    def pending(self) -> int:
        with self._cv:
            return self._pending

    def evict(self, name: str) -> int:
        """Resolve every queued request for ``name`` with ``KeyError``
        (mirrors ``GraphService.evict``'s promise that pending tickets
        are never silently dropped).  Returns how many were resolved."""
        err = KeyError(f"graph {name!r} was evicted before the query "
                       "ran")
        with self._cv:
            victims: List[_Request] = []
            for key in list(self._groups):
                dq = self._groups[key]
                keep = collections.deque(
                    r for r in dq if r.name != name)
                victims += [r for r in dq if r.name == name]
                if keep:
                    self._groups[key] = keep
                else:
                    del self._groups[key]
            keep = collections.deque(
                r for r in self._singles if r.name != name)
            victims += [r for r in self._singles if r.name == name]
            self._singles = keep
            self._pending -= len(victims)
            for r in victims:
                r.settled = True
            self._cv.notify_all()
        for r in victims:
            if _claim(r.future):
                r.future.set_exception(err)
        return len(victims)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(target=self._loop,
                                            name="repro-torch-wave-sched",
                                            daemon=True)
            self._thread.start()

    def stop(self, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Stop the loop.  ``drain=True`` (default) dispatches every
        queued request first — full wave or not; ``drain=False`` fails
        the queue (and anything parked in retry backoff or stuck
        in-flight) with a structured ``ServerClosed``, so every
        outstanding future resolves."""
        with self._cv:
            self._stopped = True
            self._running = False
            self._cv.notify_all()
            thread, self._thread = self._thread, None
            # claim every parked retry: popping the timer token is the
            # ownership handoff (a timer that already fired owns itself)
            parked: List[_Request] = []
            for k in list(self._timers):
                t, req = self._timers.pop(k)
                t.cancel()
                self._backoff -= 1
                parked.append(req)
        if thread is not None:
            thread.join(timeout)
        if drain:
            with self._cv:
                for req in parked:
                    self._enqueue_locked(req)
            for key, wave in self._close_waves(force=True):
                ent = self._register_wave(key, wave)
                self._dispatch(ent)       # synchronous final flush
            self._join_inflight(timeout=None)
        else:
            err = ServerClosed("scheduler stopped", self.stats())
            for req in parked:
                if _claim(req.future):
                    self._fail(req, err)
            for _, wave in self._close_waves(force=True):
                for r in wave:
                    if _claim(r.future):
                        self._fail(r, err)
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
            self._join_inflight(timeout=timeout if timeout is not None
                                else 5.0)
            self._reap_all(err)

    def _join_inflight(self, timeout: Optional[float]) -> None:
        with self._cv:
            threads = [e.thread for e in self._entries.values()
                       if e.thread is not None]
        end = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            left = None if end is None else max(end - time.monotonic(),
                                                0.0)
            t.join(left)

    def _reap_all(self, err: Exception) -> None:
        """Abandon every still-inflight wave (dispatcher threads that
        out-lived the stop timeout) and resolve their requests."""
        doomed: List[Tuple[_Inflight, List[_Request]]] = []
        with self._cv:
            for wid in list(self._entries):
                ent = self._entries.pop(wid)
                ent.abandoned = True
                victims = [r for r in ent.wave if not r.settled]
                for r in victims:
                    r.settled = True
                self._inflight -= 1
                doomed.append((ent, victims))
            if doomed:
                self._cv.notify_all()
        for ent, victims in doomed:
            self._release_slot(ent)
            for r in victims:
                if _claim(r.future):
                    self._fail(r, err)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue, in-flight waves AND retry backoffs are
        empty (or ``timeout``); True if fully drained."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending or self._inflight or self._backoff:
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=left)
        return True

    # -- the scheduling loop ---------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    return   # stop() owns the final flush
                now = time.monotonic()
                due = self._next_event()
                if due is None or due > now:
                    wait = None if due is None else max(due - now, 1e-4)
                    self._cv.wait(timeout=wait)
                    if not self._running:
                        return
            for key, wave in self._close_waves(force=False):
                ent = self._register_wave(key, wave)
                t = threading.Thread(
                    target=self._dispatch, args=(ent,),
                    name="repro-torch-wave-dispatch", daemon=True)
                ent.thread = t
                t.start()
            self._reap_overdue()

    def _next_event(self) -> Optional[float]:
        """Earliest moment anything becomes actionable (caller holds
        ``_cv``): a single to run, a group's max-wait expiry, a full
        group (already due), a request deadline, or a watchdog reap."""
        now = time.monotonic()
        due: Optional[float] = None

        def upd(t: float):
            nonlocal due
            due = t if due is None else min(due, t)

        if self._singles:
            upd(now)
        for dq in self._groups.values():
            if len(dq) >= self.policy.max_wave:
                upd(now)
            elif dq:
                upd(dq[0].t_submit + self.policy.max_wait_s)
        for dq in list(self._groups.values()) + [self._singles]:
            for r in dq:
                if r.t_deadline is not None:
                    upd(r.t_deadline)
        for ent in self._entries.values():
            if ent.deadline is not None and not ent.abandoned:
                upd(ent.deadline)
        return due

    def _close_waves(self, force: bool
                     ) -> List[Tuple[Optional[tuple], List[_Request]]]:
        """Pop every wave that is ready (full / waited out / forced),
        expiring dead-on-arrival requests first so they never occupy a
        row.  Returns [(wave_key or None, requests)]."""
        expired: List[_Request] = []
        todo: List[Tuple[Optional[tuple], List[_Request]]] = []
        now = time.monotonic()
        with self._cv:
            ncancel = self._purge_cancelled(self._singles)
            for dq in self._groups.values():
                ncancel += self._purge_cancelled(dq)
            self._expire(self._singles, now, expired)
            if self._singles:
                wave = list(self._singles)
                self._singles.clear()
                self._pending -= len(wave)
                self._inflight += 1
                todo.append((None, wave))
            for key in list(self._groups):
                dq = self._groups[key]
                self._expire(dq, now, expired)
                while dq and (force or len(dq) >= self.policy.max_wave
                              or now - dq[0].t_submit
                              >= self.policy.max_wait_s):
                    wave = [dq.popleft() for _ in
                            range(min(len(dq), self.policy.max_wave))]
                    self._pending -= len(wave)
                    self._inflight += 1
                    todo.append((key, wave))
                if not dq:
                    del self._groups[key]
            self._stats["expired"] += len(expired)
            for r in expired:
                r.settled = True
            if expired or ncancel:
                self._cv.notify_all()
        for r in expired:
            if _claim(r.future):
                r.future.set_exception(DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{now - r.t_submit:.3f}s in queue "
                    f"({r.spec.algo} on {r.name!r})"))
        return todo

    def _purge_cancelled(self, dq: "collections.deque[_Request]") -> int:
        """Drop requests whose ``Future.cancel()`` landed before the wave
        closed, so a cancelled request never occupies a wave row (caller
        holds ``_cv``).  Cancelled futures are already resolved —
        ``cancel()`` did that — so they only need forgetting here."""
        live = [r for r in dq if not r.future.cancelled()]
        gone = len(dq) - len(live)
        if gone:
            self._pending -= gone
            self._stats["cancelled"] += gone
            dq.clear()
            dq.extend(live)
        return gone

    def _expire(self, dq: "collections.deque[_Request]", now: float,
                out: List[_Request]) -> None:
        """Move dead requests out of a queue (caller holds ``_cv``)."""
        live = [r for r in dq
                if r.t_deadline is None or r.t_deadline > now]
        if len(live) != len(dq):
            out += [r for r in dq
                    if r.t_deadline is not None and r.t_deadline <= now]
            self._pending -= len(dq) - len(live)
            dq.clear()
            dq.extend(live)

    # -- dispatch (per-wave worker threads) ------------------------------

    def _register_wave(self, key: Optional[tuple],
                       wave: List[_Request]) -> _Inflight:
        """Record one closed wave as in-flight (``_close_waves`` already
        counted it) so the watchdog can see it."""
        ent = _Inflight(key, wave, self._wave_deadline(key, wave))
        with self._cv:
            wid = self._next_wave_id
            self._next_wave_id += 1
            self._entries[wid] = ent
            ent.wid = wid
        return ent

    def _wave_deadline(self, key: Optional[tuple],
                       wave: List[_Request]) -> Optional[float]:
        ws = self.policy.watchdog_s
        if ws is None:
            return None
        if key is not None:
            name, algo, pol = key
            try:
                cost = self.service.wave_cost(name, algo, pol,
                                              rows=len(wave))
            except Exception:   # evicted graph etc. — use the base
                cost = WATCHDOG_COST_REF
            scale = max(1.0, cost / WATCHDOG_COST_REF)
        else:
            scale = max(1.0, float(len(wave)))
        return time.monotonic() + ws * scale

    def _dispatch(self, ent: _Inflight) -> None:
        try:
            self._slots.acquire()
            with self._cv:
                ent.slot_acquired = True
                reaped = ent.abandoned
            if not reaped:
                self._execute_wave(ent)
        finally:
            self._release_slot(ent)
            with self._cv:
                self._entries.pop(ent.wid, None)
                if not ent.abandoned:
                    # a reaped wave was already discounted by its reaper
                    self._inflight -= 1
                self._cv.notify_all()

    def _execute_wave(self, ent: _Inflight) -> None:
        key, wave = ent.key, ent.wave
        live = [r for r in wave if _claim(r.future)]
        if not live:
            return
        try:
            resilience.fire("sched.dispatch",
                            name=key[0] if key else None,
                            algo=key[1] if key else None,
                            size=len(live))
        except Exception as e:
            for r in live:
                if self._take(ent, r):
                    self._resolve_failure(r, e)
            self._note_wave(len(live))
            return
        with self._cv:
            if ent.abandoned:
                # the watchdog reaped this dispatch while it hung: its
                # requests were retried or failed, so the card does not
                # run a wave nobody will read (the JAX package ran it)
                return
        if key is None:
            # non-coalescible requests: individual runs, one result
            # or exception each — a wave of width 1 apiece
            for r in live:
                try:
                    res = self.service.run(r.name, r.spec)
                except Exception as e:
                    if self._take(ent, r):
                        self._resolve_failure(r, e)
                else:
                    if self._take(ent, r):
                        self._ok(r, res)
                self._note_wave(1)
            return
        name, algo, pol = key
        pend = [_Pending(r.ticket, r.name, r.spec) for r in live]
        try:
            out = self.service._run_wave(name, algo, pol, pend)
        except Exception as e:   # defensive: _run_wave maps per-ticket
            out = {r.ticket: e for r in live}
        for r in live:
            res = out[r.ticket]
            if not self._take(ent, r):
                continue
            if isinstance(res, Exception):
                self._resolve_failure(r, res)
            else:
                self._ok(r, res)
        self._note_wave(len(live))

    def _take(self, ent: _Inflight, req: _Request) -> bool:
        """Dispatcher-side claim of one request's resolution; loses to
        a watchdog that already reaped the wave."""
        with self._cv:
            if ent.abandoned or req.settled:
                return False
            req.settled = True
            return True

    def _release_slot(self, ent: _Inflight) -> None:
        with self._cv:
            if not ent.slot_acquired or ent.slot_released:
                return
            ent.slot_released = True
        self._slots.release()

    # -- watchdog --------------------------------------------------------

    def _reap_overdue(self) -> None:
        """Abandon in-flight waves past their deadline: the dispatcher
        loses resolution rights, its slot is freed, and each request is
        retried (``WaveTimeout`` is transient) or failed."""
        now = time.monotonic()
        doomed: List[Tuple[_Inflight, List[_Request], float]] = []
        with self._cv:
            for wid in list(self._entries):
                ent = self._entries[wid]
                if ent.deadline is None or ent.abandoned \
                        or now < ent.deadline:
                    continue
                ent.abandoned = True
                victims = [r for r in ent.wave if not r.settled]
                for r in victims:
                    r.settled = True
                del self._entries[wid]
                self._inflight -= 1
                self._stats["watchdog_timeouts"] += 1
                doomed.append((ent, victims, now))
            if doomed:
                self._cv.notify_all()
        for ent, victims, t in doomed:
            self._release_slot(ent)
            for r in victims:
                self._resolve_failure(r, WaveTimeout(
                    f"wave watchdog reaped dispatch after "
                    f"{t - r.t_submit:.3f}s "
                    f"({r.spec.algo} on {r.name!r}, "
                    f"attempt {r.attempt + 1})"))

    # -- retry / failure resolution --------------------------------------

    def _resolve_failure(self, req: _Request, exc: Exception) -> None:
        """Settle one failed request: schedule a backoff retry when the
        error is transient and budget remains, else fail the future."""
        transient = resilience.is_transient(exc)
        with self._cv:
            stopped = self._stopped
        if transient and req.attempt < self.policy.max_retries \
                and not stopped:
            req.attempt += 1
            p = self.policy
            delay = min(p.backoff_cap_s,
                        p.backoff_base_s * (2 ** (req.attempt - 1)))
            with self._cv:
                delay *= 1.0 + p.backoff_jitter * self._rng.random()
                timer = threading.Timer(delay, self._requeue,
                                        args=(req,))
                timer.daemon = True
                self._stats["retries"] += 1
                self._backoff += 1
                self._timers[id(req)] = (timer, req)
            timer.start()
            return
        if transient and req.attempt >= self.policy.max_retries:
            with self._cv:
                self._stats["retry_exhausted"] += 1
        elif transient and stopped:
            closed = ServerClosed(
                f"scheduler stopped before retrying "
                f"{type(exc).__name__}: {exc}", self.stats())
            closed.__cause__ = exc
            exc = closed
        self._fail(req, exc)

    def _requeue(self, req: _Request) -> None:
        """Timer callback: put a backed-off request back in the queue
        (or fail it if the scheduler stopped while it was parked)."""
        with self._cv:
            if self._timers.pop(id(req), None) is None:
                return   # stop() claimed this retry
            self._backoff -= 1
            stopped = self._stopped
            if not stopped:
                self._enqueue_locked(req)
            self._cv.notify_all()
        if stopped:
            self._fail(req, ServerClosed(
                "scheduler stopped during retry backoff", self.stats()))

    def _ok(self, req: _Request, res) -> None:
        try:
            req.future.set_result(res)
        except Exception:    # lost a cancel race; nothing to report
            return
        self._count(ok=1)

    def _fail(self, req: _Request, exc: Exception) -> None:
        try:
            req.future.set_exception(exc)
        except Exception:    # lost a cancel race; nothing to report
            return
        self._count(bad=1)

    def _count(self, ok: int = 0, bad: int = 0) -> None:
        with self._cv:
            self._stats["completed"] += ok
            self._stats["failed"] += bad

    def _note_wave(self, size: int) -> None:
        with self._cv:
            self._stats["waves"] += 1
            self._stats["wave_queries"] += size
            self._stats["coalesced_waves"] += 1 if size > 1 else 0
            self._stats["max_wave"] = max(self._stats["max_wave"], size)

    # -- introspection ---------------------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._cv:
            s = dict(self._stats, pending=self._pending,
                     inflight=self._inflight,
                     retry_backlog=self._backoff)
        s["achieved_wave"] = (s["wave_queries"] / s["waves"]
                              if s["waves"] else 0.0)
        return s


def _claim(fut: Future) -> bool:
    """Move a future to RUNNING if possible.  A retried request's
    future is already RUNNING from its first dispatch — still ours to
    resolve (RUNNING futures can't be cancelled, and only the scheduler
    finishes them), without tripping the stdlib's unexpected-state
    alarm in ``set_running_or_notify_cancel``."""
    if fut.running():
        return True
    try:
        return fut.set_running_or_notify_cancel()
    except RuntimeError:    # lost a state race anyway
        return not fut.done()
