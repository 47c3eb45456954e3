"""GraphServer — the network front door over ``GraphService``.

The JAX package's ``serve/server.py`` with its imports pointed at this
package.  A server builds its service on ``cuda`` unless ``device=``
(one of the ``GraphService`` keyword arguments) names another device.

``GraphService.submit/gather`` batches only what one caller queued
before its own barrier; ``GraphServer`` makes batching happen *across*
concurrent clients, which is what "millions of users" actually send:

  * ``submit(name, spec, deadline=None) → Future`` from any number of
    threads; a background ``WaveScheduler`` closes batched waves on a
    max-wait / max-batch policy (continuous batching) and dispatches
    them through the batched sync/async engines — off the
    caller's thread, results bit-identical to direct
    ``GraphService.run``.
  * request deadlines — an expired request resolves to
    ``DeadlineExceeded`` instead of occupying a wave row;
  * admission control — submits are refused with ``Backpressure`` (and
    a stats payload) while the queue is over ``max_pending`` or the
    shared ``PlanStore`` is thrashing;
  * plan warming — ``register()`` consults the access log the store
    persists beside its on-disk plan tier and speculatively prepares
    the graph's hot plans in the background, so a restarted server is
    warm before its first request;
  * self-healing — transient wave failures retry with exponential
    backoff, a watchdog reaps hung dispatches, and ``close`` /
    ``submit`` on a closed server resolve with a structured
    ``ServerClosed`` (see ``serve.sched`` and ``resilience``).

    server = GraphServer(cache_dir="~/.cache/repro-plans")
    server.register("roads", g, b=16, num_clusters=64)
    fut = server.submit("roads", QuerySpec(algo="sssp", sources=(0,)),
                        deadline=0.5)
    dist = fut.result().values           # waves close in the background
    server.close()
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import List, Optional

from ..core.api import QuerySpec, Result
from ..core.graph import Graph
from .graph import GraphService
from .sched import (Backpressure, ServerClosed, WavePolicy,
                    WaveScheduler, _Request)


class GraphServer:
    """Concurrent-client front end: futures in, batched waves out.

    Wraps an existing ``GraphService`` (pass ``service=``) or builds its
    own (remaining keyword arguments go to ``GraphService``).  The wave
    scheduler's knobs live in one ``WavePolicy``; ``autostart=False``
    leaves the scheduler paused — submits then just accumulate until
    ``start()``, which is also how tests and benchmarks get
    deterministic wave shapes.
    """

    def __init__(self, service: Optional[GraphService] = None, *,
                 wave: Optional[WavePolicy] = None,
                 warm_limit: int = 4, autostart: bool = True,
                 **service_kw):
        if service is not None and service_kw:
            raise ValueError(
                "pass either a service= or GraphService kwargs "
                f"({sorted(service_kw)}), not both")
        self.service = service or GraphService(**service_kw)
        self.wave = wave or WavePolicy(max_wave=self.service.max_wave)
        self.warm_limit = int(warm_limit)
        self.sched = WaveScheduler(self.service, self.wave)
        self._lock = threading.Lock()
        self._next_ticket = 0
        self._closed = False
        self._rejected_pending = 0
        self._rejected_thrash = 0
        self._plans_warmed = 0
        self._warm_failed = 0
        self._warm_futures: List[Future] = []
        self._warm_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-torch-warm")
        # (monotonic, evictions) samples for the thrash detector
        self._evict_samples: "collections.deque[tuple]" = \
            collections.deque()
        if autostart:
            self.start()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self.sched.start()

    def close(self, drain: bool = True) -> None:
        """Stop serving.  ``drain=True`` completes every queued request
        first; the plan access log is flushed so the next process can
        warm what this one found hot."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.sched.stop(drain=drain)
        self._warm_pool.shutdown(wait=True)
        self.service.store.flush_access_log()

    def __enter__(self) -> "GraphServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- registry (delegates + plan warming) -----------------------------

    def register(self, name: str, g: Graph, warm: Optional[bool] = None,
                 **kw):
        """``GraphService.register`` plus background plan warming: the
        store's persisted access log names this graph's hot plans; each
        (up to ``warm_limit``, hottest first) is prepared off-thread —
        from the disk tier when present, rebuilt when not — so the
        first real request finds its plan resident.  ``warm=False``
        opts a registration out; ``wait_warm()`` joins the work."""
        proc = self.service.register(name, g, **kw)
        if warm is None:
            warm = self.warm_limit > 0
        if not warm:
            return proc
        # only keys this registration's session parameters can rebuild
        hot = [k for k in
               self.service.store.hot_keys(g.fingerprint())
               if (k.b, k.num_clusters, k.clustered, k.seed)
               == (proc.b, proc.num_clusters, proc.clustered,
                   proc.seed)]
        for key in hot[:self.warm_limit]:
            self._warm_futures.append(self._warm_pool.submit(
                self._warm_one, proc, key))
        return proc

    def _warm_one(self, proc, key) -> None:
        try:
            proc.prepare(key.semiring, variant=key.variant,
                         pull=key.pull, normalize=key.normalize)
            with self._lock:
                self._plans_warmed += 1
        except Exception:
            # warming is speculative: a failure costs nothing but the
            # head start (the plan will build on first demand instead)
            with self._lock:
                self._warm_failed += 1

    def wait_warm(self, timeout: Optional[float] = None) -> bool:
        """Block until background warming settles; True if it all did."""
        end = None if timeout is None else time.monotonic() + timeout
        for f in list(self._warm_futures):
            left = None if end is None else max(end - time.monotonic(),
                                                0.0)
            try:
                # on py3.10 futures raise their own TimeoutError class
                f.exception(timeout=left)
            except (TimeoutError, _FutureTimeout):
                return False
        return True

    def evict(self, name: str) -> None:
        """Drop a graph AND resolve its queued requests to KeyError."""
        self.service.evict(name)
        self.sched.evict(name)

    # -- admission + submit ----------------------------------------------

    def _thrashing(self) -> bool:
        """True while the shared PlanStore evicted ≥ ``thrash_evictions``
        plans inside the trailing ``thrash_window_s``: the working set
        no longer fits, so admitting more load just converts every
        query into a compile-pipeline run."""
        pol = self.wave
        if pol.thrash_evictions <= 0:
            return False
        now = time.monotonic()
        ev = self.service.store.stats()["evictions"]
        with self._lock:
            self._evict_samples.append((now, ev))
            horizon = now - pol.thrash_window_s
            while (len(self._evict_samples) > 1
                   and self._evict_samples[0][0] < horizon):
                self._evict_samples.popleft()
            delta = ev - self._evict_samples[0][1]
        return delta >= pol.thrash_evictions

    def submit(self, name: str, spec: QuerySpec,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one query; returns a ``concurrent.futures.Future``.

        ``deadline`` is a per-request latency budget in seconds: if no
        wave has served the request by then it resolves to
        ``DeadlineExceeded`` (never occupying a wave row past its use).
        Raises ``KeyError``/``ValueError`` for bad requests and
        ``Backpressure`` when admission control refuses new load.
        """
        if self._closed:
            raise ServerClosed("GraphServer is closed")
        queued = self.sched.pending()
        if queued >= self.wave.max_pending:
            with self._lock:
                self._rejected_pending += 1
            raise Backpressure(
                f"pending queue is full ({queued} >= "
                f"{self.wave.max_pending})", self.stats())
        if self._thrashing():
            with self._lock:
                self._rejected_thrash += 1
            raise Backpressure(
                "plan store is thrashing "
                f"(>= {self.wave.thrash_evictions} evictions in "
                f"{self.wave.thrash_window_s}s)", self.stats())
        key = self.service.wave_key(name, spec)  # validates, fail-fast
        now = time.monotonic()
        fut: Future = Future()
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
        self.sched.offer(_Request(
            ticket=ticket, name=name, spec=spec, key=key, future=fut,
            t_submit=now,
            t_deadline=None if deadline is None else now + deadline))
        return fut

    def run(self, name: str, spec: QuerySpec,
            deadline: Optional[float] = None) -> Result:
        """Blocking convenience: ``submit`` + ``result()``."""
        return self.submit(name, spec, deadline=deadline).result()

    def submit_async(self, name: str, spec: QuerySpec,
                     deadline: Optional[float] = None):
        """Asyncio adapter: returns an awaitable for the same request
        (``await server.submit_async(...)`` from a coroutine).  The
        wave scheduler stays thread-based; only the completion hop is
        bridged onto the running event loop."""
        import asyncio
        return asyncio.wrap_future(
            self.submit(name, spec, deadline=deadline))

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            s = dict(rejected_pending=self._rejected_pending,
                     rejected_thrash=self._rejected_thrash,
                     plans_warmed=self._plans_warmed,
                     warm_failed=self._warm_failed)
        return {"server": s, "scheduler": self.sched.stats(),
                "service": self.service.stats()}
