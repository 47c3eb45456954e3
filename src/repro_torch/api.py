"""Public session + serving API — ``repro_torch.api``.

    from repro_torch import api
    proc = api.GraphProcessor(g, b=16, num_clusters=64)   # on cuda
    pr = proc.pagerank()
    d = proc.sssp(sources=[0, 5, 9])          # batched: one query axis
    fast = api.ExecutionPolicy(mode="async", kernel=api.KernelSpec(
        impl="pallas", fuse_frontier=True))
    d2 = proc.sssp(0, policy=fast)

Serving many graphs (``serve/graph.py``): a ``GraphService`` holds a
named graph registry, a shared byte-bounded LRU plan store on the card
with an on-disk tier (warm restarts skip the compile pipeline), and a
``submit``/``gather`` front door that coalesces same-plan single-source
queries into batched runs:

    svc = api.GraphService(cache_dir=".plan-cache")       # on cuda
    svc.register("roads", g, b=16, num_clusters=64)
    t = svc.submit("roads", api.QuerySpec(algo="sssp", sources=(0,)))
    dist = svc.gather()[t].values

Serving many clients (``serve/server.py``): a ``GraphServer`` accepts
concurrent ``submit(...) → Future`` requests; a background wave
scheduler closes batched waves across clients (continuous batching),
with deadlines, ``Backpressure`` admission control and plan warming
from the store's access log:

    server = api.GraphServer(cache_dir=".plan-cache")
    server.register("roads", g, b=16, num_clusters=64)
    fut = server.submit("roads", api.QuerySpec(algo="sssp", sources=(0,)),
                        deadline=0.5)
    dist = fut.result().values

Every entry point runs on ``cuda`` unless ``device=`` names another
device.  ``ExecutionPolicy(mode="distributed")`` runs the engines over a
(graph, query) mesh of devices (``core/placement.py``,
``core/async_dist.py``): every card, or one slot on the session's
device.  ``KernelSpec(impl="pallas", autotune=True)`` measures the SpMV
kernels' launch knobs on each plan once (``kernels/autotune.py``) and
keeps the record beside the plan, in the store's sidecar when there is
one.
"""

from .core.algorithms import (AlgorithmSpec, get_algorithm,  # noqa: F401
                              register_algorithm,
                              registered_algorithms)
from .core.api import (ExecutionPolicy, GraphProcessor, PlanKey,  # noqa: F401
                       QuerySpec, Result, degrade_policy)
from .core.engine import (PlanIntegrityError, Prepared,  # noqa: F401
                          RunStats, deserialize_prepared,
                          prepared_from_numpy, serialize_prepared)
from .kernels.spec import KernelSpec  # noqa: F401
from .resilience import (FaultInjected, FaultPlan, FaultSpec,  # noqa: F401
                         inject, is_transient)
from .serve.graph import GraphService, PlanStore  # noqa: F401
from .serve.sched import (Backpressure, DeadlineExceeded,  # noqa: F401
                          ServerClosed, WavePolicy, WaveScheduler,
                          WaveTimeout)
from .serve.server import GraphServer  # noqa: F401

__all__ = ["AlgorithmSpec", "ExecutionPolicy", "GraphProcessor",
           "GraphService", "KernelSpec", "PlanKey", "PlanStore",
           "QuerySpec", "Result", "Prepared", "RunStats",
           "serialize_prepared", "deserialize_prepared",
           "prepared_from_numpy", "GraphServer", "WaveScheduler",
           "WavePolicy", "DeadlineExceeded", "Backpressure",
           "ServerClosed", "WaveTimeout", "PlanIntegrityError",
           "degrade_policy", "FaultPlan", "FaultSpec", "FaultInjected",
           "inject", "is_transient", "get_algorithm", "register_algorithm",
           "registered_algorithms"]
