"""Public session API — ``repro_torch.api``.

    from repro_torch import api
    proc = api.GraphProcessor(g, b=16, num_clusters=64)   # on cuda
    pr = proc.pagerank()
    d = proc.sssp(sources=[0, 5, 9])          # batched: one query axis
    fast = api.ExecutionPolicy(mode="async", kernel=api.KernelSpec(
        impl="pallas", fuse_frontier=True))
    d2 = proc.sssp(0, policy=fast)

The serving layer (``GraphService``, ``GraphServer``, ``PlanStore``) and
the distributed engines are not ported yet (ROADMAP queue 1).
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

__all__ = ["AlgorithmSpec", "ExecutionPolicy", "GraphProcessor",
           "KernelSpec", "PlanKey", "QuerySpec", "Result", "Prepared",
           "RunStats", "serialize_prepared", "deserialize_prepared",
           "prepared_from_numpy", "PlanIntegrityError", "degrade_policy",
           "FaultPlan", "FaultSpec", "FaultInjected", "inject",
           "is_transient", "get_algorithm", "register_algorithm",
           "registered_algorithms"]
