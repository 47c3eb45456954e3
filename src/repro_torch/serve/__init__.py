"""Serving on the port.

Graph serving (``serve/graph.py``, ``sched.py``, ``server.py``): the
plan store, ``GraphService``, the wave scheduler and ``GraphServer``
over the port's engines.  LM serving (``serve/engine.py``): ``generate``
(static batch) and ``ServeLoop`` (continuous batching), loaded lazily.
"""

from .graph import GraphService, PlanStore  # noqa: F401
from .sched import (Backpressure, DeadlineExceeded,  # noqa: F401
                    ServerClosed, WavePolicy, WaveScheduler,
                    WaveTimeout)
from .server import GraphServer  # noqa: F401

__all__ = ["ServeLoop", "generate", "GraphService", "PlanStore",
           "GraphServer", "WaveScheduler", "WavePolicy",
           "DeadlineExceeded", "Backpressure", "ServerClosed",
           "WaveTimeout"]


def __getattr__(name):
    # the LM serving loop pulls in the whole model/config stack; load it
    # lazily so graph-only users of repro_torch.api don't pay for it
    if name in ("ServeLoop", "generate"):
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
