# The paper's graph engine in PyTorch:
#   graph/cluster  — Fig.4 compile-time steps 1–4 (host numpy)
#   semiring       — the NALE MAC/comparator datapath algebra (torch ops)
#   engine         — sync (BSP) vs async (cluster-dataflow, Gauss-Seidel)
#   algorithms     — the AlgorithmSpec registry
#   api            — GraphProcessor session, ExecutionPolicy, QuerySpec
#   isa/compile    — the specialized ISA + step-5 codegen
#   power          — cycle & energy models for NALE / CPU / GPU classes
#   oracles        — numpy reference implementations

from . import algorithms, api, cluster, compile, engine, graph, isa, \
    oracles, power, semiring  # noqa: F401
