"""repro_torch — the asynchronous graph-processor engine and LM serving
in PyTorch, with their kernels hand-written in CUDA for Hopper (sm_90a):
the block-sparse SpMV, flash attention and the RWKV-6 WKV recurrence.

A second package beside the JAX package ``repro``, which stays the
reference: module names mirror it (``core/graph.py`` ↔ ``core/graph.py``
and so on), and the tests hold every module against it on the same
inputs.  Entry points run on ``cuda`` unless the caller passes
``device=``; importing the package touches no device.
"""
