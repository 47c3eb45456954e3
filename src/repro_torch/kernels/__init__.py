# Hand-written CUDA kernels for the graph engine's hot loop:
#   csrc/bsr_spmv.cu — block-sparse semiring SpMV + the fused
#                      frontier-masked sweep (sm_90a)
#   bsr_spmv.py      — build at first use, ctypes binding, checked
#                      wrappers, launch counters
#   ops.py           — select_kernel registry (device-keyed dispatch)
#   ref.py           — the plain torch versions
#   spec.py          — KernelSpec
