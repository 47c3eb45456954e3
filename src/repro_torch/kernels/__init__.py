# Hand-written CUDA kernels (sm_90a), one library per source:
#   csrc/bsr_spmv.cu        — block-sparse semiring SpMV + the fused
#                             frontier-masked sweep (graph engine) over the
#                             ELL tile image: the ELL route
#   csrc/bsr_spmv_compact.cu
#                           — the same two over the filled tile entries
#                             only (bsr_spmv.build_compact_index): the
#                             compacted route, which the engines take
#   csrc/flash_attention.cu — causal/windowed flash attention (LM prefill)
#                             on the CUDA cores: f32, and bf16 at D other
#                             than 64, 128, 192, 256
#   csrc/flash_attention_sm90.cu
#                           — the same on the tensor cores (wgmma + TMA):
#                             bf16 at D 64, 128, 192 and 256
#   csrc/wkv6.cu            — the RWKV-6 WKV recurrence (prefill, decode)
#   csrc/wkv6_chunked.cu    — the same in chunks on the tensor cores (bf16
#                             prefill at head size 64)
#   csrc/wkv6_backward.cu   — the WKV recurrence's gradient (training)
#   csrc/rg_lru.cu          — the RG-LRU scan and its gradient (training)
#   bsr_spmv.py, flash_attention.py, wkv6.py, rg_lru.py
#                           — build at first use, ctypes binding, checked
#                             wrappers, launch counters
#   autotune.py             — measured tuning of the compacted kernels'
#                             launch knobs (KernelSpec(autotune=True))
#   cuda_lib.py             — nvcc build + ctypes helper, device rule
#   ops.py                  — select_kernel registry, attention(), wkv6(),
#                             wkv6_train(), rg_lru_scan() (device-keyed)
#   ref.py                  — the plain torch versions
#   spec.py                 — KernelSpec
