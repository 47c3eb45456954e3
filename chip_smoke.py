#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU: the graph engine's main
path, LM serving (granite-3-2b at full width), RWKV-6 serving
(rwkv6-1.6b at full width and depth), Griffin serving
(recurrentgemma-9b at full width and depth), MoE serving (dbrx-132b at
full width, 8 of its 40 layers), MLA serving (minicpm3-4b at full width
and depth), vision serving (llama-3.2-vision-11b at full width and
depth), audio serving (whisper-tiny at full width and depth) and
training (granite-3-2b and rwkv6-1.6b at full width and depth,
recurrentgemma-9b at full width), every hand-written kernel against its
plain version.

    python3 chip_smoke.py            # everything (about 13 minutes)

Phases, in order; any mismatch raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off for matmuls and cuDNN;
  2. build the eight CUDA libraries from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, started together; sm_90a) and print the build
     time, each library's own seconds and ptxas's register report (the
     compacted SpMV library's registers and spills as a line of their
     own, by kernel and launch bound); the two tensor-core
     libraries must show 0 spill bytes, no "wgmma ... serialized" warning
     and tensor-core instructions in their SASS (``cuobjdump -sass``):
     HGMMA for attention, whose instances DP 64, 128, 192 and 256 must
     each be in ptxas's log with their registers, HMMA for the chunked
     WKV6; the CUDA-core flash
     library's registers and spill bytes by dtype and padded head dim
     (32 to 256); the training scans' registers and spill bytes
     (``build_scan_kernels``);
  3. each SpMV kernel of both routes against its plain torch version on
     the card: the CA stand-in at scale 0.02 for the 4 semirings × B ∈
     {16, 32}, the fused kernels over 5 update rules × {empty, sparse,
     dense} frontiers at Q = 1 and 4, garbage beyond nnz.  The ELL route
     (``csrc/bsr_spmv.cu``) within 2e-6 relative for plus_times and the
     PageRank rules, bit for bit otherwise; the compacted route
     (``csrc/bsr_spmv_compact.cu``) bit for bit against its plain version
     and against the ELL kernel, every ring and rule;
  4. the main path at full width: ``GraphProcessor`` on the full-scale
     CA stand-in (n = 1,962,801) at b=16, 64 clusters, with every query
     checked against the numpy oracles and ``degrade=False``; each plan's
     compacted index is built at ``prepare`` (its seconds and MB
     printed); before the queries, all four kernels against the plain
     versions on a 4096-row-block slice of each full-scale plan with the
     full x (the compacted route over the plan index's ``rows`` view);
     the compacted kernels must launch on the main path and the ELL ones
     not at all; every query reads the host once a sweep and launches
     its route's kernel once a sweep (sync) or 64 times a sweep (async:
     sweep 0 eager, the later sweeps one replayed CUDA graph, whose
     capture seconds each query prints), or the script fails; the device
     idle share of sssp sync fused and of sssp async fused stopped after
     ``ASYNC_PROFILE_SWEEPS`` sweeps (profiled after two warm-up
     queries); then sssp and pagerank on the power-law
     stand-in ``fb`` at scale 0.005, b=32, all four kernels against their
     plain versions on its plans (hub rows of up to 2,148 entries), and
     both routes' times there;
  5. times at the full-scale CA plans, both routes: each kernel's call
     (CUDA events, median) and device time (profiler), its plain version,
     the bound from the filled entries (bytes / 3.35 TB/s) and from the
     ELL image, the fused kernels over a dense and a sparse frontier,
     and, for plus_times, ``torch.sparse_csr_tensor`` @ x (call and
     device time) as a yardstick; then phase ``autotune``
     (``autotune_phase``): every launch knob of the compacted kernels
     (warps a block 2, 4, 8, 16 × rows a thread 1, 2, 4; fused: the warps)
     bit for bit against the plain versions on the scale-0.02 CA plans
     (four rings, b 16 and 32) and the Facebook stand-in's (hub rows),
     ``KernelSpec(autotune=True)`` measured by the session on the
     full-scale min_plus plans (each candidate's time, the winner, the
     tuner's seconds; every candidate at or above the modelled bound, the
     model within 1 % of the filled entries' bytes / 3.35 TB/s, each
     candidate's block of 32 × warps threads read from the profiler's
     trace, the winner's device time at most 1.05x the default knobs',
     the winner bit for bit at Q 64), then sssp sync (unfused and fused),
     sssp async fused and bfs async fused from 4 sources on the tuned
     knobs, each equal to its untuned run in values and every counter
     and held to the oracles, and a tuning read back by a restarted
     ``GraphService`` (alone: ``python3 -c 'import chip_smoke as c;
     c.setup(); c.autotune_alone()'``); the paper's ISA compiler on the
     full-scale min_plus plan (seconds, instructions) and the paper's
     analytic NALE/CPU/GPU models (``core/power.py``: modelled platforms,
     not the H100) for sssp async fused with sssp sync fused's stats; the
     runners minitri (on the card), tricount and dfs(0) (on the host) on
     the full-scale CA graph and on ``fb``, held to the oracles (the
     triangle counts through the dense oracles' formulas as sparse
     products, themselves held to the dense oracles at n ≈ 900); the
     distributed engines (phase ``distributed``, ``distributed_phase``):
     sssp and bfs from 4 sources on the full-scale plans at the meshes
     (devices, query axis) (1, 1), (4, 2), (8, 1), (8, 8), every slot on
     the one card, bulk-synchronous and self-timed at k 2 and 4, then
     pagerank_delta self-timed at (4, 2) k 2: values bit-equal to
     ``run_sync_batched`` (pagerank_delta within 2·tol/(1-d) of
     ``run_sync``), the sync flavor's per-query sweeps equal to
     ``run_sync``'s, fewer exchanges for the self-timed one, one host
     read a round, launches exact (a sweep a slot; k + 1 a slot a round),
     each run's wall, exchanges and per-shard sweeps, the exchange alone
     against its bound, device ms a round at (4, 2) split into SpMV,
     copies and the rest; one session query on the default mesh with its
     ``RunStats`` from the ``DistStats``, a ``dist.dispatch`` fault down
     the ladder to sync, and one 64-wide ``GraphServer`` wave served by
     one distributed run; then the
     compacted kernels at a full serving wave's width, Q 64 (phase
     ``time_q64``: call, device time, plain version, bound and, for
     plus_times, ``torch.sparse.mm``); then the serving layer
     (``graph_serving``): the main path's plans handed to a
     ``GraphService`` store, 8 client threads sending 256 sssp, 64 bfs,
     one pagerank and one cc into a ``GraphServer`` (waves of up to 64,
     5 ms wait, one worker), then the 256 sssp under a sync fused
     policy: requests/s, p50/p99 latency, wave widths, one 64-wide async
     wave's wall, sweeps, capture seconds and idle share, peak device
     memory; every wave one host read a sweep and its route's launches
     (sweeps × 64 async), sampled results bit-equal to direct runs, one
     sssp and one bfs against the oracles (each oracle computed once per
     graph and source for the whole script), a transient dispatch fault
     retried to the same values, one wave's capture held open while
     another thread uploads a plan (``register(warm=True)``) and a third
     runs a sync query, the disk tier (the min_plus plan written and
     reloaded, ``prepare_calls == 0``) and an eviction that must free the
     loaded plan's device bytes; then the graph plans are freed;
  6. flash attention against its plain version (mha_ref; mha_chunked for
     the long case), each case on the kernel ``flash_attention.route``
     gives it (bf16 at D 64, 128, 192 and 256: tensor cores; f32 and bf16
     at other head dims: CUDA cores): the granite prefill shape (B 4, H
     32, Hkv 8, S 1024, D 64, causal) in bf16 and f32, ragged non-causal
     S = 100,
     windows, D = 128, GQA group 32, the model's (B, S, H, D) memory,
     D = 32, recurrentgemma-9b's prefill (B 4, H 16, Hkv 1, S 3072, D
     256, window 2048) in bf16 (also in the model's memory) and in f32 at
     S 1024, a ragged S = 777 full at D 256, nemotron-4-340b's D 192 (H
     96, Hkv 8, S 1024), ragged D 192 cases (windowed; the model's
     memory), whisper-tiny's encoder (B 4, H = Hkv = 6, S 1500, D 64,
     unmasked; also in the model's memory) and decoder self-attention (S
     448, causal), llama-3.2-vision-11b's prefill (B 4, H 32, Hkv 8, S
     1024, D 128, causal), and B 1 x H 32 x S 16384 causal (with its
     device time beside SDPA's); each case within an elementwise and a
     relative-L2 limit, and a planted fault (one key tile dropped) must
     break both at D 64, D 128, recurrentgemma's D 256 and its f32 case,
     whisper's encoder and vision's prefill;
  7. LM serving: granite-3-2b (40 layers, d_model 2048, 2.53 B
     parameters, random weights from seed 0, bf16) through ``generate``
     (4 prompts x 1024 tokens, 32 new) and ``ServeLoop`` (4 slots, 8 such
     requests); the first wave's tokens equal the static batch's, and
     ``launch_counts["flash_attention"]`` and its tensor-core count are
     40 x the prefills; one
     wave's prefill logits against the same model with mha_ref, beside
     the distance a dropped key tile in every layer gives; prefill
     tokens/s, time to first token, decode ms/step and tokens/s, the
     device idle share over decode steps and over a prefill (each
     profiled window after an unrecorded warm-up pass);
  8. flash attention's times at the granite prefill shape and a
     chatglm3-like one (Hkv 2, D 128) in bf16, and at granite's in f32:
     the call (CUDA events) and the device time (profiler), the bound
     (operations at the bf16 tensor-core peak), the plain version's time
     and ``scaled_dot_product_attention``'s call and device times as the
     yardstick; then granite's weights are freed;
  9. the recurrent WKV6 kernel against its plain version: the four
     shapes of tests/test_wkv6_kernel.py, the rwkv6-1.6b prefill shape
     (B 4, T 1024, H 32, hs 64) in bf16 (through the module's launcher,
     since the route sends it to the chunked kernel) and f32 with
     per-head u and a nonzero state, and a decode step in place; y and
     the final state each within an elementwise and a relative-L2 limit,
     and two planted faults (u dropped; the last step's decay skipped)
     must break them; then the chunked kernel against both plain
     versions, the chunked one (y within one bf16 step, the state within
     1e-5 relative L2) and the recurrent one (the bf16 limits, y and the
     state), at the prefill shape, extreme decays with zeros, T 777, T
     128, strided slices, and a decode step after it in place; three
     planted faults (u dropped, the last decay skipped, the diagonal
     blocks decayed one step too far) must fail, and two calls must give
     the same bits;
 10. RWKV-6 serving: rwkv6-1.6b (24 layers, d_model 2048, 32 heads of
     64, 1.60 B parameters, random from seed 0 with the constant leaves
     drawn around their init values, bf16) through the same traffic as
     granite; ``launch_counts["wkv6"]`` is 24 x (prefills + decode steps),
     ``["wkv6_chunked"]`` 24 x prefills and ``["wkv6_recurrent"]`` 24 x
     decode steps;
     the first wave's tokens equal the static batch's; one wave's prefill
     logits against the same model with the plain WKV6, with the weights
     upcast to f32 (the gate, 1e-4) and in bf16, beside a dropped u in
     every layer; the serving metrics as for granite;
 11. both WKV6 kernels' times at the prefill shape and the recurrent
     one's at a decode step, each beside its bound (bytes, or operations
     at the peak of its units: the f32 CUDA cores, the bf16 tensor cores)
     and its plain version's time (no library call computes WKV6);
 12. Griffin serving, after rwkv6's weights are freed: recurrentgemma-9b
     (38 layers: 12 x (recurrent, recurrent, local_attn) + 2 recurrent;
     d_model 4096, 16 heads, 1 kv head of 256, window 2048, lru_dim
     4096; param_count 9,396,297,728; random from seed 3, bf16) through
     ``generate`` (4 prompts x 3072 tokens, 32 new) and ``ServeLoop`` (4
     slots, 8 such requests, cache_len 3200);
     ``launch_counts["flash_attention"]`` and its tensor-core count are 12
     x the prefills (none at decode), the CUDA-core count 0; the first
     wave's tokens equal the static batch's; one wave's prefill logits
     against the same model with mha_ref, bf16 and its f32 upcast (whole
     superblocks cut, and the cut printed, where the upcast does not fit
     beside the model), where a dropped key tile in every local layer
     must fail the f32 gate; the two prefill waves of that check launch
     the flash kernel once a local layer, the bf16 one on the tensor
     cores, the f32 one on the CUDA cores (the f32 route's main path);
     the serving metrics, the device time of a prefill over the first 6
     layers (4 recurrent, 2 local; the timed prefills run all 38) split
     into GEMMs, flash, the RG-LRU time loop (one ``addcmul`` a step: 26
     x 3072 launches a whole prefill) and the rest, peak memory;
 13. the flash kernels' times at recurrentgemma's prefill shape, bf16 on
     the tensor cores and f32 on the CUDA cores, and at nemotron's D 192
     in bf16 (call, device, bound, plain, SDPA with the kernel it ran: a
     boolean window mask for recurrentgemma);
 14. MoE serving, after recurrentgemma's weights are freed: the
     tensor-core flash kernel against its plain version at dbrx-132b's
     prefill shape (B 4, H 48, Hkv 8: GQA group 6, S 1024, D 128, causal,
     bf16; also in the model's memory), a dropped key tile must fail;
     dbrx-132b (d_model 6144, 48 heads, 8 kv heads of 128, 16 experts
     top 4 of d_ff 10752, vocab 100,352) at full width, its first 8 of 40
     layers (param_count 27,305,803,776; 54.6 GB in bf16; random from
     seed 5), through the same traffic as granite (prompts of 1024 =
     ``moe_group_size`` tokens, so each prefill group is one prompt in
     every wave); ``launch_counts["flash_attention"]`` and its tensor-core
     count are 8 x the prefills, the CUDA-core count 0; the first wave's
     tokens equal the static batch's (a flip teacher-forced through
     prefill and decode); one wave's prefill logits against the same model
     with mha_ref in bf16 (5e-2) on the kernel path's routes (the
     router's choices replayed, ``routes_held``), with the free runs'
     distance, the share of (token, layer, choice) routes on which they
     agree and each layer's dropped share beside it; the
     serving metrics, the prefill's device time split into GEMMs, flash,
     the MoE's routing, dispatch and combine and the rest; then, the 8
     layers freed, the first 2 drawn anew from the same seed (their bits
     checked equal) and upcast to f32: the f32 gate (1e-4, every route
     equal, a dropped key tile above it), its wave on the CUDA-core
     kernel, once a layer; the kernel's times at dbrx's shape;
 15. MLA serving: minicpm3-4b (62 layers, d_model 2560, 40 heads, q_lora
     768, kv_lora 256, qk head 64 + 32, v head 64; param_count
     4,261,836,800; 8.5 GB in bf16; random from seed 7) through the same
     traffic; no flash launch on any route (its value head is narrower
     than its key head, so the plain attention runs, as in the
     reference); tokens as above; on its f32 upcast a decode step at
     position 1024 (absorbed latent attention) against a prefill of 1025
     tokens (K and V materialised) within 1e-4 relative L2, with the bf16
     distances beside it; the serving metrics;
 16. vision serving: llama-3.2-vision-11b (40 layers: 8 x (4 attn, 1
     tanh-gated cross_attn); d_model 4096, 32 heads, 8 kv heads of 128,
     d_ff 14336, vocab 128,256; param_count 9,791,930,368; 19.6 GB in
     bf16; random from seed 8, every gate and gate_mlp drawn in [0.5,
     1.5) from the seed, since the init's 0 would hide the cross path),
     each request with its own image stub (1601 x 4096, N(0, 1) from the
     seed), through the LM traffic; ``launch_counts["flash_attention"]``
     and its tensor-core count are 32 x the prefills (the self layers;
     the cross calls, 1024 queries against 1601 image tokens, run the
     plain attention, as in the reference), none at decode; tokens as
     above; the bf16 prefill logits against mha_ref, with the route of
     every attention call, a dropped key tile in every flash call beside
     it; the serving metrics with the prefill's device time split into
     GEMMs, flash, the plain (cross) attention and the rest; then, the
     model freed, its first superblock (4 attn + 1 cross_attn layers)
     drawn anew from the seed (bit sums checked equal), upcast to f32:
     the f32 gate (1e-4, a dropped tile above it), its wave on the
     CUDA-core kernel once a self layer;
 17. audio serving: whisper-tiny (4 decoder layers and a 4-layer
     encoder over 1500 frames, d_model 384, 6 heads of 64, LayerNorm,
     GELU, tied embeddings, learned positions; param_count 49,600,896;
     seed 9, frame stubs from the seed) through the LM traffic at
     448-token prompts, so each prefill's cross calls (448 against 1500)
     run the plain attention and its 4 encoder (unmasked, S 1500) and 4
     self layers the tensor-core kernel: 8 launches a prefill, none at
     decode; tokens; the logit gate in bf16 and on the whole model
     upcast to f32, each with every call's route; the serving metrics;
     then the tensor-core kernel's times at vision's prefill shape (B 4,
     H 32, Hkv 8, S 1024, D 128, causal) and whisper's encoder (B 4, H =
     Hkv = 6, S 1500, D 64, unmasked); ``attention_vs_plain`` (phase 6)
     holds the kernel at both, in the model's memory too, and at
     whisper's decoder self-attention (S 448, causal), with a dropped key
     tile that must fail at both new shapes;
 18. training (``train_phases``, after whisper's weights are freed):
     granite-3-2b through the ported ``train/``, ``data/`` and
     ``ckpt/``.  The tensor-core flash kernel at the training shape (B
     8, H 32, Hkv 8, S 1024, D 64, bf16, the model's memory) through
     ``flash_attention_train`` against the plain attention, its
     gradients equal to the plain attention's autograd (the backward is
     that autograd, recomputed; no backward kernel), a dropped key tile
     failing; gate (a): the first 2 layers at full width in f32, one
     ``make_train_step`` step through the kernel (the CUDA-core route,
     once a layer and once in remat's recompute) against one through the
     plain attention: loss 1e-5, every gradient 1e-4 relative L2 and
     nonzero, the updated masters 1e-4; gate (b): the first step at full
     width and depth in bf16, loss, global grad norm and whole gradient
     against the plain attention's within TRAIN_BF16_TOL, a dropped key
     tile in every layer outside it; the main path: ``train`` takes 8
     AdamW steps at full width and depth (40 layers, 2.53 B parameters,
     batches of 8 x 1024 from ``SyntheticCorpus``, remat on), every loss
     finite, flash launches exactly 80 a step on the tensor cores; step
     ms, tokens/s, model-FLOP share of the bf16 peak, peak memory; one
     more step under the profiler: device time and launches of the GEMMs,
     the flash forward, the plain attention's backward, the optimizer and
     the rest, idle share; the masters and AdamW state of the first 4
     layers (4.1 GB of the 30.4) saved and restored from a template of
     shapes (timed, bit-equal, then deleted); gate (c): reduced granite
     on the card with tests/test_train_infra.py's end-to-end arguments
     loses 0.3 at least;
     gate (d): ``train_with_restarts`` at full width and 4 layers, failing
     at step 3 of 4, gives the uninterrupted run's masters and state bit
     for bit under ``torch.use_deterministic_algorithms``; the kernel's
     times at the training shape;
 19. training the scan families (``scan_train_phases``): the WKV6
     backward kernel (``csrc/wkv6_backward.cu``) against its plain
     version bit for bit at rwkv6's training shape cut to batch 2 (H 32,
     hs 64, T 1024, bf16, init decays, nonzero ds_last) and at a short
     f32 shape, two launches bit-equal, a backward summed in another
     order within ``WKV_BWD_REL_L2`` and two planted faults (w_{t+1} in
     G_{t−1}; u dropped from dk) outside it; both RG-LRU kernels
     (``csrc/rg_lru.cu``) at recurrentgemma's shape (B 4, S 1024, ld
     4096, f32) bit for bit, a planted off-by-one in h_{t−1} outside
     1e-5; gates ``train_rwkv_f32_gate`` and ``train_griffin_f32_gate``:
     2 layers at full width in f32, one step with the kernels against one
     with the plain versions swapped in (loss 1e-5, every gradient 1e-4
     and nonzero, masters 1e-4, launches exact); ``train`` takes 4 AdamW
     steps of rwkv6-1.6b at full width and depth (8 x 1024, remat on:
     48 chunked WKV6 launches and 24 backward a step) and of
     recurrentgemma-9b at full width, 6 of 38 layers (4 x 1024: 8 RG-LRU
     forward, 4 backward and 4 tensor-core flash launches a step); step
     ms, tokens/s, peak memory, one profiled step each split into GEMMs,
     scan forward and backward, flash forward, the plain attention's
     backward, the optimizer and the rest; the three kernels' times at
     the main paths' shapes;
 20. a JSON line with every kernel; the last line is
     ``{"ok": true, "device": {...}}``.

Each earlier JSON line carries the card's name and power limit and the
seconds since the script started (``elapsed_s``).  To iterate on one
part, call the phases from Python, e.g.

    python3 -c 'import chip_smoke as c; c.setup(); c.build_all(); c.rwkv_phases()'
    python3 -c 'import chip_smoke as c; c.setup(); c.train_phases()'
    python3 -c 'import chip_smoke as c; c.setup(); c.build_all(); c.scan_train_phases()'
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the training phases' restart gate runs under
# torch.use_deterministic_algorithms, which needs cuBLAS on a fixed
# workspace (8 buffers of 4 MiB), named before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# the H100 SXM's peaks (NVIDIA's data sheet), as the port's roofline
# states them; the filled entries' bytes of an SpMV call, as its autotuner
# counts them (one yardstick for both)
from repro_torch.kernels.autotune import entry_bytes  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_PEAK_FLOPS, HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as F32_PEAK_FLOPS)
SEMIRINGS = ("plus_times", "min_plus", "max_min", "min_select")
RULES = ("relax", "pagerank", "pagerank_delta", "kcore", "identity")
FRONTIERS = ("empty", "sparse", "dense")
SCALARS = {"damping": 0.85, "tol": 1e-6, "inv_n": 1e-2}
SLICE_ROWS = 4096
ASYNC_PROFILE_SWEEPS = 12
DEVICE = "cuda"
CA_SCALE, FB_SCALE, SMALL_SCALE = 1.0, 0.005, 0.02
# PageRank stop tolerances: ranks average 1/n, so tol scales with n (the
# JAX package's tests use 1e-9 at n ≈ 200); the oracle check allows
# 100·tol/(1-d): the contraction bound tol/(1-d) with room for float32
# rounding and the L1 renormalization
PR_TOL = {"ca": 1e-11, "fb": 1e-10}

CARD = {}
T0 = time.perf_counter()   # each JSON line's elapsed_s counts from here
PREPARE_S = {}   # the main path's seconds to prepare each plan, by key


def emit(**rec):
    print(json.dumps(dict(rec, card=CARD.get("name"),
                          power_limit=CARD.get("power_limit"),
                          elapsed_s=time.perf_counter() - T0)),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# -- comparisons -------------------------------------------------------------


class Errors:
    """Largest |kernel − plain| seen per kernel (the ELL route's kernels
    ``bsr_spmv``, ``bsr_spmv_fused``; the compacted route's
    ``bsr_spmv_compact``, ``bsr_spmv_fused_compact``)."""

    def __init__(self):
        self.max = {"bsr_spmv": 0.0, "bsr_spmv_fused": 0.0,
                    "bsr_spmv_compact": 0.0, "bsr_spmv_fused_compact": 0.0}

    def _diff(self, name, got, want):
        import torch
        got, want = got.float(), want.float()
        both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
        diff = torch.where(both_inf, 0.0, (got - want).abs())
        err = float(diff.max()) if diff.numel() else 0.0
        self.max[name] = max(self.max[name], err)
        return got, want, both_inf, diff, err

    def check(self, name, got, want, semiring, rule, what):
        """The ELL route: plus_times and the PageRank rules within 2e-6
        relative, the others bit for bit."""
        import torch
        got, want, both_inf, diff, err = self._diff(name, got, want)
        inexact = semiring == "plus_times" or rule.startswith("pagerank")
        if inexact:
            scale = torch.where(both_inf, 1.0, want.abs())
            ok = bool((diff <= 2e-6 * scale).all())
        else:
            ok = bool(torch.equal(got, want))
        if not ok:
            raise AssertionError(f"{name} != plain ({what}): max |Δ| {err}")

    def exact(self, name, got, want, what):
        """The compacted route: bit for bit on every ring and rule."""
        import torch
        err = self._diff(name, got, want)[4]
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != {what}: max |Δ| {err}")


def random_x(gen, q, c, b, semiring, rule, device):
    import torch
    x = torch.rand((q, c, b), generator=gen, device="cpu")
    if semiring == "max_min" or rule == "kcore":
        x = (x > 0.5).float()  # {0,1} carrier; integer live-counts
    return x.to(device)


def compare_plan(vals, cols, nnz, c_rows, semiring, errs, gen, what,
                 xs_rows=None, rules=RULES, index=None):
    """All four kernels vs their plain versions on one plan (or slice of
    one): Q ∈ {1, 4}; the fused kernels over the update rules ×
    frontiers.  The ELL route within ``Errors.check``'s limits; the
    compacted route (over ``index``, else an index built from these
    arrays) bit for bit against its plain version and the ELL kernel."""
    import torch
    from repro_torch.kernels import bsr_spmv as tk
    from repro_torch.kernels import ref as tref
    dev = vals.device
    r, _, b, _ = vals.shape
    if index is None:
        index = tk.build_compact_index(vals, cols, nnz, semiring)
    valid = torch.ones((r, b), dtype=torch.bool, device=dev)
    valid[-1, b // 2:] = False
    for q in (1, 4):
        x = random_x(gen, q, c_rows, b, semiring, "relax", dev)
        y = tk.bsr_spmv(vals, cols, nnz, x, semiring)
        want = tref.bsr_spmv_ref(vals, cols, nnz, x, semiring)
        yc = tk.bsr_spmv(vals, cols, nnz, x, semiring, index=index)
        want_c = tref.bsr_spmv_compact_ref(index, x, semiring)
        torch.cuda.synchronize()
        tag = f"{what} {semiring} Q={q}"
        errs.check("bsr_spmv", y, want, semiring, "relax", tag)
        errs.exact("bsr_spmv_compact", yc, want_c, f"plain ({tag})")
        errs.exact("bsr_spmv_compact", yc, y, f"the ELL kernel ({tag})")
        for rule in rules:
            x = random_x(gen, q, c_rows, b, semiring, rule, dev)
            row0 = 0 if xs_rows is None else xs_rows
            xg = x[:, row0:row0 + r].contiguous()
            damping = 3.0 if rule == "kcore" else SCALARS["damping"]
            sc = [torch.tensor(v, dtype=torch.float32) for v in
                  (damping, SCALARS["tol"], SCALARS["inv_n"])]
            for frontier in FRONTIERS:
                act = {"empty": torch.zeros((q, r), dtype=torch.bool),
                       "sparse": torch.rand((q, r), generator=gen) < 0.15,
                       "dense": torch.ones((q, r), dtype=torch.bool)
                       }[frontier].to(dev)
                args = (x, xg, valid, act, *sc, semiring, rule)
                got = tk.bsr_spmv_fused(vals, cols, nnz, *args)
                want = tref.bsr_spmv_fused_ref(vals, cols, nnz, *args)
                got_c = tk.bsr_spmv_fused(vals, cols, nnz, *args,
                                          index=index)
                want_c = tref.bsr_spmv_fused_compact_ref(index, *args)
                torch.cuda.synchronize()
                tag = f"{what} {semiring} {rule} {frontier} Q={q}"
                errs.check("bsr_spmv_fused", got[0], want[0], semiring,
                           rule, tag)
                for g_, w_ in zip(got[1:], want[1:]):
                    if not torch.equal(g_, w_):
                        raise AssertionError(f"fused flags differ: {tag}")
                for part, g_, w_, e_ in zip(("x_new", "changed", "conv"),
                                            got_c, want_c, got):
                    errs.exact("bsr_spmv_fused_compact", g_, w_,
                               f"plain ({tag}, {part})")
                    errs.exact("bsr_spmv_fused_compact", g_, e_,
                               f"the ELL kernel ({tag}, {part})")


def garbage_check(vals, cols, nnz, c_rows, semiring, gen):
    """Tiles beyond nnz hold garbage: no kernel may read them, and the
    compacted index built from them is the clean one.  The rows are the
    first rows of a plan with c_rows row-blocks."""
    import torch
    from repro_torch.kernels import bsr_spmv as tk
    r, k, b, _ = vals.shape
    dead = torch.arange(k, device=vals.device)[None, :] >= nnz[:, None]
    trash = torch.where(dead[:, :, None, None], -123.0, vals)
    x = random_x(gen, 2, c_rows, b, semiring, "relax", vals.device)
    xg = x[:, :r].contiguous()
    clean = tk.bsr_spmv(vals, cols, nnz, x, semiring)
    dirty = tk.bsr_spmv(trash, cols, nnz, x, semiring)
    act = torch.ones((2, r), dtype=torch.bool, device=vals.device)
    valid = torch.ones((r, b), dtype=torch.bool, device=vals.device)
    sc = [torch.tensor(v, dtype=torch.float32) for v in
          (SCALARS["damping"], SCALARS["tol"], SCALARS["inv_n"])]
    fc = tk.bsr_spmv_fused(vals, cols, nnz, x, xg, valid, act, *sc,
                           semiring, "relax")
    fd = tk.bsr_spmv_fused(trash, cols, nnz, x, xg, valid, act, *sc,
                           semiring, "relax")
    ic = tk.build_compact_index(vals, cols, nnz, semiring)
    id_ = tk.build_compact_index(trash, cols, nnz, semiring)
    cc = tk.bsr_spmv(trash, cols, nnz, x, semiring, index=id_)
    fcc = tk.bsr_spmv_fused(trash, cols, nnz, x, xg, valid, act, *sc,
                            semiring, "relax", index=id_)
    torch.cuda.synchronize()
    if not (torch.equal(clean, dirty) and torch.equal(fc[0], fd[0])
            and torch.equal(fc[1], fd[1])):
        raise AssertionError(f"garbage beyond nnz leaked ({semiring})")
    if not (torch.equal(ic.row_ptr, id_.row_ptr)
            and torch.equal(ic.pairs, id_.pairs) and torch.equal(cc, clean)
            and all(torch.equal(a, b_) for a, b_ in zip(fcc, fc))):
        raise AssertionError(f"garbage beyond nnz reached the compacted "
                             f"route ({semiring})")


# -- timing ------------------------------------------------------------------


def cuda_ms(fn, reps=10, warmup=2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def spmv_bytes(p, q, act=None) -> int:
    """The ELL image's bytes for one call: each input read once (true
    tiles of the walked rows, their cols, nnz, x), each output written
    once.  Kept as ``ell_bound_ms``: the bound of the format, not of the
    function."""
    b = p.b
    rows = p.nnz if act is None else p.nnz[act]
    tiles = int(rows.sum())
    n_rows = p.r_pad if act is None else int(act.sum())
    return (tiles * (b * b * 4 + 4) + n_rows * 4 + q * p.r_pad * b * 4
            + q * p.r_pad * b * 4)


def fused_bytes(p, q, act) -> int:
    """spmv_bytes for the active rows, plus xg and valid of those rows,
    the act mask, and the changed bits written."""
    b = p.b
    n_act = int(act.sum())
    return spmv_bytes(p, q, act) + n_act * b * (4 + 1) + p.r_pad + p.r_pad


def csr_yardstick(p, g, x):
    """The same permuted pull matrix as a CSR tensor (plus_times,
    out-stochastic weights) and its call on x (Q, r_pad, B), as
    ``torch.sparse.mm`` of the matrix by the (n_pad, Q) block x^T: the
    library's SpMV, timed as a yardstick and never called by the port.
    The call returns (n_pad, Q)."""
    import numpy as np
    import torch
    from repro_torch.core.graph import Graph
    outdeg = np.maximum(np.diff(g.indptr), 1)
    w = (1.0 / outdeg)[np.repeat(np.arange(g.n), np.diff(g.indptr))]
    gw = Graph(n=g.n, indptr=g.indptr, indices=g.indices,
               weights=w.astype(np.float32))
    gm = gw.permute(p.perm.astype(np.int32)).transpose()
    n_pad = p.r_pad * p.b
    indptr = np.concatenate([gm.indptr, np.full(
        n_pad - gm.n, gm.indptr[-1], dtype=gm.indptr.dtype)])
    with warnings.catch_warnings():  # "beta state"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(
            torch.from_numpy(indptr), torch.from_numpy(
                gm.indices.astype(np.int64)),
            torch.from_numpy(gm.weights), size=(n_pad, n_pad),
            check_invariants=False).to(DEVICE)
    xf = x.reshape(x.shape[0], -1).T.contiguous()
    return lambda: a @ xf


# the kernels' names in the profiler's table (kernel_device_ms filters)
KERNEL_KEYS = {"bsr_spmv": "bsr_spmv_kernel<",
               "bsr_spmv_fused": "bsr_spmv_fused_kernel<",
               "bsr_spmv_compact": "bsr_spmv_compact_kernel<",
               "bsr_spmv_fused_compact": "bsr_spmv_fused_compact_kernel<"}
SPMV_SOURCES = {"bsr_spmv": "src/repro_torch/kernels/csrc/bsr_spmv.cu",
                "bsr_spmv_compact":
                    "src/repro_torch/kernels/csrc/bsr_spmv_compact.cu"}


def time_kernels(proc, g, errs, launches):
    """Times at the full-scale plans, both routes of both kernels, for
    min_plus and plus_times: the call (CUDA events, median of 10), the
    kernel's device time (the profiler), the plain version, the bound
    from the filled entries (``bound_ms``) and from the ELL image
    (``ell_bound_ms``); for plus_times the CSR call and its device time;
    the fused kernels over a dense and a sparse frontier; then the
    compacted kernels at a serving wave's width (``time_wave_width``).
    Returns the kernels line's four SpMV entries (plus_times) and the
    wave-width records."""
    import torch
    from repro_torch.kernels import bsr_spmv as tk
    from repro_torch.kernels import ref as tref
    out, q64 = {}, []
    for semiring, variant, normalize in (
            ("min_plus", "base", None),
            ("plus_times", "base", "out_stochastic")):
        p = proc.prepare(semiring, variant=variant, normalize=normalize)
        index = p.compact_index()
        x = torch.rand((1, p.r_pad, p.b), device=p.device)
        if semiring == "plus_times":
            x = x / p.n  # rank-sized values
        ell_args = (p.vals, p.cols, p.nnz, x, semiring)
        y_ell = tk.bsr_spmv(*ell_args)
        y_c = tk.bsr_spmv(*ell_args, index=index)
        torch.cuda.synchronize()
        errs.exact("bsr_spmv_compact", y_c, y_ell,
                   f"the ELL kernel (full CA plan, {semiring})")
        lib = lib_device = None
        if semiring == "plus_times":
            csr = csr_yardstick(p, g, x)
            err = float((csr().T.reshape(y_ell.shape) - y_ell).abs().max())
            if err > 1e-5:
                raise AssertionError(f"CSR yardstick disagrees: {err}")
            lib = cuda_ms(csr)
            lib_device = kernel_device_ms(csr)
            del csr
        nb = entry_bytes(index, 1)
        ell_nb = spmv_bytes(p, 1)
        plains = {"bsr_spmv": lambda: tref.bsr_spmv_ref(*ell_args),
                  "bsr_spmv_compact": lambda: tref.bsr_spmv_compact_ref(
                      index, x, semiring)}
        for name, idx in (("bsr_spmv", None), ("bsr_spmv_compact", index)):
            call = lambda idx=idx: tk.bsr_spmv(  # noqa: E731
                *ell_args, index=idx)
            rec = dict(kernel=name, semiring=semiring, ms=cuda_ms(call),
                       device_ms=kernel_device_ms(call, KERNEL_KEYS[name]),
                       plain_ms=cuda_ms(plains[name], reps=3, warmup=1),
                       bytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3,
                       ell_bytes=ell_nb,
                       ell_bound_ms=ell_nb / HBM_BYTES_PER_S * 1e3,
                       library_ms=lib, library_device_ms=lib_device,
                       entries=int(index.pairs.shape[0]),
                       tiles=int(p.nnz.sum()), r_pad=p.r_pad)
            emit(phase="time", **rec)
            out[(name, semiring)] = rec
        # fused: one dense sweep (every valid row active) and a sparse
        # frontier (5 % of the rows; the others exit at once)
        rule = "relax" if semiring == "min_plus" else "pagerank"
        sc = [torch.tensor(v, dtype=torch.float32) for v in
              (0.85, 1e-8, 1.0 / p.n)]
        sparse = (torch.rand((1, p.r_pad), generator=torch.Generator()
                             .manual_seed(1)) < 0.05).to(p.device)
        for frontier, act in (("dense", p.valid.any(dim=1)[None]
                               .contiguous()), ("sparse", sparse)):
            fargs = (p.vals, p.cols, p.nnz, x, x, p.valid, act, *sc,
                     semiring, rule)
            f_ell = tk.bsr_spmv_fused(*fargs)
            f_c = tk.bsr_spmv_fused(*fargs, index=index)
            torch.cuda.synchronize()
            for a, b_ in zip(f_c, f_ell):
                errs.exact("bsr_spmv_fused_compact", a, b_,
                           f"the ELL kernel (full CA plan, {semiring}, "
                           f"{frontier})")
            nb = entry_bytes(index, 1, act[0], fused=True)
            ell_nb = fused_bytes(p, 1, act[0])
            plains = {"bsr_spmv_fused":
                      lambda: tref.bsr_spmv_fused_ref(*fargs),
                      "bsr_spmv_fused_compact":
                      lambda: tref.bsr_spmv_fused_compact_ref(
                          index, *fargs[3:])}
            for name, idx in (("bsr_spmv_fused", None),
                              ("bsr_spmv_fused_compact", index)):
                call = lambda idx=idx: tk.bsr_spmv_fused(  # noqa: E731
                    *fargs, index=idx)
                rec = dict(
                    kernel=name, semiring=semiring, rule=rule,
                    frontier=frontier, ms=cuda_ms(call),
                    device_ms=kernel_device_ms(call, KERNEL_KEYS[name]),
                    plain_ms=(cuda_ms(plains[name], reps=3, warmup=1)
                              if frontier == "dense" else None),
                    bytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3,
                    ell_bytes=ell_nb,
                    ell_bound_ms=ell_nb / HBM_BYTES_PER_S * 1e3,
                    library_ms=None, active_rows=int(act.sum()))
                emit(phase="time", **rec)
                out[(name, semiring, frontier)] = rec
        q64.extend(time_wave_width(p, g, index, semiring, rule, sc))
        torch.cuda.empty_cache()

    def entry(name, r, replaces):
        src = SPMV_SOURCES[name.replace("_fused", "")]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs.max[name], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "ell_bound_ms": r["ell_bound_ms"],
                "library_ms": r["library_ms"]}

    return [entry(name, out[key], replaces) for name, key, replaces in (
        ("bsr_spmv", ("bsr_spmv", "plus_times"),
         "src/repro/kernels/bsr_spmv.py:136"),
        ("bsr_spmv_fused", ("bsr_spmv_fused", "plus_times", "dense"),
         "src/repro/kernels/bsr_spmv.py:324"),
        ("bsr_spmv_compact", ("bsr_spmv_compact", "plus_times"),
         "src/repro/kernels/bsr_spmv.py:136"),
        ("bsr_spmv_fused_compact",
         ("bsr_spmv_fused_compact", "plus_times", "dense"),
         "src/repro/kernels/bsr_spmv.py:324"))], q64


WAVE = 64   # GraphService.max_wave and WavePolicy.max_wave: a full wave


def time_wave_width(p, g, index, semiring, rule, sc):
    """The compacted kernels at Q = ``WAVE``, the query width of a full
    serving wave, on a full-scale plan: the call (CUDA events, median of
    10) and device time (profiler), the plain version, the bound of the
    filled entries at Q 64 (``entry_bytes(index, 64)``), and for
    plus_times ``torch.sparse.mm`` of the CSR matrix by the (n_pad, 64)
    block; the fused kernel over a dense frontier in every query.  Each
    kernel against its plain version bit for bit first."""
    import torch
    from repro_torch.kernels import bsr_spmv as tk
    from repro_torch.kernels import ref as tref
    gen = torch.Generator().manual_seed(64)
    x = torch.rand((WAVE, p.r_pad, p.b), generator=gen).to(p.device)
    if semiring == "plus_times":
        x = x / p.n
    args = (p.vals, p.cols, p.nnz, x, semiring)
    call = lambda: tk.bsr_spmv(*args, index=index)  # noqa: E731
    plain = lambda: tref.bsr_spmv_compact_ref(index, x, semiring)  # noqa
    y = call()
    if not torch.equal(y, plain()):
        raise AssertionError(f"bsr_spmv_compact != plain at Q {WAVE}")
    lib = lib_device = None
    if semiring == "plus_times":
        csr = csr_yardstick(p, g, x)
        err = float((csr().T.reshape(y.shape) - y).abs().max())
        if err > 1e-5:
            raise AssertionError(f"CSR yardstick disagrees at Q {WAVE}: "
                                 f"{err}")
        lib, lib_device = cuda_ms(csr), kernel_device_ms(csr)
        del csr
    nb = entry_bytes(index, WAVE)
    recs = [dict(kernel="bsr_spmv_compact", semiring=semiring, q=WAVE,
                 ms=cuda_ms(call),
                 device_ms=kernel_device_ms(call,
                                            KERNEL_KEYS["bsr_spmv_compact"]),
                 plain_ms=cuda_ms(plain, reps=3, warmup=1), bytes=nb,
                 bound_ms=nb / HBM_BYTES_PER_S * 1e3, library_ms=lib,
                 library_device_ms=lib_device)]
    act = p.valid.any(dim=1)[None].expand(WAVE, -1).contiguous()
    fargs = (p.vals, p.cols, p.nnz, x, x, p.valid, act, *sc, semiring, rule)
    fcall = lambda: tk.bsr_spmv_fused(*fargs, index=index)  # noqa: E731
    fplain = lambda: tref.bsr_spmv_fused_compact_ref(  # noqa: E731
        index, *fargs[3:])
    for a, b_ in zip(fcall(), fplain()):
        if not torch.equal(a, b_):
            raise AssertionError(f"bsr_spmv_fused_compact != plain at Q "
                                 f"{WAVE}")
    nb = entry_bytes(index, WAVE, act[0], fused=True)
    recs.append(dict(
        kernel="bsr_spmv_fused_compact", semiring=semiring, rule=rule,
        frontier="dense", q=WAVE, ms=cuda_ms(fcall),
        device_ms=kernel_device_ms(fcall,
                                   KERNEL_KEYS["bsr_spmv_fused_compact"]),
        plain_ms=cuda_ms(fplain, reps=3, warmup=1), bytes=nb,
        bound_ms=nb / HBM_BYTES_PER_S * 1e3, library_ms=None))
    for rec in recs:
        emit(phase="time_q64", **rec)
    return recs


# -- the main path -----------------------------------------------------------


def run_query(name, fn, tk):
    """One query's wall time, counters, host reads, CUDA-graph capture
    seconds and launches per route.  Every loop reads the host once a
    sweep, and launches its route's kernel once a sweep (sync) or once a
    group of every sweep (async, through the replayed sweep); any other
    count raises."""
    import torch
    before = dict(tk.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if "degraded" in res.extra:
        raise AssertionError(f"{name} degraded: {res.extra['degraded']}")
    st = res.stats
    launches = {k: tk.launch_counts[k] - before[k] for k in before}
    emit(phase="query", query=name, wall_s=wall, capture_s=st.capture_s,
         sweeps=st.sweeps, converged=st.converged, tile_work=st.tile_work,
         edge_work=st.edge_work, host_syncs=st.host_syncs,
         host_syncs_per_sweep=st.host_syncs / max(st.sweeps, 1),
         launches=launches)
    if st.host_syncs != st.sweeps:
        raise AssertionError(f"{name}: {st.host_syncs} host reads in "
                             f"{st.sweeps} sweeps; the loops read once a "
                             f"sweep")
    route = ("bsr_spmv_fused_compact" if res.policy.kernel.fuse_frontier
             else "bsr_spmv_compact")
    want = st.sweeps * (res.prepared.s if st.mode == "async" else 1)
    if launches != {k: want if k == route else 0 for k in launches}:
        raise AssertionError(f"{name}: launches {launches}, want {want} "
                             f"of {route} ({st.sweeps} sweeps)")
    return res


_ORACLE = {}


def oracle(name, g, *args):
    """``core.oracles.<name>(g, *args)``, computed once per graph and
    arguments: the main path, the tuned queries and the serving checks
    hold their values to the same oracles (pure Python over the full CA
    graph: 5-15 s each)."""
    from repro_torch.core import oracles as O
    key = (name, g.fingerprint(), args)
    if key not in _ORACLE:
        _ORACLE[key] = getattr(O, name)(g, *args)
    return _ORACLE[key]


def device_busy(events):
    """(busy seconds, the five longest) over the profile's device events:
    kernels, copies and sets on the card.  The CPU ops that launched them
    carry the same device time again, so they are left out, as torch's
    own table does."""
    from torch.autograd import DeviceType
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return (sum(e.self_device_time_total for e in dev) / 1e6,
            [[e.key[:60], e.self_device_time_total / 1e3, e.count]
             for e in top])


def device_events(fn, reps=20, warmup=5, attempts=3):
    """The profiler's device events (kernels, copies, sets) over ``reps``
    calls of ``fn``, after ``warmup`` calls that run under the profiler but
    are not kept: it misses launches right after it starts.  A profile
    that records none (the profiler on the card now and then does) is
    taken again, ``attempts`` times in all; [] if none recorded any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warmup, active=reps,
                                       repeat=1)) as prof:
            for _ in range(warmup + reps):
                fn()
                torch.cuda.synchronize()
                prof.step()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.count]
        if evs:
            return evs
    return []


def kernel_device_ms(fn, name="", reps=20, warmup=5):
    """Device time of one call of ``fn``, from torch.profiler over
    ``reps`` calls (``device_events``): for each kernel, copy or set the
    call puts on the card whose name holds ``name``, its mean device time
    per launch times its launches per call.  The host's share of a call,
    which CUDA events around a small call also count, is left out.  "not
    measured" when it records none."""
    evs = [e for e in device_events(fn, reps, warmup) if name in e.key]
    if not evs:
        return "not measured"
    return sum(e.self_device_time_total / e.count * max(1, round(
        e.count / reps)) for e in evs) / 1e3


def profiled(fn, warmup=2, tree=False):
    """(wall seconds, the profiler's table) of one call of ``fn``: the
    first ``warmup`` calls run under the profiler but are not kept, since
    it misses launches right after it starts (as in
    ``kernel_device_ms``); then one call is recorded and timed.  With
    ``tree`` also the recorded call's events, each CPU op with the
    kernels it launched and its children (``marked_kernels``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=1,
                                   repeat=1)) as prof:
        for _ in range(warmup):
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    if tree:
        return wall, prof.key_averages(), prof.events()
    return wall, prof.key_averages()


PLAIN_ATTENTION = "plain_attention"


class plain_attention_marked:
    """Within the block each call of ``ref.attention_ref`` (the plain
    attention, which ``ops.attention`` runs where S != Skv: the cross
    calls) runs inside a profiler range named PLAIN_ATTENTION, so that
    ``marked_kernels`` finds the kernels it launched.  The range adds
    only host time, and only where a profile is recorded."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import ref
        self.saved = ref.attention_ref

        def marked(*args, **kwargs):
            with torch.profiler.record_function(PLAIN_ATTENTION):
                return self.saved(*args, **kwargs)

        ref.attention_ref = marked

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        ref.attention_ref = self.saved


def marked_kernels(events, name):
    """(kernel name, device us) of every kernel launched inside the
    profiler ranges named ``name`` (on the host side), their children's
    included."""
    from torch.autograd import DeviceType
    out = []

    def walk(e):
        out.extend((k.name, k.duration) for k in e.kernels)
        for c in e.cpu_children:
            walk(c)

    for e in events:
        if e.name == name and e.device_type == DeviceType.CPU:
            walk(e)
    return out


def device_share(name, fn):
    """Device busy time over one query under torch.profiler, after warm-up
    calls, against the query's wall (the profiler adds host overhead, so
    the idle share is an upper bound)."""
    wall, events = profiled(fn)
    busy, top = device_busy(events)
    emit(phase="profile", query=name, wall_s=wall,
         device_busy_s=busy if busy > 0 else "not measured",
         idle_share=1 - busy / wall if busy > 0 else "not measured",
         top=top)


def check_oracle(algo, g, values, src=None, tol=None):
    import numpy as np
    if algo == "sssp":
        np.testing.assert_allclose(values, oracle("sssp_oracle", g, src),
                                   rtol=1e-5, atol=1e-4)
    elif algo == "bfs":
        np.testing.assert_array_equal(values, oracle("bfs_oracle", g, src))
    elif algo == "reachability":
        np.testing.assert_array_equal(
            values > 0, np.isfinite(oracle("bfs_oracle", g, src)))
    elif algo == "pagerank":
        pr = oracle("pagerank_oracle", g, 0.85, 1e-14, 1000)
        err = float(np.max(np.abs(values - pr)))
        bound = 100 * tol / (1 - 0.85)
        if err > bound or abs(float(values.sum()) - 1.0) >= 1e-5:
            raise AssertionError(
                f"pagerank off the oracle by {err} (bound {bound})")
    elif algo == "cc":
        want = oracle("cc_oracle", g)
        pairs = set(zip(values.tolist(), want.tolist()))
        if not (len(pairs) == len(set(want.tolist()))
                == len(set(values.tolist()))):
            raise AssertionError("cc partition differs from the oracle")
    elif algo.startswith("kcore"):
        np.testing.assert_array_equal(
            values, oracle("kcore_oracle", g, int(algo[5:])))


def index_build(p) -> dict:
    """Build a plan's compacted index (``Prepared.compact_index``, which
    the first query would otherwise build inside its wall); its seconds,
    entries and MB."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = p.compact_index()
    torch.cuda.synchronize()
    return dict(index_s=time.perf_counter() - t0,
                index_entries=int(index.pairs.shape[0]),
                index_mb=index.nbytes / 1e6)


def main_path(errs, gen):
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import graph as G
    from repro_torch.kernels import bsr_spmv as tk

    t0 = time.perf_counter()
    g = G.make_paper_graph("ca", scale=CA_SCALE, seed=0)
    proc = api.GraphProcessor(g, b=16, num_clusters=64, device=DEVICE)
    plans = {}
    for key in (("min_plus", "base", None), ("min_plus", "unit", None),
                ("plus_times", "base", "out_stochastic"),
                ("min_select", "undirected", None),
                ("plus_times", "unit_undirected", None),
                ("max_min", "unit", None)):
        t1 = time.perf_counter()
        p = proc.prepare(key[0], variant=key[1], normalize=key[2])
        plans[key] = p
        PREPARE_S[key] = time.perf_counter() - t1
        emit(phase="prepare", plan=list(key), seconds=PREPARE_S[key],
             r_pad=p.r_pad, k_max=p.k_max, tiles=p.tiles_total,
             edges=p.edges_total, fill=p.edges_total / max(
                 p.tiles_total * p.b * p.b, 1.0),
             vals_gb=p.vals.numel() * 4 / 1e9, **index_build(p))
    emit(phase="graph", n=g.n, nnz=g.nnz, prepare_s=time.perf_counter() - t0,
         device_gb=torch.cuda.memory_allocated() / 1e9)

    # both kernels vs plain on a slice of each full-scale plan, full x
    seen = set()
    for (semiring, _, _), p in plans.items():
        if semiring in seen:
            continue
        seen.add(semiring)
        row0 = p.r_pad // 3
        sl = slice(row0, row0 + SLICE_ROWS)
        compare_plan(p.vals[sl], p.cols[sl], p.nnz[sl], p.r_pad, semiring,
                     errs, gen, "ca-full-slice", xs_rows=row0,
                     index=p.compact_index().rows(sl))
    p = plans[("min_plus", "base", None)]
    garbage_check(p.vals[:SLICE_ROWS], p.cols[:SLICE_ROWS],
                  p.nnz[:SLICE_ROWS], p.r_pad, "min_plus", gen)
    torch.cuda.synchronize()

    fused = api.KernelSpec(impl="pallas", fuse_frontier=True)
    sync = api.ExecutionPolicy(mode="sync", degrade=False)
    asyn = api.ExecutionPolicy(mode="async", degrade=False)

    tk.reset_launch_counts()   # the main path starts here
    res = {}
    for mode, pol in (("sync", sync), ("async", asyn)):
        for kname, kern in (("ref", None), ("fused", fused)):
            name = f"sssp/{mode}/{kname}"
            res[name] = run_query(name, lambda: proc.sssp(
                0, policy=pol.but(kernel=kern, max_sweeps=100_000)), tk)
    bfs_src = [0, g.n // 3, 2 * g.n // 3, g.n - 1]
    res["bfs"] = run_query("bfs/async/fused/batch4", lambda: proc.bfs(
        bfs_src, policy=asyn.but(kernel=fused, max_sweeps=100_000)), tk)
    for kname, kern in (("ref", None), ("fused", fused)):
        res[f"pagerank/{kname}"] = run_query(
            f"pagerank/sync/{kname}", lambda: proc.pagerank(
                policy=sync.but(kernel=kern, tol=PR_TOL["ca"],
                                max_sweeps=500)), tk)
    res["pagerank_delta"] = run_query(
        "pagerank_delta/async/fused", lambda: proc.pagerank_delta(
            policy=asyn.but(kernel=fused, tol=PR_TOL["ca"],
                            max_sweeps=500)), tk)
    res["cc"] = run_query("cc/async/fused", lambda: proc.connected_components(
        policy=asyn.but(kernel=fused, max_sweeps=100_000)), tk)
    res["kcore3"] = run_query("kcore3/async/fused", lambda: proc.kcore(
        3, policy=asyn.but(kernel=fused, max_sweeps=100_000)), tk)
    res["reach"] = run_query(
        "reachability/sync/fused", lambda: proc.reachability(
            0, policy=sync.but(kernel=fused, max_sweeps=100_000)), tk)
    launches = dict(tk.launch_counts)   # the main path ends here
    emit(phase="main_path_launches", **launches)
    for k, v in launches.items():
        if "compact" in k and v <= 0:
            raise AssertionError(f"{k} was never launched on the main path")
        if "compact" not in k and v != 0:
            raise AssertionError(f"the ELL route's {k} launched {v} times "
                                 f"on the main path; the engines take the "
                                 f"compacted route")
    device_share("sssp/sync/fused", lambda: proc.sssp(
        0, policy=sync.but(kernel=fused, max_sweeps=100_000)))
    # the async engine replays one graph a sweep, but the graph holds ~30
    # small kernels a group, 64 groups a sweep: too many device events for
    # the whole query, so the profiled query stops after a few sweeps
    device_share(f"sssp/async/fused/max_sweeps={ASYNC_PROFILE_SWEEPS}",
                 lambda: proc.sssp(0, policy=asyn.but(
                     kernel=fused, max_sweeps=ASYNC_PROFILE_SWEEPS)))

    # values: fused == unfused for the exact rules; oracles for all
    base = res["sssp/sync/ref"]
    for name in ("sssp/sync/fused", "sssp/async/ref", "sssp/async/fused"):
        np.testing.assert_array_equal(res[name].values, base.values)
    for mode in ("sync", "async"):
        a, b = res[f"sssp/{mode}/ref"], res[f"sssp/{mode}/fused"]
        if a.stats.sweeps != b.stats.sweeps:
            raise AssertionError(f"sssp {mode}: fused sweeps differ")
    # the fused loop skips rows whose inputs moved by less than tol
    np.testing.assert_allclose(res["pagerank/fused"].values,
                               res["pagerank/ref"].values, rtol=0,
                               atol=100 * PR_TOL["ca"] / (1 - 0.85))
    t1 = time.perf_counter()
    check_oracle("sssp", g, base.values, 0)
    for q, s in enumerate(bfs_src):
        check_oracle("bfs", g, res["bfs"].values[q], s)
    for name in ("pagerank/ref", "pagerank/fused", "pagerank_delta"):
        check_oracle("pagerank", g, res[name].values, tol=PR_TOL["ca"])
    check_oracle("cc", g, res["cc"].values)
    check_oracle("kcore3", g, res["kcore3"].values)
    check_oracle("reachability", g, res["reach"].values, 0)
    emit(phase="oracles", seconds=time.perf_counter() - t1, ok=True)

    # the power-law stand-in (load imbalance: one hub row sets K)
    gf = G.make_paper_graph("fb", scale=FB_SCALE, seed=0)
    pf = api.GraphProcessor(gf, b=32, num_clusters=64, device=DEVICE)
    # plans and indexes first: the query walls time queries
    for semiring, normalize in (("min_plus", None),
                                ("plus_times", "out_stochastic")):
        emit(phase="fb_prepare", plan=semiring, **index_build(
            pf.prepare(semiring, normalize=normalize)))
    for mode, pol in (("sync", sync), ("async", asyn)):
        r = run_query(f"fb/sssp/{mode}/fused", lambda: pf.sssp(
            0, policy=pol.but(kernel=fused, max_sweeps=100_000)), tk)
        check_oracle("sssp", gf, r.values, 0)
    r = run_query("fb/pagerank/sync/fused", lambda: pf.pagerank(
        policy=sync.but(kernel=fused, tol=PR_TOL["fb"], max_sweeps=500)),
        tk)
    check_oracle("pagerank", gf, r.values, tol=PR_TOL["fb"])
    # the hub rows: all four kernels against their plain versions on the
    # fb plans (the compacted kernels walk a row of more than LONG_ROW
    # entries one warp a row)
    for semiring, normalize in (("min_plus", None),
                                ("plus_times", "out_stochastic")):
        pp = pf.prepare(semiring, normalize=normalize)
        compare_plan(pp.vals, pp.cols, pp.nnz, pp.r_pad, semiring, errs,
                     gen, "fb", index=pp.compact_index())
    pfk = pf.prepare("min_plus")
    index = pfk.compact_index()
    emit(phase="fb_plan", n=gf.n, nnz=gf.nnz, r_pad=pfk.r_pad,
         k_max=pfk.k_max, tiles=pfk.tiles_total,
         vals_gb=pfk.vals.numel() * 4 / 1e9,
         max_row_entries=int(index.row_ptr.diff().max()),
         mean_row_entries=index.pairs.shape[0] / (pfk.r_pad * pfk.b),
         long_rows=len(index.long_host))
    # both routes on the hub rows: does one thread per row leave lanes idle?
    x = torch.rand((1, pfk.r_pad, pfk.b), device=pfk.device)
    nb = entry_bytes(index, 1)
    for name, idx in (("bsr_spmv", None), ("bsr_spmv_compact", index)):
        call = lambda idx=idx: tk.bsr_spmv(  # noqa: E731
            pfk.vals, pfk.cols, pfk.nnz, x, "min_plus", index=idx)
        emit(phase="fb_time", kernel=name, ms=cuda_ms(call),
             device_ms=kernel_device_ms(call, KERNEL_KEYS[name]),
             bytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3)
    return proc, g, launches, res


def sparse_triangles(g):
    """``triangles_oracle`` and ``tricount_oracle`` (core/oracles.py) as
    sparse products: the same formulas, trace(A³)/6 over the undirected
    adjacency and ((A·A) ∘ A) row sums / 2 with the diagonal dropped,
    which the dense oracles cannot hold at n = 1,962,801 (n² int64 is
    31 TB).  ``runners_phase`` holds this form to the dense oracles on a
    small graph first."""
    import numpy as np
    import scipy.sparse as sp
    und = g.to_undirected()
    src = np.repeat(np.arange(und.n), np.diff(und.indptr))
    a = sp.csr_matrix((np.ones(und.nnz, np.int64), (src, und.indices)),
                      shape=(und.n, und.n))
    a.data[:] = 1                        # a[src, dst] = 1, as assigned there
    total = int((a @ a).multiply(a.T).sum()) // 6
    a = a.maximum(a.T)
    a = (sp.triu(a, 1) + sp.tril(a, -1)).tocsr()
    a.eliminate_zeros()
    counts = np.asarray((a @ a).multiply(a).sum(axis=1)).ravel() // 2
    return total, counts


def check_runners(g, tri, cnt, dfs, src, what):
    """MiniTri, tricount and DFS results against the oracles (the
    triangle ones in their sparse form, ``sparse_triangles``)."""
    import numpy as np
    from repro_torch.core import oracles as O
    total, counts = sparse_triangles(g)
    if tri.extra["triangles"] != total or int(tri.values[0]) != total:
        raise AssertionError(f"{what}: minitri {tri.extra['triangles']}, "
                             f"oracle {total}")
    np.testing.assert_array_equal(cnt.values, counts)
    if cnt.extra["triangles"] != total:
        raise AssertionError(f"{what}: tricount total differs")
    order, parent = O.dfs_oracle(g, src)
    nv = dfs.extra["visited_count"]
    if nv != len(order):
        raise AssertionError(f"{what}: dfs visited {nv}, oracle "
                             f"{len(order)}")
    np.testing.assert_array_equal(dfs.values[:nv], order)
    np.testing.assert_array_equal(dfs.extra["parent"], parent)
    return total


def runners_phase(proc, g):
    """MiniTri (its intersections on the card), tricount and DFS (on the
    host, as in the JAX package) through the session on the full-scale CA
    graph and on the ``fb`` stand-in at ``FB_SCALE`` (the CA stand-in, a
    lattice with random shortcuts, has almost no triangles; ``fb`` has
    1.9 M): seconds, and agreement with the oracles.  First, on both
    stand-ins at n ≈ 900, the sparse form of the triangle oracles against
    the dense oracles themselves, and the three runners against both."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import graph as G
    from repro_torch.core import oracles as O
    for name, scale, b in (("ca", 0.0005, 16), ("fb", 0.0003, 32)):
        small = G.make_paper_graph(name, scale=scale, seed=0)
        total, counts = sparse_triangles(small)
        if total != O.triangles_oracle(small):
            raise AssertionError(f"{name}: sparse triangles != "
                                 f"triangles_oracle")
        np.testing.assert_array_equal(counts, O.tricount_oracle(small))
        ps = api.GraphProcessor(small, b=b, num_clusters=8, device=DEVICE)
        check_runners(small, ps.minitri(), ps.tricount(), ps.dfs(0), 0,
                      f"{name} n={small.n}")
    gf = G.make_paper_graph("fb", scale=FB_SCALE, seed=0)
    for name, pr, graph in (
            ("ca", proc, g),
            ("fb", api.GraphProcessor(gf, b=32, num_clusters=64,
                                      device=DEVICE), gf)):
        out = {}
        for algo, fn in (("minitri", pr.minitri), ("tricount", pr.tricount),
                         ("dfs", lambda: pr.dfs(0))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[algo] = fn()
            torch.cuda.synchronize()
            out[algo + "_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        total = check_runners(graph, out["minitri"], out["tricount"],
                              out["dfs"], 0, name)
        emit(phase="runners", graph=name, n=graph.n, nnz=graph.nnz,
             triangles=total,
             oriented_edges=out["minitri"].extra["oriented_edges"],
             k_max=out["minitri"].extra["k_max"],
             dfs_visited=out["dfs"].extra["visited_count"],
             minitri_s=out["minitri_s"], tricount_s=out["tricount_s"],
             dfs_s=out["dfs_s"], oracle_s=time.perf_counter() - t0, ok=True)


def platform_phase(proc, res):
    """The paper's ISA compiler on the full-scale min_plus plan (seconds,
    instructions, the instruction totals), and the paper's analytic
    NALE/CPU/GPU models (core/power.py) for sssp async fused paired with
    sssp sync fused: modelled platforms, not the H100."""
    import math
    from repro_torch.core import compile as GC
    p = proc.prepare("min_plus")
    t0 = time.perf_counter()
    prog = GC.compile_graph_program(p, "relax")
    seconds = time.perf_counter() - t0
    if len(prog.programs) != p.s or \
            prog.instr_total["GMAC"] != int(p.tiles_total):
        raise AssertionError("compile: one program a cluster, one GMAC a "
                             "tile")
    emit(phase="compile", plan="min_plus", seconds=seconds,
         programs=len(prog.programs),
         instructions=prog.total_instructions(),
         instr_total=prog.instr_total,
         static_cycles_max=int(prog.static_cycles.max()))
    ra, rs = res["sssp/async/fused"], res["sssp/sync/fused"]
    rep = ra.platform_models(sync_stats=rs.stats)
    if set(rep) != {"nale", "cpu", "gpu"} or not all(
            math.isfinite(v) and v > 0 for r in rep.values()
            for v in (r.cycles, r.time_s, r.energy_j, r.power_w)):
        raise AssertionError(f"platform models: {rep}")
    nale, cpu, gpu = rep["nale"], rep["cpu"], rep["gpu"]
    emit(phase="platform_models",
         model="the paper's analytic NALE/CPU/GPU model (core/power.py), "
               "not the H100's",
         query="sssp/async/fused with sync_stats of sssp/sync/fused",
         reports={k: dict(cycles=r.cycles, time_s=r.time_s,
                          energy_j=r.energy_j, power_w=r.power_w,
                          perf_per_watt=r.perf_per_watt)
                  for k, r in rep.items()},
         nale_speedup_over_cpu=cpu.time_s / nale.time_s,
         nale_speedup_over_gpu=gpu.time_s / nale.time_s,
         nale_perf_per_watt_over_cpu=nale.perf_per_watt / cpu.perf_per_watt,
         nale_perf_per_watt_over_gpu=nale.perf_per_watt / gpu.perf_per_watt)


# -- the distributed engines on a mesh of slots on the one card --------------

# (devices, query axis) of the JAX package's distributed tests; every slot
# is the one card, so the halo exchange and the vote run as on N cards
DIST_FACTORIZATIONS = ((1, 1), (4, 2), (8, 1), (8, 8))
DIST_KS = (2, 4)
DIST_SOURCES = 4             # np.linspace(0, n - 1, 4), as the JAX bench
DIST_WAVE_SEED = 2


def dist_round_split(events, rounds):
    """Device ms a round from a profile, split into the compacted SpMV,
    copies on the card (the halo exchange: the engines make no other
    device-to-device copy in the loop) and the rest (the update rule, the
    masks, the vote)."""
    from torch.autograd import DeviceType
    split = {"spmv": 0.0, "exchange_copies": 0.0, "rest": 0.0}
    for e in events:
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        key = e.key.lower()
        part = ("spmv" if "bsr_spmv_compact" in key else
                "exchange_copies" if ("copy" in key and "dtoh" not in key
                                      and "htod" not in key)
                or "dtod" in key else "rest")
        split[part] += e.self_device_time_total / 1e3
    if not any(split.values()):
        return "not measured"
    return {k: v / max(rounds, 1) for k, v in split.items()}


def dist_run(what, fn, tk, launches_want):
    """One distributed engine run: its wall (the card synchronized before
    and after), DistStats, and its compacted launches, which must equal
    ``launches_want(stats)`` with no launch of another kernel; one host
    read a round."""
    import torch
    before = dict(tk.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, ds = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: tk.launch_counts[k] - before[k] for k in before}
    want = launches_want(ds)
    if launches != {k: want if k == "bsr_spmv_compact" else 0
                    for k in launches}:
        raise AssertionError(f"{what}: launches {launches}, want {want} of "
                             f"bsr_spmv_compact")
    if ds.host_syncs != ds.halo_exchanges:
        raise AssertionError(f"{what}: {ds.host_syncs} host reads in "
                             f"{ds.halo_exchanges} rounds")
    return x, ds, wall, launches["bsr_spmv_compact"]


def filled_slots(p, mesh):
    """Slots whose graph shard holds rows of the plan (the others launch
    nothing)."""
    d_g, d_q = mesh.shape["graph"], mesh.shape["query"]
    rl = -(-p.r_pad // d_g)
    return sum(1 for s in range(d_g) if s * rl < p.r_pad) * d_q


def exchange_time(p, x0, mesh, own_halo):
    """The halo exchange alone on this layout (CUDA events, median of
    10): ms, the bytes it reads and writes, and their bound at 3.35 TB/s."""
    from repro_torch.core import placement as PL
    st = PL._Slots(p, PL.shard_batched_inputs(p, x0, mesh=mesh), own_halo)
    nb = 2 * st.copy_bytes
    return dict(exchange_ms=cuda_ms(st.exchange), exchange_bytes=nb,
                exchange_bound_ms=nb / HBM_BYTES_PER_S * 1e3)


def distributed_phase(proc, g, res):
    """The bulk-synchronous and self-timed distributed engines on the
    main path's full-scale CA plans, every mesh slot on the one card:
    sssp and bfs from ``DIST_SOURCES`` sources at each of
    ``DIST_FACTORIZATIONS``, sync and async at k ∈ ``DIST_KS``, then
    pagerank_delta async at (4, 2) k 2; one session query on the default
    mesh, one ``dist.dispatch`` fault, one 64-wide ``GraphServer`` wave.
    Gates: values bit-equal to ``run_sync_batched`` (pagerank_delta
    within 2·tol/(1-d) of ``run_sync``), sync per-query sweeps equal to
    ``run_sync``'s of each source, exchanges (sync: one a sweep; async:
    fewer), one host read a round, exact launches, ``RunStats`` from the
    ``DistStats``.  Returns the compacted kernel's launches in these
    runs."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch import resilience as rz
    from repro_torch.core import async_dist as AD
    from repro_torch.core import engine as E
    from repro_torch.core import placement as PL
    from repro_torch.kernels import bsr_spmv as tk

    dev = PL._device(DEVICE)
    t_phase = time.perf_counter()
    sources = [int(v) for v in np.linspace(0, g.n - 1, DIST_SOURCES)]
    sync = api.ExecutionPolicy(mode="sync", max_sweeps=100_000,
                               degrade=False)
    total = 0
    for algo in ("sssp", "bfs"):
        spec = api.QuerySpec(algo=algo, sources=tuple(sources), batched=True)
        p, _, x0f, pad, apply_kind, _ = proc._relaxation_setup(spec,
                                                                sync)
        x0 = torch.stack([p.to_blocks(x0f(s), pad) for s in sources])
        want, _ = E.run_sync_batched(p, x0, apply_kind, max_sweeps=100_000)
        per_src = np.array([E.run_sync(p, x0[q], apply_kind,
                                       max_sweeps=100_000)[1].sweeps
                            for q in range(len(sources))])
        for nd, qa in DIST_FACTORIZATIONS:
            mesh = PL.make_graph_mesh(nd, qa, device=dev)
            slots = filled_slots(p, mesh)
            tag = f"{algo}/{nd}x{qa}"
            x, ds, wall, n = dist_run(
                f"{tag}/sync", lambda: PL.distributed_sync_run_batched(
                    p, x0, apply_kind, max_sweeps=100_000, mesh=mesh),
                tk, lambda ds: ds.sweeps * slots)
            total += n
            if not torch.equal(x, want):
                raise AssertionError(f"{tag}/sync != run_sync_batched")
            if not (np.array_equal(ds.query_sweeps, per_src) and
                    ds.halo_exchanges == ds.sweeps and ds.converged):
                raise AssertionError(f"{tag}/sync: sweeps "
                                     f"{ds.query_sweeps} vs {per_src}, "
                                     f"exchanges {ds.halo_exchanges}")
            sync_ds = ds
            runs = [("sync", 1, ds, wall, n)]
            for k in DIST_KS:
                x, ds, wall, n = dist_run(
                    f"{tag}/async/k{k}",
                    lambda k=k: AD.distributed_async_run_batched(
                        p, x0, apply_kind, max_sweeps=100_000, mesh=mesh,
                        local_sweeps=k),
                    tk, lambda ds, k=k: ds.halo_exchanges * slots * (k + 1))
                total += n
                if not torch.equal(x, want) or not ds.converged:
                    raise AssertionError(f"{tag}/async/k{k} != "
                                         f"run_sync_batched")
                if sync_ds.sweeps > 1 and \
                        ds.halo_exchanges >= sync_ds.halo_exchanges:
                    raise AssertionError(
                        f"{tag}/async/k{k}: {ds.halo_exchanges} exchanges, "
                        f"sync {sync_ds.halo_exchanges}")
                runs.append(("async", k, ds, wall, n))
            for flavor, k, ds, wall, n in runs:
                emit(phase="distributed", algo=algo, mesh=[nd // qa, qa],
                     flavor=flavor, k=k, wall_s=wall, sweeps=ds.sweeps,
                     query_sweeps=ds.query_sweeps.tolist(),
                     exchanges=ds.halo_exchanges, host_syncs=ds.host_syncs,
                     shard_sweeps=None if ds.shard_sweeps is None
                     else ds.shard_sweeps.tolist(), launches=n,
                     halo_bytes_per_sweep=ds.halo_bytes_per_sweep,
                     copy_bytes_per_exchange=ds.copy_bytes_per_exchange,
                     ms_per_round=wall / max(ds.halo_exchanges, 1) * 1e3)
            if algo == "sssp":
                for own, flavor in ((False, "sync"), (True, "async")):
                    emit(phase="distributed_exchange", mesh=[nd // qa, qa],
                         flavor=flavor, q=len(sources),
                         **exchange_time(p, x0, mesh, own))
        if algo == "sssp":
            # device ms a round, profiled after two unrecorded runs
            mesh = PL.make_graph_mesh(4, 2, device=dev)
            for flavor, fn in (
                    ("sync", lambda: PL.distributed_sync_run_batched(
                        p, x0, apply_kind, max_sweeps=100_000, mesh=mesh)),
                    ("async/k2", lambda: AD.distributed_async_run_batched(
                        p, x0, apply_kind, max_sweeps=100_000, mesh=mesh,
                        local_sweeps=2))):
                out = {}
                wall, events = profiled(lambda: out.update(r=fn()))
                rounds = out["r"][1].halo_exchanges
                busy, top = device_busy(events)
                emit(phase="distributed_profile", algo=algo, mesh=[2, 2],
                     flavor=flavor, rounds=rounds, wall_s=wall,
                     device_busy_s=busy if busy > 0 else "not measured",
                     idle_share=1 - busy / wall if busy > 0
                     else "not measured",
                     device_ms_per_round=dist_round_split(events, rounds),
                     top=top)

    # pagerank_delta: an accumulation rule, tolerance-bounded
    tol, damping = PR_TOL["ca"], 0.85
    pol = sync.but(tol=tol, max_sweeps=500)
    p, _, x0f, pad, apply_kind, _ = proc._relaxation_setup(
        api.QuerySpec(algo="pagerank_delta"), pol)
    x0 = p.to_blocks(x0f(None), pad)
    want, st = E.run_sync(p, x0, apply_kind, tol=tol, max_sweeps=500)
    mesh = PL.make_graph_mesh(4, 2, device=dev)
    slots = filled_slots(p, mesh)
    x, ds, wall, n = dist_run(
        "pagerank_delta/2x2/async/k2",
        lambda: AD.distributed_async_run_batched(
            p, x0[None], apply_kind, tol=tol, max_sweeps=500, mesh=mesh,
            local_sweeps=2), tk, lambda ds: ds.halo_exchanges * slots * 3)
    total += n
    err = float((x[0] - want).abs().max())
    bound = 2 * tol / (1 - damping)
    emit(phase="distributed", algo="pagerank_delta", mesh=[2, 2],
         flavor="async", k=2, wall_s=wall, sweeps=ds.sweeps,
         sync_sweeps=st.sweeps, exchanges=ds.halo_exchanges,
         host_syncs=ds.host_syncs, shard_sweeps=ds.shard_sweeps.tolist(),
         launches=n, max_abs_err=err, bound=bound)
    if not ds.converged or err > bound:
        raise AssertionError(f"pagerank_delta async: |Δ| {err} > {bound}")

    # the session on its default mesh (every card), its counters from
    # the DistStats, then a failed exchange round walked down the ladder
    dist = api.ExecutionPolicy(mode="distributed", max_sweeps=100_000,
                               degrade=False)
    p = proc.prepare("min_plus")
    r = run_dist_session(proc, dist, tk)
    total += r.stats.sweeps
    ds = r.extra["dist"]
    np.testing.assert_array_equal(r.values, res["sssp/sync/ref"].values)
    if r.stats != E.bsp_stats(p, ds.sweeps, ds.converged, "distributed"):
        raise AssertionError(f"session stats {r.stats} != bsp_stats")
    before = tk.launch_counts["bsr_spmv_compact"]
    ra = proc.sssp(sources, policy=dist.but(dist_flavor="async",
                                            local_sweeps=2))
    da = ra.extra["dist"]
    n = tk.launch_counts["bsr_spmv_compact"] - before
    total += n
    d_g, d_q = da.mesh_shape
    if ra.stats != E.dist_run_stats(p, da) or ra.stats.halo_tiles != float(
            p.group_ext_tiles.cpu().numpy().sum()) * da.halo_exchanges or \
            n != da.halo_exchanges * 3 * filled_slots(
                p, PL.make_graph_mesh(d_g * d_q, d_q, device=dev)):
        raise AssertionError(f"session async: {ra.stats}, {n} launches")
    with rz.inject(rz.FaultPlan([rz.FaultSpec("dist.dispatch", count=1)],
                                seed=0)) as plan:
        f = proc.run(api.QuerySpec(algo="sssp", sources=(0,),
                                   policy=dist.but(degrade=True)))
    np.testing.assert_array_equal(f.values, res["sssp/sync/ref"].values)
    steps = f.extra.get("degraded", [])
    if plan.stats()["dist.dispatch"]["injected"] != 1 or \
            [s["from"].split("/")[0] for s in steps] != ["distributed"]:
        raise AssertionError(f"dist.dispatch fallback: {steps}")
    emit(phase="distributed_session", mesh=list(ds.mesh_shape),
         sweeps=ds.sweeps, host_syncs=r.stats.host_syncs,
         async_mesh=list(da.mesh_shape), async_exchanges=da.halo_exchanges,
         fallback=steps[0]["from"] + " -> " + steps[0]["to"], ok=True)

    total += distributed_wave(proc, g, dist, tk)
    emit(phase="distributed_phase", seconds=time.perf_counter() - t_phase,
         launches=total)
    return total


def run_dist_session(proc, pol, tk):
    """One single-source sssp through ``GraphProcessor.run`` under
    ``pol``: one launch a sweep on the default mesh of the one card, one
    host read a sweep."""
    from repro_torch import api
    before = tk.launch_counts["bsr_spmv_compact"]
    r = proc.run(api.QuerySpec(algo="sssp", sources=(0,), policy=pol))
    slots = r.extra["dist"].mesh_shape[0]
    if tk.launch_counts["bsr_spmv_compact"] - before != \
            r.stats.sweeps * slots or r.stats.host_syncs != r.stats.sweeps:
        raise AssertionError(f"session: launches or host reads off "
                             f"({r.stats})")
    return r


def distributed_wave(proc, g, pol, tk):
    """64 single-source sssp requests into a paused ``GraphServer`` over
    the min_plus plan under ``pol``: started, it closes ONE wave, served
    by one batched distributed run; each ticket equals a direct sync run
    of the 64 sources and carries the wave's ``DistStats``.  Returns the
    wave's launches."""
    import numpy as np
    import torch
    from repro_torch import api
    p = proc.prepare("min_plus")
    svc = api.GraphService(max_plan_bytes=2 * p.nbytes, device=DEVICE)
    sproc = svc.register("ca", g, b=16, num_clusters=64)
    svc.store.put(g.fingerprint(), sproc.plan_key("min_plus"), p)
    src = [int(v) for v in np.random.default_rng(DIST_WAVE_SEED).integers(
        0, g.n, WAVE)]
    server = api.GraphServer(service=svc, wave=api.WavePolicy(
        max_wave=WAVE, max_wait_s=0.005, workers=1), autostart=False)
    futs = [server.submit("ca", api.QuerySpec(algo="sssp", sources=(s,),
                                              policy=pol)) for s in src]
    before = tk.launch_counts["bsr_spmv_compact"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.start()
    got = [f.result(SERVE_WAIT_S) for f in futs]
    wall = time.perf_counter() - t0
    server.close()
    launched = tk.launch_counts["bsr_spmv_compact"] - before
    st = svc.stats()
    ds = got[0].extra["dist"]
    direct = sproc.run(api.QuerySpec(algo="sssp", sources=tuple(src),
                                     batched=True,
                                     policy=pol.but(mode="sync")))
    for q, r in enumerate(got):
        np.testing.assert_array_equal(r.values, direct.values[q])
        if r.extra["coalesced"] != WAVE or r.extra["dist"] is not ds:
            raise AssertionError("distributed wave: a ticket not served "
                                 "by the one wave")
    if st["batched_runs"] != 1 or st["coalesced_queries"] != WAVE or \
            launched != ds.halo_exchanges * ds.mesh_shape[0] or \
            ds.host_syncs != ds.halo_exchanges:
        raise AssertionError(f"distributed wave: {st}, {launched} "
                             f"launches, {ds}")
    emit(phase="distributed_wave", width=WAVE, wall_s=wall,
         mesh=list(ds.mesh_shape), sweeps=ds.sweeps,
         exchanges=ds.halo_exchanges, host_syncs=ds.host_syncs,
         launches=launched, batched_runs=st["batched_runs"])
    return launched


def distributed_alone():
    """The ``distributed`` phase alone, after ``setup()``: the full-scale
    CA graph and the three plans it reads are built here (no main path
    before it)."""
    from repro_torch import api
    from repro_torch.core import graph as G
    g = G.make_paper_graph("ca", scale=CA_SCALE, seed=0)
    proc = api.GraphProcessor(g, b=16, num_clusters=64, device=DEVICE)
    for semiring, variant, normalize in (
            ("min_plus", "base", None), ("min_plus", "unit", None),
            ("plus_times", "base", "out_stochastic")):
        proc.prepare(semiring, variant=variant,
                     normalize=normalize).compact_index()
    res = {"sssp/sync/ref": proc.sssp(0, policy=api.ExecutionPolicy(
        mode="sync", max_sweeps=100_000))}
    return distributed_phase(proc, g, res)


# -- the autotuner: the compacted kernels' launch knobs ----------------------

TUNE_TRACE = ROOT / "build" / "autotune_trace.json"
TUNE_CACHE = ROOT / "build" / "autotune_cache"
TUNE_SLOWER = 1.05   # the winner's device ms over the default knobs', at most
TUNE_MODEL_TOL = 0.01  # modeled_s against entry_bytes / HBM, relative
# (name, the main path's untuned query it must equal, mode, fused)
TUNE_QUERIES = (
    ("sssp/sync/tuned", "sssp/sync/ref", "sync", False),
    ("sssp/sync/fused/tuned", "sssp/sync/fused", "sync", True),
    ("sssp/async/fused/tuned", "sssp/async/fused", "async", True),
    ("bfs/async/fused/batch4/tuned", "bfs", "async", True))


def tune_specs():
    from repro_torch import api
    return {False: api.KernelSpec(impl="pallas", autotune=True),
            True: api.KernelSpec(impl="pallas", fuse_frontier=True,
                                 autotune=True)}


def knob_grid():
    """Every candidate the tuner can measure: (block_size, rows_per_step,
    fused), the unfused grid then the fused one."""
    from repro_torch.kernels.autotune import BK_CANDIDATES, RS_CANDIDATES
    return ([(bk, rs, False) for bk in BK_CANDIDATES for rs in RS_CANDIDATES]
            + [(bk, 1, True) for bk in BK_CANDIDATES])


def knob_call(p, index, x, act, sc, semiring, rule, bk, rs, fused):
    """One launch of the compacted kernel at knobs (bk, rs)."""
    from repro_torch.kernels import bsr_spmv as tk
    if fused:
        return lambda: tk.bsr_spmv_fused(
            p.vals, p.cols, p.nnz, x, x, p.valid, act, *sc, semiring, rule,
            index=index, block_size=bk)
    return lambda: tk.bsr_spmv(p.vals, p.cols, p.nnz, x, semiring,
                               index=index, block_size=bk, rows_per_step=rs)


def candidates_vs_plain(p, semiring, errs, gen, what, q=2):
    """Every candidate of ``knob_grid`` against the plain version, bit for
    bit, on one plan: Q queries, a 25 % frontier for the fused kernel
    (PageRank's rule on plus_times, relax on the others)."""
    import torch
    from repro_torch.kernels import ref as tref
    index = p.compact_index()
    rule = "pagerank" if semiring == "plus_times" else "relax"
    x = random_x(gen, q, p.r_pad, p.b, semiring, rule, p.device)
    act = (torch.rand((q, p.r_pad), generator=gen) < 0.25).to(p.device)
    sc = [torch.tensor(v, dtype=torch.float32)
          for v in (SCALARS["damping"], SCALARS["tol"], 1.0 / p.n)]
    want = tref.bsr_spmv_compact_ref(index, x, semiring)
    fwant = tref.bsr_spmv_fused_compact_ref(index, x, x, p.valid, act, *sc,
                                            semiring, rule)
    for bk, rs, fused in knob_grid():
        got = knob_call(p, index, x, act, sc, semiring, rule, bk, rs,
                        fused)()
        tag = f"plain ({what}, {semiring}, b={p.b}, knobs {bk}/{rs})"
        if fused:
            for part, g_, w_ in zip(("x_new", "changed", "conv"), got,
                                    fwant):
                errs.exact("bsr_spmv_fused_compact", g_, w_,
                           f"{tag}, {part}")
        else:
            errs.exact("bsr_spmv_compact", got, want, tag)


def launch_blocks(calls, attempts=3):
    """Each call's kernel launch as torch.profiler's trace records it:
    (its name, block threads, registers a thread), in call order.  Two
    rounds run under the profiler, which may miss launches right after it
    starts; the last round is read.  A trace that holds fewer launches
    than one round (the profiler on the card now and then drops most of
    its device events) is taken again, ``attempts`` times in all, as in
    ``device_events``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def round_():
        for fn in calls:
            fn()
            torch.cuda.synchronize()
    round_()
    recorded = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            round_()
            round_()
        TUNE_TRACE.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(TUNE_TRACE))
        events = json.loads(TUNE_TRACE.read_text())["traceEvents"]
        TUNE_TRACE.unlink()
        kern = sorted((e for e in events if e.get("cat") == "kernel"
                       and "_compact_kernel<" in e.get("name", "")),
                      key=lambda e: e["ts"])
        recorded.append(len(kern))
        if len(kern) >= len(calls):
            return [(e["name"], int(e["args"]["block"][0]),
                     e["args"].get("registers per thread"))
                    for e in kern[-len(calls):]]
    raise AssertionError(f"the profiler recorded {recorded} compacted "
                         f"launches of {2 * len(calls)} in {attempts} "
                         f"traces")


def tune_on_plan(proc, variant, fused, errs):
    """The session's tuning of one full-scale min_plus plan, measured at
    ``prepare(kernel=spec)`` (the tuner's wall); every candidate's time
    against the model, the model against ``entry_bytes``, each
    candidate's block threads from the profiler, the winner's device ms
    against the default knobs' and the winner at Q 64 against the plain
    version, bit for bit."""
    import dataclasses
    import torch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ref as tref
    spec = tune_specs()[fused]
    calls0 = proc.cache_info()["autotune_calls"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = proc.prepare("min_plus", variant=variant, kernel=spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if proc.cache_info()["autotune_calls"] != calls0 + 1:
        raise AssertionError(f"prepare(kernel={spec}) did not measure one "
                             f"tuning")
    key = proc.plan_key("min_plus", variant=variant)
    rec = proc._ensure_tuning(p, key, spec)     # the record just measured
    index = p.compact_index()
    x, act, *sc = at._calibration_inputs(p, proc.seed, "relax")
    model_bytes = entry_bytes(index, 1, act if fused else None, fused=fused)
    model_s = model_bytes / HBM_BYTES_PER_S
    name = "bsr_spmv_fused_compact" if fused else "bsr_spmv_compact"
    slow = [c for c in rec["candidates"] if c["measured_s"] < rec["modeled_s"]]
    if slow or not rec["roofline_agrees"]:
        raise AssertionError(f"{name}: measured below the roofline "
                             f"{rec['modeled_s']} s: {slow}")
    if abs(rec["modeled_s"] - model_s) > TUNE_MODEL_TOL * model_s:
        raise AssertionError(f"{name}: modeled_s {rec['modeled_s']} against "
                             f"entry_bytes / HBM {model_s}")
    # the knobs are real: each candidate launches 32 x block_size threads
    grid = [k for k in knob_grid() if k[2] == fused]
    blocks = launch_blocks([knob_call(p, index, x, act, sc, "min_plus",
                                      "relax", bk, rs, f)
                            for bk, rs, f in grid])
    for (bk, rs, _), (kname, threads, _) in zip(grid, blocks):
        if KERNEL_KEYS[name] not in kname or threads != 32 * bk:
            raise AssertionError(f"knobs {bk}/{rs}: launch {kname} with "
                                 f"{threads} threads, want {32 * bk}")
    # the tuner must not pick a loser: device ms, in turns default, winner
    win = (rec["block_size"], rec["rows_per_step"])
    dflt = (8, 1)
    times = {win: [], dflt: []}
    for knobs in (dflt, win, win, dflt):
        times[knobs].append(kernel_device_ms(knob_call(
            p, index, x, act, sc, "min_plus", "relax", *knobs, fused),
            KERNEL_KEYS[name]))
    if any(isinstance(t, str) for ts in times.values() for t in ts):
        raise AssertionError(f"{name}: the profiler recorded no device time")
    win_ms, dflt_ms = (statistics.mean(times[k]) for k in (win, dflt))
    if win_ms > TUNE_SLOWER * dflt_ms:
        raise AssertionError(f"{name}: the winner {win} takes {win_ms} ms "
                             f"of device time, the default knobs {dflt_ms}")
    # the winner at a serving wave's width, bit for bit
    x64 = torch.rand((WAVE, p.r_pad, p.b), generator=torch.Generator()
                     .manual_seed(65)).to(p.device)
    act64 = torch.ones((WAVE, p.r_pad), dtype=torch.bool, device=p.device)
    got = knob_call(p, index, x64, act64, sc, "min_plus", "relax", *win,
                    fused)()
    if fused:
        want = tref.bsr_spmv_fused_compact_ref(index, x64, x64, p.valid,
                                               act64, *sc, "min_plus",
                                               "relax")
        for part, g_, w_ in zip(("x_new", "changed", "conv"), got, want):
            errs.exact(name, g_, w_, f"plain at Q {WAVE} ({win}, {part})")
    else:
        errs.exact(name, got, tref.bsr_spmv_compact_ref(index, x64,
                                                        "min_plus"),
                   f"plain at Q {WAVE} ({win})")
    del x64, act64, got
    out = dict(
        kernel=name, plan=["min_plus", variant],
        spec=dataclasses.asdict(spec), tuner_wall_s=wall,
        block_size=win[0], rows_per_step=win[1],
        measured_ms=rec["measured_s"] * 1e3,
        modeled_ms=rec["modeled_s"] * 1e3, model_bytes=model_bytes,
        roofline_agrees=rec["roofline_agrees"],
        candidates=[[c["block_size"], c["rows_per_step"],
                     c["measured_s"] * 1e3] for c in rec["candidates"]],
        launch_blocks=[[bk, rs, threads, regs] for (bk, rs, _),
                       (_, threads, regs) in zip(grid, blocks)],
        tuned_device_ms=win_ms, default_device_ms=dflt_ms,
        device_ms_runs={"tuned": times[win], "default": times[dflt]})
    emit(phase="autotune", **out)
    return out


def tuning_survives_restart(g02):
    """A GraphService over a fresh cache_dir measures one tuning; a second
    service on the same directory reads it back (autotune_calls 0) and
    answers with the same values."""
    import dataclasses
    import shutil
    import numpy as np
    from repro_torch import api
    shutil.rmtree(TUNE_CACHE, ignore_errors=True)
    pol = api.ExecutionPolicy(mode="sync", degrade=False,
                              kernel=tune_specs()[True])
    got, recs = [], []
    for _ in range(2):
        svc = api.GraphService(cache_dir=str(TUNE_CACHE), device=DEVICE)
        proc = svc.register("ca", g02, b=16, num_clusters=64)
        got.append((proc.sssp(0, policy=pol),
                    proc.cache_info()["autotune_calls"]))
        tkey = dataclasses.replace(proc.plan_key("min_plus"),
                                   kernel=pol.kernel)
        recs.append(svc.store.get_tuning(g02.fingerprint(), tkey))
        del svc, proc
    shutil.rmtree(TUNE_CACHE, ignore_errors=True)
    (r1, c1), (r2, c2) = got
    if (c1, c2) != (1, 0) or recs[0] is None or recs[0] != recs[1]:
        raise AssertionError(f"restart: autotune_calls {c1}, {c2}; records "
                             f"{recs}")
    np.testing.assert_array_equal(r2.values, r1.values)
    check_oracle("sssp", g02, r2.values, 0)
    emit(phase="autotune_restart", autotune_calls=[c1, c2],
         block_size=recs[1]["block_size"], ok=True)


def autotune_phase(proc, g, res, kernels):
    """Phase ``autotune``: the compacted kernels' launch knobs.  Every
    candidate bit for bit against the plain version at the scale-0.02 CA
    plans (four rings, b 16 and 32) and the Facebook stand-in's (b 32, hub
    rows); the session's tuning of the full-scale min_plus plans
    (``tune_on_plan``: unfused and fused on the base plan, fused on the
    unit plan that bfs reads); sssp sync (unfused and fused), sssp async
    fused and bfs async fused from 4 sources with ``autotune=True``, each
    equal to the main path's untuned run in values, sweeps and every
    ``RunStats`` counter and held to the oracles; a tuning read back by a
    restarted service.  Adds the winners to the kernels line."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import engine as E
    from repro_torch.core import graph as G
    from repro_torch.kernels import bsr_spmv as tk
    t_phase = time.perf_counter()
    errs = Errors()
    gen = torch.Generator().manual_seed(22)
    g02 = G.make_paper_graph("ca", scale=SMALL_SCALE, seed=0)
    gfb = G.make_paper_graph("fb", scale=FB_SCALE, seed=0)
    long_rows = 0
    for graph, what, blocks in ((g02, "ca-0.02", (16, 32)),
                                (gfb, "fb", (32,))):
        for b in blocks:
            for semiring in SEMIRINGS:
                p = E.prepare(graph, semiring, b=b, num_clusters=64,
                              device=DEVICE)
                candidates_vs_plain(p, semiring, errs, gen, what)
                if what == "fb":
                    long_rows = max(long_rows,
                                    len(p.compact_index().long_host))
                del p
    if long_rows == 0:
        raise AssertionError("the fb plans have no long rows")
    emit(phase="autotune_vs_plain", ok=True, candidates=len(knob_grid()),
         fb_long_rows=long_rows, max_abs_err=errs.max)

    tuned = {("base", False): tune_on_plan(proc, "base", False, errs),
             ("base", True): tune_on_plan(proc, "base", True, errs),
             ("unit", True): tune_on_plan(proc, "unit", True, errs)}
    calls = proc.cache_info()["autotune_calls"]
    specs = tune_specs()
    bfs_src = [0, g.n // 3, 2 * g.n // 3, g.n - 1]
    for name, base, mode, fused in TUNE_QUERIES:
        pol = api.ExecutionPolicy(mode=mode, degrade=False,
                                  kernel=specs[fused], max_sweeps=100_000)
        if name.startswith("bfs"):
            r = run_query(name, lambda: proc.bfs(bfs_src, policy=pol), tk)
        else:
            r = run_query(name, lambda: proc.sssp(0, policy=pol), tk)
        want = res[base]
        np.testing.assert_array_equal(r.values, want.values)
        st, sw = (dict(dataclasses.asdict(x.stats), capture_s=0)
                  for x in (r, want))
        if st != sw:
            raise AssertionError(f"{name}: stats {st} != untuned {sw}")
        if name.startswith("bfs"):
            for q, s in enumerate(bfs_src):
                check_oracle("bfs", g, r.values[q], s)
        else:
            check_oracle("sssp", g, r.values, 0)
    if proc.cache_info()["autotune_calls"] != calls:
        raise AssertionError("a tuned query measured its tuning again")
    tuning_survives_restart(g02)
    emit(phase="autotune_e2e", ok=True, queries=len(TUNE_QUERIES),
         autotune_calls=calls, tunings=proc.cache_info()["tunings"],
         max_abs_err=errs.max, seconds=time.perf_counter() - t_phase)
    for entry in kernels:
        rec = tuned.get(("base", entry["name"] == "bsr_spmv_fused_compact"))
        if entry["name"] in ("bsr_spmv_compact", "bsr_spmv_fused_compact"):
            entry.update(tuned_knobs=[rec["block_size"],
                                      rec["rows_per_step"]],
                         tuned_device_ms=rec["tuned_device_ms"],
                         default_device_ms=rec["default_device_ms"],
                         tuned_on="min_plus base plan, calibration inputs")
    torch.cuda.empty_cache()
    return tuned


def autotune_alone():
    """The ``autotune`` phase alone, after ``setup()``: the full-scale CA
    graph, its min_plus base and unit plans and the untuned queries the
    phase compares against are built here (no main path before it)."""
    from repro_torch import api
    from repro_torch.core import graph as G
    from repro_torch.kernels import bsr_spmv as tk
    g = G.make_paper_graph("ca", scale=CA_SCALE, seed=0)
    proc = api.GraphProcessor(g, b=16, num_clusters=64, device=DEVICE)
    for variant in ("base", "unit"):
        proc.prepare("min_plus", variant=variant).compact_index()
    fused = api.KernelSpec(impl="pallas", fuse_frontier=True)
    res = {}
    for name, mode, kern in (("sssp/sync/ref", "sync", None),
                             ("sssp/sync/fused", "sync", fused),
                             ("sssp/async/fused", "async", fused)):
        pol = api.ExecutionPolicy(mode=mode, kernel=kern, degrade=False,
                                  max_sweeps=100_000)
        res[name] = run_query(name, lambda: proc.sssp(0, policy=pol), tk)
    pol = api.ExecutionPolicy(mode="async", kernel=fused, degrade=False,
                              max_sweeps=100_000)
    res["bfs"] = run_query("bfs/async/fused/batch4", lambda: proc.bfs(
        [0, g.n // 3, 2 * g.n // 3, g.n - 1], policy=pol), tk)
    return autotune_phase(proc, g, res, [])


# -- graph serving: GraphServer over the full-scale plans --------------------

SERVE_SSSP, SERVE_BFS, SERVE_CLIENTS = 256, 64, 8
SERVE_SAMPLES = {"sssp": 8, "bfs": 4}
SERVE_WAIT_S = 600           # the bound on every wait for a request
# the plans the traffic reads (sssp, bfs, pagerank, cc), handed from the
# main path's session to the service's store rather than built again
SERVE_PLANS = (("min_plus", "base", None), ("min_plus", "unit", None),
               ("plus_times", "base", "out_stochastic"),
               ("min_select", "undirected", None))
SERVE_CACHE = ROOT / "build" / "plan_cache"


class WaveLog:
    """Wraps the served processor's ``run``: each call is one wave of
    the service (or one request that does not coalesce).  Records its
    width, wall, engine seconds (the runner from its first sweep to its
    counters on the host; the rest of the wall is the session's host
    work around it: x0 and the values, per source), stats and launches
    per route.  The launch deltas are a wave's own while one wave runs
    at a time (``WavePolicy(workers=1)``); ``exact`` is cleared for runs
    that overlap on purpose.  It waits on its own stream, never on the
    device: a device-wide synchronize from any thread invalidates a
    capture open in another."""

    def __init__(self, proc, tk):
        import threading
        from repro_torch.core import engine as E
        self.proc, self.tk, self.real = proc, tk, proc.run
        self.runs, self.exact, self.lock = [], True, threading.Lock()
        self.engine = threading.local()
        self.E, self.real_run = E, E._run

        def timed_run(*a, **k):
            import torch
            t0 = time.perf_counter()
            out = self.real_run(*a, **k)
            torch.cuda.current_stream().synchronize()
            self.engine.seconds = time.perf_counter() - t0
            return out
        E._run = timed_run
        proc.run = self

    def __call__(self, spec):
        import torch
        before = dict(self.tk.launch_counts)
        self.engine.seconds = 0.0
        t0 = time.perf_counter()
        res = self.real(spec)
        torch.cuda.current_stream().synchronize()
        wall = time.perf_counter() - t0
        with self.lock:
            self.runs.append(dict(
                algo=spec.algo, width=len(spec.sources) or 1, wall_s=wall,
                engine_s=self.engine.seconds, stats=res.stats,
                fused=res.policy.kernel.fuse_frontier, s=res.prepared.s,
                exact=self.exact, launches={
                    k: self.tk.launch_counts[k] - before[k] for k in before}))
        return res

    @staticmethod
    def summary(runs):
        return [dict(algo=r["algo"], width=r["width"], mode=r["stats"].mode,
                     wall_s=r["wall_s"], engine_s=r["engine_s"],
                     host_s=r["wall_s"] - r["engine_s"],
                     sweeps=r["stats"].sweeps,
                     capture_s=r["stats"].capture_s) for r in runs]

    def check(self, runs):
        """Every run read the host once a sweep; every exact run launched
        its route sweeps × s times (async) or once a sweep (sync)."""
        for r in runs:
            st = r["stats"]
            if st.host_syncs != st.sweeps:
                raise AssertionError(f"{r['algo']} x{r['width']}: "
                                     f"{st.host_syncs} host reads in "
                                     f"{st.sweeps} sweeps")
            route = ("bsr_spmv_fused_compact" if r["fused"]
                     else "bsr_spmv_compact")
            want = st.sweeps * (r["s"] if st.mode == "async" else 1)
            if r["exact"] and r["launches"] != {
                    k: want if k == route else 0 for k in r["launches"]}:
                raise AssertionError(f"{r['algo']} x{r['width']} "
                                     f"({st.mode}): launches "
                                     f"{r['launches']}, want {want} of "
                                     f"{route}")

    def close(self):
        del self.proc.run          # the class's method again
        self.E._run = self.real_run


def graph_traffic(server, specs):
    """``SERVE_CLIENTS`` threads submit ``specs`` round robin into
    ``server`` at once; every future must resolve without an error.
    Returns the results in order and requests/s (first submit to last
    completion) with each request's latency, submit to completion."""
    import threading
    import numpy as np
    n = len(specs)
    futs, t_sub, t_done = [None] * n, [0.0] * n, [0.0] * n
    barrier = threading.Barrier(SERVE_CLIENTS)

    def client(i):
        barrier.wait(timeout=SERVE_WAIT_S)
        for j in range(i, n, SERVE_CLIENTS):
            t_sub[j] = time.perf_counter()
            futs[j] = server.submit("ca", specs[j])
            futs[j].add_done_callback(
                lambda _f, j=j: t_done.__setitem__(j, time.perf_counter()))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_WAIT_S)
    if any(t.is_alive() for t in threads) or None in futs:
        raise AssertionError("a client thread did not finish submitting")
    results = [f.result(timeout=SERVE_WAIT_S) for f in futs]
    end = time.perf_counter() + 10
    while 0.0 in t_done and time.perf_counter() < end:
        time.sleep(0.001)          # the last callbacks run after result()
    lat = np.asarray(t_done) - np.asarray(t_sub)
    span = max(t_done) - min(t_sub)
    return results, dict(requests=n, seconds=span, requests_per_s=n / span,
                         p50_ms=float(np.percentile(lat, 50)) * 1e3,
                         p99_ms=float(np.percentile(lat, 99)) * 1e3,
                         max_ms=float(lat.max()) * 1e3)


def held_capture():
    """Patch ``engine._CapturedSweep`` so that the first capture stays
    open (inside ``torch.cuda.graph``) until ``release`` is set, so that
    what other threads do meanwhile overlaps it for certain.  Returns
    (capturing, release, undo)."""
    import threading
    from repro_torch.core import engine as E
    capturing, release = threading.Event(), threading.Event()
    real = E._CapturedSweep

    class Held(real):
        def __init__(self, sweep, device):
            def hold():
                flags = sweep()
                if not capturing.is_set():
                    capturing.set()
                    release.wait(timeout=SERVE_WAIT_S)
                return flags
            super().__init__(hold, device)

    E._CapturedSweep = Held
    return capturing, release, lambda: setattr(E, "_CapturedSweep", real)


def concurrency_check(svc, log, sssp_src, want, sync, sync_want):
    """One 64-wide async wave captures its sweep (held open) while a
    second thread uploads a plan read from disk through
    ``GraphServer.register(warm=True)`` and a third runs a sync query on
    the served graph: all three equal to their serial runs, and the
    launches of the window exactly the two queries' own."""
    import shutil
    import threading
    import numpy as np
    from repro_torch import api
    from repro_torch.core import graph as G
    from repro_torch.kernels import bsr_spmv as tk
    small = G.make_paper_graph("ca", scale=SMALL_SCALE, seed=0)
    cache = SERVE_CACHE / "small"
    shutil.rmtree(cache, ignore_errors=True)
    first = api.GraphServer(cache_dir=str(cache), device=DEVICE)
    first.register("small", small, b=16, num_clusters=64)
    small_want = first.run("small", api.QuerySpec(
        algo="sssp", sources=(3,))).values
    first.close()                  # its access log names min_plus
    loader = api.GraphServer(cache_dir=str(cache), device=DEVICE)
    server = api.GraphServer(service=svc, wave=api.WavePolicy(
        max_wave=WAVE, max_wait_s=0.005, workers=1), autostart=False)
    srcs = sssp_src[:WAVE]
    futs = [server.submit("ca", api.QuerySpec(algo="sssp", sources=(s,)))
            for s in srcs]
    out, errors = {}, []
    capturing, release, undo = held_capture()

    def upload():
        capturing.wait(timeout=SERVE_WAIT_S)
        try:
            loader.register("small", small, b=16, num_clusters=64,
                            warm=True)
            out["warm"] = loader.wait_warm(timeout=SERVE_WAIT_S)
        except Exception as e:
            errors.append(e)

    def sync_query():
        capturing.wait(timeout=SERVE_WAIT_S)
        try:
            out["sync"] = svc.run("ca", api.QuerySpec(
                algo="sssp", sources=(srcs[0],), policy=sync)).values
        except Exception as e:
            errors.append(e)

    others = [threading.Thread(target=upload),
              threading.Thread(target=sync_query)]
    n_runs = len(log.runs)
    before = dict(tk.launch_counts)
    log.exact = False
    try:
        for t in others:
            t.start()
        server.start()
        for t in others:
            t.join(timeout=SERVE_WAIT_S)
        release.set()
        res = [f.result(timeout=SERVE_WAIT_S) for f in futs]
    finally:
        release.set()
        undo()
        log.exact = True
    launches = {k: tk.launch_counts[k] - before[k] for k in before}
    if any(t.is_alive() for t in others) or errors or not out.get("warm"):
        raise AssertionError(f"concurrency: {errors or 'a thread hung'}")
    if not capturing.is_set() or res[0].stats.capture_s <= 0:
        raise AssertionError("concurrency: the wave never captured")
    for r, s in zip(res, srcs):
        np.testing.assert_array_equal(r.values, want[s])
    np.testing.assert_array_equal(out["sync"], sync_want)
    window = log.runs[n_runs:]
    log.check(window)
    expect = {}
    for r in window:
        route = ("bsr_spmv_fused_compact" if r["fused"]
                 else "bsr_spmv_compact")
        n = r["stats"].sweeps * (r["s"] if r["stats"].mode == "async" else 1)
        expect[route] = expect.get(route, 0) + n
    if launches != {k: expect.get(k, 0) for k in launches}:
        raise AssertionError(f"concurrency: launches {launches}, the two "
                             f"queries' own {expect}")
    ls = loader.stats()
    if ls["server"]["plans_warmed"] != 1 or \
            ls["service"]["plan_store"]["disk_hits"] != 1:
        raise AssertionError(f"concurrency: the upload did not happen: "
                             f"{ls}")
    np.testing.assert_array_equal(loader.run("small", api.QuerySpec(
        algo="sssp", sources=(3,))).values, small_want)
    server.close()
    loader.close()
    shutil.rmtree(cache, ignore_errors=True)
    emit(phase="serving_concurrency", wave=len(srcs),
         capture_s=res[0].stats.capture_s, sweeps=res[0].stats.sweeps,
         launches=launches, equal=True)


def disk_tier(proc, g, plans, want0):
    """A ``GraphService(cache_dir=...)`` writes the min_plus plan; a
    fresh one on the same directory loads it (``prepare_calls == 0``),
    builds its compacted index on the card at its first query and answers
    it bit-equal to the first; then an eviction frees the loaded plan's
    device bytes.  At the full scale when the disk holds three plans'
    bytes, else at ``SMALL_SCALE`` (printed)."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import engine as E
    from repro_torch.core import graph as G
    from repro_torch.serve import graph as SG
    SERVE_CACHE.mkdir(parents=True, exist_ok=True)
    key = ("min_plus", "base", None)
    p = plans[key]
    free = shutil.disk_usage(SERVE_CACHE).free
    full = free >= 3 * p.nbytes
    if full:
        gd, other = g, plans[("min_plus", "unit", None)]
        prepare_s = PREPARE_S[key]
    else:
        gd = G.make_paper_graph("ca", scale=SMALL_SCALE, seed=0)
        small = api.GraphProcessor(gd, b=16, num_clusters=64, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = small.prepare("min_plus")
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        other = small.prepare("min_plus", variant="unit")
    cache = SERVE_CACHE / "disk"
    shutil.rmtree(cache, ignore_errors=True)
    first = api.GraphService(cache_dir=str(cache), max_plan_bytes=p.nbytes,
                             device=DEVICE)
    fproc = first.register("ca", gd, b=16, num_clusters=64)
    pk = fproc.plan_key("min_plus")
    t0 = time.perf_counter()
    first.store.put(gd.fingerprint(), pk, p)
    write_s = time.perf_counter() - t0
    path = cache / SG._plan_filename(gd.fingerprint(), pk)
    spec = api.QuerySpec(algo="sssp", sources=(0,))
    want = first.run("ca", spec).values if not full else want0
    again = api.GraphService(cache_dir=str(cache), max_plan_bytes=p.nbytes,
                             device=DEVICE)
    aproc = again.register("ca", gd, b=16, num_clusters=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = aproc.prepare("min_plus")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if aproc.cache_info()["prepare_calls"] != 0 or \
            again.store.stats()["disk_hits"] != 1 or \
            loaded.compact is not None or \
            loaded.vals.device.type != torch.device(DEVICE).type:
        raise AssertionError("disk tier: the plan was not read from disk")
    got = again.run("ca", spec).values
    np.testing.assert_array_equal(got, want)
    if loaded.compact is None or \
            loaded.compact.pairs.device != loaded.vals.device:
        raise AssertionError("disk tier: no compacted index on the card")
    # the loaded plan in a store of its own, the only holder left; a plan
    # already on the card evicts it, and its bytes leave the card (its
    # device fields and its compacted index: ``nbytes`` also counts the
    # permutations, which live on the host)
    held = loaded.compact.nbytes + sum(
        getattr(loaded, f).numel() * getattr(loaded, f).element_size()
        for f in E._PREPARED_DEVICE_FIELDS)
    store = api.PlanStore(max_bytes=loaded.nbytes, device=DEVICE)
    store.put(gd.fingerprint(), pk, loaded)
    del loaded, again, aproc
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    store.put(gd.fingerprint(), fproc.plan_key("min_plus", "unit"), other)
    gc.collect()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    if store.stats()["evictions"] != 1 or freed < 0.99 * held:
        raise AssertionError(f"eviction freed {freed} B of {held}")
    emit(phase="serving_disk", scale=CA_SCALE if full else SMALL_SCALE,
         disk_free_gb=free / 1e9, plan_gb=p.nbytes / 1e9,
         file_gb=path.stat().st_size / 1e9, write_s=write_s, load_s=load_s,
         prepare_s=prepare_s, load_over_prepare=load_s / prepare_s,
         prepare_calls=0, equal=True, evicted_device_gb=held / 1e9,
         evicted_freed_gb=freed / 1e9)
    shutil.rmtree(cache, ignore_errors=True)


def graph_serving(proc, g, res, q64, kernels):
    """The serving layer on the card: a ``GraphServer`` over the
    full-scale CA plans (handed from the main path's session to the
    service's store), 8 client threads, coalesced waves of up to 64
    sources on the compacted kernels; then the same sssp sources under a
    sync fused policy, a transient dispatch fault, the concurrency check,
    the disk tier and an eviction.  Gates: every future resolves, sampled
    results bit-equal to direct runs, oracles, batched waves, one host
    read a sweep and exact launches per wave."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch import resilience as rz
    from repro_torch.kernels import bsr_spmv as tk

    fp = g.fingerprint()
    plans = {k: proc.prepare(k[0], variant=k[1], normalize=k[2])
             for k in SERVE_PLANS}
    budget = sum(p.nbytes for p in plans.values())  # these four fit
    svc = api.GraphService(max_plan_bytes=budget, device=DEVICE)
    sproc = svc.register("ca", g, b=16, num_clusters=64)
    for k, p in plans.items():
        svc.store.put(fp, sproc.plan_key(k[0], k[1], normalize=k[2]), p)
    st = svc.store.stats()
    emit(phase="serving_store", max_plan_bytes=budget, plans=st["plans"],
         plan_gb={"/".join(map(str, k)): p.nbytes / 1e9
                  for k, p in plans.items()}, evictions=st["evictions"])
    if st["plans"] != len(plans) or st["evictions"]:
        raise AssertionError(f"serving store: {st}")

    rng = np.random.default_rng(0)
    sssp_src = [int(v) for v in rng.integers(0, g.n, SERVE_SSSP)]
    bfs_src = [int(v) for v in rng.integers(0, g.n, SERVE_BFS)]
    specs = ([api.QuerySpec(algo="sssp", sources=(s,)) for s in sssp_src]
             + [api.QuerySpec(algo="bfs", sources=(s,)) for s in bfs_src]
             + [api.QuerySpec(algo="pagerank"), api.QuerySpec(algo="cc")])
    specs = [specs[i] for i in rng.permutation(len(specs))]
    sync = api.ExecutionPolicy(mode="sync", kernel=api.KernelSpec(
        impl="pallas", fuse_frontier=True))

    log = WaveLog(sproc, tk)
    server = api.GraphServer(service=svc, wave=api.WavePolicy(
        max_wave=WAVE, max_wait_s=0.005, workers=1))
    tk.reset_launch_counts()       # the serving path starts here
    torch.cuda.reset_peak_memory_stats()
    metrics = {}
    results, metrics["default"] = graph_traffic(server, specs)
    values = {(sp.algo, sp.sources[0] if sp.sources else None): r.values
              for sp, r in zip(specs, results)}   # a source may repeat
    n_default = len(log.runs)
    results, metrics["sync"] = graph_traffic(server, [
        api.QuerySpec(algo="sssp", sources=(s,), policy=sync)
        for s in sssp_src])
    by_src = {s: values[("sssp", s)] for s in sssp_src}
    sync_by_src = {s: r.values for s, r in zip(sssp_src, results)}
    for s in sssp_src:             # sssp is exact: both engines agree
        np.testing.assert_array_equal(sync_by_src[s], by_src[s])
    for name, runs in (("default", log.runs[:n_default]),
                       ("sync", log.runs[n_default:])):
        widths = [r["width"] for r in runs]
        emit(phase="serving_traffic", policy=name, **metrics[name],
             waves=len(runs), widths=sorted(widths, reverse=True),
             mean_width=float(np.mean(widths)),
             wave_wall_s=sum(r["wall_s"] for r in runs),
             wave_engine_s=sum(r["engine_s"] for r in runs),
             per_wave=WaveLog.summary(runs))
    log.check(log.runs)
    ss = svc.stats()
    if ss["batched_runs"] < 4 or \
            ss["coalesced_queries"] / ss["batched_runs"] <= 1:
        raise AssertionError(f"serving: waves did not batch: {ss}")

    # a transient dispatch fault: the retried request, the same values
    retries = server.stats()["scheduler"]["retries"]
    with rz.inject(rz.FaultPlan([rz.FaultSpec("sched.dispatch", count=1)],
                                seed=0)) as plan:
        r = server.submit("ca", api.QuerySpec(
            algo="sssp", sources=(sssp_src[1],))).result(SERVE_WAIT_S)
    np.testing.assert_array_equal(r.values, by_src[sssp_src[1]])
    if server.stats()["scheduler"]["retries"] != retries + 1 or \
            plan.stats()["sched.dispatch"]["injected"] != 1:
        raise AssertionError("serving: the faulted dispatch was not "
                             "retried once")
    concurrency_check(svc, log, sssp_src, by_src, sync,
                      sync_by_src[sssp_src[0]])
    server.close()
    launches = dict(tk.launch_counts)  # the serving path ends here
    peak = torch.cuda.max_memory_allocated()
    log.check(log.runs)
    emit(phase="serving_launches", **launches)
    for k, v in launches.items():
        if ("compact" in k) != (v > 0):
            raise AssertionError(f"serving path: {k} launched {v} times")
    log.close()

    # the direct runs the sampled results are held to, and the oracles
    pick = np.random.default_rng(1)
    t0 = time.perf_counter()
    for algo, srcs in (("sssp", sssp_src), ("bfs", bfs_src)):
        for j, i in enumerate(pick.choice(len(srcs), SERVE_SAMPLES[algo],
                                          replace=False)):
            got = values[(algo, srcs[i])]
            direct = sproc.run(api.QuerySpec(algo=algo, sources=(srcs[i],)))
            np.testing.assert_array_equal(got, direct.values)
            if j == 0:
                check_oracle(algo, g, got, srcs[i])
    check_oracle("pagerank", g, values[("pagerank", None)], tol=1e-8)
    check_oracle("cc", g, values[("cc", None)])
    emit(phase="serving_checks", seconds=time.perf_counter() - t0,
         samples=SERVE_SAMPLES, oracles={"sssp": 1, "bfs": 1, "pagerank": 1,
                                         "cc": 1}, ok=True)

    wave = next(r for r in log.runs if r["algo"] == "sssp"
                and r["width"] == WAVE and r["stats"].mode == "async")
    capped = api.ExecutionPolicy(max_sweeps=ASYNC_PROFILE_SWEEPS)
    wall, events = profiled(lambda: sproc.run(api.QuerySpec(
        algo="sssp", sources=tuple(sssp_src[:WAVE]), batched=True,
        policy=capped)))
    busy, top = device_busy(events)
    emit(phase="serving_wave", width=WAVE, wall_s=wave["wall_s"],
         engine_s=wave["engine_s"], host_s=wave["wall_s"] - wave["engine_s"],
         sweeps=wave["stats"].sweeps, capture_s=wave["stats"].capture_s,
         tile_work=wave["stats"].tile_work,
         profiled_sweeps=ASYNC_PROFILE_SWEEPS, profiled_wall_s=wall,
         device_busy_s=busy if busy > 0 else "not measured",
         idle_share=1 - busy / wall if busy > 0 else "not measured",
         device_ms_per_sweep=(busy / ASYNC_PROFILE_SWEEPS * 1e3
                              if busy > 0 else "not measured"),
         top=top, peak_device_gb=peak / 1e9)
    for rec in q64:              # the Q-64 rows beside the serving path
        emit(phase="time_q64_launches", kernel=rec["kernel"],
             semiring=rec["semiring"],
             serving_launches=launches[rec["kernel"]])
    for entry in kernels:
        entry["serving_launches"] = launches[entry["name"]]
    disk_tier(proc, g, plans, res["sssp/async/ref"].values)


def serving_phase():
    """The ``graph_serving`` phase alone, after ``setup()``: the
    full-scale CA graph and the four plans its traffic reads are built
    here (no main path before it, no kernel times after it)."""
    from repro_torch import api
    from repro_torch.core import graph as G
    g = G.make_paper_graph("ca", scale=CA_SCALE, seed=0)
    proc = api.GraphProcessor(g, b=16, num_clusters=64, device=DEVICE)
    for key in SERVE_PLANS:
        t0 = time.perf_counter()
        p = proc.prepare(key[0], variant=key[1], normalize=key[2])
        PREPARE_S[key] = time.perf_counter() - t0
        p.compact_index()
    graph_serving(proc, g, {"sssp/async/ref": proc.sssp(0)}, [], [])


# -- LM serving: flash attention and granite-3-2b ---------------------------

LM_ARCH = "granite-3-2b"
LM_REDUCED = False          # full width; a CPU rehearsal sets True
PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 1024, 32
SERVE_REQUESTS, SERVE_SLOTS = 8, 4
LONG_S = 16384
# kernel vs plain, elementwise |Δ| <= tol + tol·|plain|, as
# tests/test_kernels.py:59.  In bf16 that alone is loose: a typical output
# is 0.01-0.05, and the kernel's f32 scores and p against mha_ref's bf16
# ones move the outputs of rows with few keys by up to about 1e-2 where
# they nearly cancel.  So each case also holds ‖Δ‖₂/‖plain‖₂ under
# ATTN_REL_L2: the bf16 output's own rounding gives about 4e-3, a
# dropped 64-key tile about 0.3 (checked below, on the card, every run).
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
ATTN_REL_L2 = {"bfloat16": 1e-2, "float32": 1e-5}
# prefill logits, kernel vs mha_ref: ‖Δ‖₂/‖ref‖₂ over one wave.  In f32
# (the same weights upcast) only the summation order differs: that check
# is the gate.  In bf16 the two round p differently (f32 vs bf16) in each
# of 40 layers, and the difference compounds (2.1e-2 measured on the
# H100); printed beside it are the bf16 model's own distance from f32 and
# the distance of a dropped key tile in every layer.
LOGIT_REL_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# room left beside the f32 upcast for its prefills (recurrentgemma's f32
# prefill of 4 x 3072 tokens with mha_ref's scores: about 10 GB)
UPCAST_HEADROOM_GB = 8
# a flipped greedy token is accepted when its logit and the static path's
# token's logit differ by at most this (two bf16 ulps at |logit| < 8)
FLIP_TOL = 0.125
# decode steps a profiled window holds (after as many unrecorded): the
# profiler's processing, not the steps, takes the time of that phase
DECODE_PROFILE_STEPS = 2


def attention_pairs(b, h, s, causal, window) -> int:
    """(query, key) pairs the mask keeps, over every (batch, head)."""
    import numpy as np
    q = np.arange(s, dtype=np.int64)
    hi = q + 1 if causal else np.full(s, s)       # keys < hi
    lo = np.zeros(s, dtype=np.int64) if window is None \
        else np.maximum(q - window + 1, 0)        # keys >= lo
    return b * h * int((hi - lo).sum())


def attention_bound(b, h, hkv, s, d, dtype, causal, window):
    """Least time for one call: operations (4·D per kept pair) at the peak
    of their type (bf16: the tensor cores; f32: the CUDA cores, since
    TF32 would round the inputs), or q, k, v read and o written once at
    3.35 TB/s, whichever is larger."""
    import torch
    ops_ = 4 * d * attention_pairs(b, h, s, causal, window)
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * elem
    peak = BF16_PEAK_FLOPS if dtype == torch.bfloat16 else F32_PEAK_FLOPS
    t_ops, t_bytes = ops_ / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops_, nbytes)


def _qkv(gen, b, h, hkv, s, d, dtype, model_layout=False):
    """Random q, k, v (B, H, S, D); with ``model_layout`` their memory is
    (B, S, H, D), as the model passes them, seen through transpose(1, 2)."""
    import torch
    if model_layout:
        return [torch.randn((b, s, n, d), generator=gen, device=DEVICE)
                .to(dtype).transpose(1, 2) for n in (h, hkv, hkv)]
    return [torch.randn((b, n, s, d), generator=gen, device=DEVICE)
            .to(dtype) for n in (h, hkv, hkv)]


def _planted_fault(q, k, v, want, causal, window, what):
    """The limits must catch a dropped key tile at this case's shape."""
    bad = dropped_tile_attention(q, k, v, causal, window)
    try:
        _attn_check(bad, want, q.dtype, f"planted fault: key tile 1 "
                    f"dropped ({what})", "plain")
    except AssertionError:
        return
    raise AssertionError(f"a dropped key tile passed the attention limits "
                         f"({what})")


def attention_vs_plain(gen):
    """The flash kernels against their plain version at the serving shapes,
    each case on the route ``flash_attention.route`` gives it; returns the
    largest |kernel − plain| of each route, and each case's."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as tref
    bf16, f32 = torch.bfloat16, torch.float32
    s = PROMPT_LEN
    cases = [  # name, B, H, Hkv, S, D, dtype, causal, window[, layout]
        ("granite prefill bf16", PROMPTS, 32, 8, s, 64, bf16, True, None),
        ("granite prefill f32", PROMPTS, 32, 8, s, 64, f32, True, None),
        ("ragged S=100 full bf16", 2, 32, 8, 100, 64, bf16, False, None),
        ("ragged S=100 full f32", 2, 32, 8, 100, 64, f32, False, None),
        ("window 256 causal bf16", 2, 32, 8, s, 64, bf16, True, 256),
        ("window 200 full f32", 1, 8, 2, 1000, 64, f32, False, 200),
        ("D=128 chatglm3 bf16", 1, 32, 2, s, 128, bf16, True, None),
        ("D=128 ragged f32", 1, 8, 2, 777, 128, f32, True, None),
        # tensor-core cases
        ("D=128 window 256 bf16", 1, 32, 2, s, 128, bf16, True, 256),
        ("D=128 ragged S=777 full bf16", 1, 8, 2, 777, 128, bf16, False,
         None),
        ("D=64 Hkv=1 (group 32) bf16", 1, 32, 1, s, 64, bf16, True, None),
        ("D=64 S=100 full Hkv=1 bf16", 1, 32, 1, 100, 64, bf16, False,
         None),
        ("granite prefill, model layout (B,S,H,D) bf16", PROMPTS, 32, 8, s,
         64, bf16, True, None, True),
        # the CUDA-core kernel's bf16 route
        ("D=32 bf16", 1, 8, 2, 512, 32, bf16, True, None),
        # head dims 192 and 256: recurrentgemma-9b's prefill (MQA, window
        # 2048, the window masking every query past 2047) and
        # nemotron-4-340b's; bf16 on the tensor cores, f32 on the CUDA
        # cores
        ("recurrentgemma prefill D=256 window 2048 bf16", PROMPTS,
         16, 1, GRIFFIN_PROMPT_LEN, 256, bf16, True, GRIFFIN_WINDOW),
        ("recurrentgemma D=256 window 2048 S=1024 f32", PROMPTS, 16,
         1, 1024, 256, f32, True, GRIFFIN_WINDOW),
        ("D=256 ragged S=777 full bf16", 1, 16, 1, 777, 256, bf16, False,
         None),
        ("recurrentgemma, model layout (B,S,H,D) D=256 bf16", 1, 16, 1,
         GRIFFIN_PROMPT_LEN, 256, bf16, True, GRIFFIN_WINDOW, True),
        ("nemotron D=192 bf16", 1, 96, 8, 1024, 192, bf16, True, None),
        ("D=192 ragged S=777 window 300 bf16", 1, 8, 2, 777, 192, bf16,
         True, 300),
        ("D=192 ragged S=100 full, model layout bf16", 2, 8, 8, 100, 192,
         bf16, False, None, True),
        # whisper-tiny's encoder (MHA: group 1, D 64, unmasked, S 1500, not
        # a multiple of the tile) and its decoder's self-attention at its
        # 448-token prompts; llama-3.2-vision-11b's prefill (group 4, D 128)
        (WHISPER_ENCODER_CASE, PROMPTS, 6, 6, WHISPER_ENCODER_SEQ, 64, bf16,
         False, None),
        ("whisper encoder, model layout (B,S,H,D) bf16", PROMPTS, 6, 6,
         WHISPER_ENCODER_SEQ, 64, bf16, False, None, True),
        ("whisper decoder self S=448 causal, model layout bf16", PROMPTS, 6,
         6, WHISPER_PROMPT_LEN, 64, bf16, True, None, True),
        (VISION_PREFILL_CASE, PROMPTS, 32, 8, s, 128, bf16, True, None),
    ]
    fault_at = {"granite prefill bf16": "tensor_cores",
                WHISPER_ENCODER_CASE: "tensor_cores",
                VISION_PREFILL_CASE: "tensor_cores",
                "D=128 chatglm3 bf16": "tensor_cores",
                "recurrentgemma prefill D=256 window 2048 bf16":
                    "tensor_cores",
                "recurrentgemma D=256 window 2048 S=1024 f32":
                    "cuda_cores"}
    worst = {"tensor_cores": 0.0, "cuda_cores": 0.0}
    errs = {}
    for name, b, h, hkv, sl, d, dt, causal, window, *layout in cases:
        q, k, v = _qkv(gen, b, h, hkv, sl, d, dt, model_layout=bool(layout))
        path = fa.route(dt, d)
        before = dict(fa.launch_counts)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        if fa.launch_counts["flash_attention_" + path] != \
                before["flash_attention_" + path] + 1:
            raise AssertionError(f"{name}: not launched on {path}")
        want = tref.attention_ref(q, k, v, causal=causal, window=window)
        errs[name] = _attn_check(got, want, dt, name, path)
        worst[path] = max(worst[path], errs[name])
        if name in fault_at:
            if path != fault_at[name]:
                raise AssertionError(f"{name} ran on {path}")
            _planted_fault(q, k, v, want, causal, window, name)
    # the long case against mha_chunked, kv heads repeated by hand
    q, k, v = _qkv(gen, 1, 32, 8, LONG_S, 64, bf16)
    got = fa.flash_attention(q, k, v)
    want = tref.mha_chunked(q, k.repeat_interleave(4, 1),
                            v.repeat_interleave(4, 1))
    path = fa.route(bf16, 64)
    worst[path] = max(worst[path], _attn_check(got, want, bf16,
                                               f"long S={LONG_S}", path))
    del want
    long_ms = cuda_ms(lambda: fa.flash_attention(q, k, v), reps=3)
    long_dev = kernel_device_ms(lambda: fa.flash_attention(q, k, v), reps=3)
    sdpa = sdpa_call(q, k, v)
    bound = attention_bound(1, 32, 8, LONG_S, 64, bf16, True, None)
    emit(phase="attention_long", s=LONG_S, route=fa.route(bf16, 64),
         ms=long_ms, device_ms=long_dev, library_ms=cuda_ms(sdpa, reps=3),
         library_device_ms=kernel_device_ms(sdpa, reps=3),
         bound_ms=bound[0], bound_by=bound[1])
    emit(phase="attention_vs_plain", ok=True, cases=len(cases) + 1,
         planted_faults=len(fault_at), max_abs_err=worst)
    return worst, errs


def sdpa_call(q, k, v, window=None, causal=True):
    """``scaled_dot_product_attention`` on the same inputs, causal or not
    (under a window: a boolean mask of the kept causal pairs): the
    yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    s = q.shape[2]
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None]
    mask = (kp <= qp) & (kp > qp - window)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def top_kernel(fn) -> str:
    """The name of the kernel that takes the most device time in a call
    of ``fn`` (which backend a library call took), from
    ``device_events``; "not measured" when it records none."""
    evs = device_events(fn, reps=5)
    if not evs:
        return "not measured"
    return max(evs, key=lambda e: e.self_device_time_total).key[:120]


def _attn_check(got, want, dtype, what, path) -> float:
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash_attention {what}: {got.shape} "
                             f"{got.dtype} vs {want.shape} {want.dtype}")
    g, w = got.float(), want.float()
    key = str(dtype).split(".")[-1]
    tol, rel_tol = ATTN_TOL[key], ATTN_REL_L2[key]
    diff = (g - w).abs()
    err = float(diff.max())
    rel = float((g - w).norm() / w.norm())
    emit(phase="attention_case", case=what, route=path, max_abs_err=err,
         tol=tol, rel_l2=rel, rel_l2_tol=rel_tol,
         worst_excess=float((diff - tol * w.abs()).max()))
    if not bool(torch.isfinite(g).all()) or rel > rel_tol or \
            not bool((diff <= tol + tol * w.abs()).all()):
        raise AssertionError(f"flash_attention != plain ({what}): max |Δ| "
                             f"{err} (tolerance {tol}), relative L2 {rel} "
                             f"(limit {rel_tol})")
    return err


def dropped_tile_attention(q, k, v, causal=True, window=None, scale=None):
    """A planted fault: the plain version with key tile 1 (keys 64-127)
    hidden from every query past it, as a kernel that skipped one tile
    would compute."""
    import torch
    from repro_torch.kernels import ref
    h, hkv, s, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    k, v = (t.repeat_interleave(h // hkv, 1) for t in (k, v))
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None]
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
    keep &= ~((kp >= 64) & (kp < 128) & (qp >= 128))
    scale = scale if scale is not None else d ** -0.5
    p = torch.softmax((q @ k.transpose(-1, -2)).float().mul(scale)
                      .masked_fill(~keep, -torch.inf), -1)
    return (p.to(v.dtype) @ v).to(q.dtype)


class ops_swapped:
    """Within the block the model's ``ops.<name>`` (``attention``,
    ``wkv6``, ``wkv6_train`` or ``rg_lru_scan``) is ``fn``: the plain
    version for a logit or gradient check, or a planted fault; never a
    path of the port."""

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = getattr(ops, self.name)
        setattr(ops, self.name, self.fn)

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        setattr(ops, self.name, self.saved)


def teacher_forced_logits(cfg, model, prompt, forced, extras=None):
    """The next-token logits after ``prompt`` and the ``forced`` tokens,
    batch 1 (``extras``: its frontend stubs, batch 1).  A MoE model takes the served path, a prefill of the prompt
    and a decode step a token: a forward over prompt + t tokens would
    group them as one prompt plus t remainder tokens, whose MoE output is
    their input (the reference's quirk).  The others take ``forward``."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    if "moe" not in lm.layer_kinds(cfg):
        prefix = np.concatenate([prompt, forced])[None]
        return lm.forward(cfg, model, torch.as_tensor(
            prefix, device=DEVICE), extras=extras)[0, -1].float()
    n = len(prompt)
    logits, cache = lm.prefill(cfg, model, torch.as_tensor(
        prompt[None], dtype=torch.long, device=DEVICE),
        cache_len=n + len(forced))
    for j, tok in enumerate(forced):
        logits, cache = lm.decode_step(cfg, model, cache, torch.tensor(
            [int(tok)], device=DEVICE), n + j)
    return logits[0].float()


def check_tokens(cfg, model, prompts, static, reqs, stubs=None):
    """Requests that shared a wave with the static batch must give its
    tokens; a flip passes only where the two candidates' logits tie
    within FLIP_TOL (``teacher_forced_logits`` of the common prefix, with
    the request's own frontend stubs, row i of ``stubs``)."""
    import numpy as np
    flips = []
    prompt_len = prompts.shape[1]
    for i, r in enumerate(reqs[:PROMPTS]):
        want = static[i, prompt_len:].tolist()
        if len(r.generated) != NEW_TOKENS:
            raise AssertionError(f"request {i}: {len(r.generated)} tokens")
        if r.generated == want:
            continue
        t = next(j for j, (a, b) in enumerate(zip(r.generated, want))
                 if a != b)
        logits = teacher_forced_logits(
            cfg, model, prompts[i], np.asarray(want[:t], np.int64),
            None if stubs is None else rows(stubs, i, i + 1))
        gap = float((logits[want[t]] - logits[r.generated[t]]).abs())
        flips.append({"request": i, "at": t, "gap": gap})
        if gap > FLIP_TOL:
            raise AssertionError(f"request {i} flips at token {t} with a "
                                 f"logit gap of {gap} > {FLIP_TOL}")
    for r in reqs[PROMPTS:]:
        if not r.done or len(r.generated) != NEW_TOKENS or \
                min(r.generated) < 0 or max(r.generated) >= cfg.vocab_size:
            raise AssertionError(f"request {r.rid} is malformed")
    return flips


def rows(stubs, lo, hi):
    """Rows lo .. hi - 1 of every frontend stub in ``stubs``."""
    return {k: v[lo:hi] for k, v in stubs.items()}


def free_device_bytes() -> int:
    import torch
    return torch.cuda.mem_get_info()[0]


def upcast(cfg, model):
    """(config, model) with the weights in f32 on the card, for the logit
    gate: every layer where the f32 copy fits beside the served model
    with UPCAST_HEADROOM_GB left for a prefill, else the first whole
    superblocks that do, two at least (a key tile dropped in the first
    local layer reaches the last token's logits only through a second
    one); the cut is printed."""
    import copy
    import dataclasses
    import gc
    import torch
    from torch import nn
    gc.collect()
    torch.cuda.empty_cache()
    budget = free_device_bytes() - UPCAST_HEADROOM_GB * 1e9
    per_layer = [4 * sum(p.numel() for p in b.parameters())
                 for b in model.blocks]
    top = 4 * sum(p.numel() for n, p in model.named_parameters()
                  if not n.startswith("blocks."))
    keep = cfg.num_layers
    step = len(cfg.block_pattern)
    while keep > 2 * step and top + sum(per_layer[:keep]) > budget:
        keep = (keep - 1) // step * step
    emit(phase="upcast", arch=cfg.name, layers=keep,
         cut_from=cfg.num_layers if keep < cfg.num_layers else None,
         f32_gb=(top + sum(per_layer[:keep])) / 1e9, budget_gb=budget / 1e9)
    blocks = model.blocks
    model.blocks = nn.ModuleList(list(blocks)[:keep])
    try:
        m32 = copy.deepcopy(model).float()
    finally:
        model.blocks = blocks
    return dataclasses.replace(cfg, num_layers=keep), m32


def check_prefill_logits(cfg, model, toks, phase="lm_logits"):
    """One wave's prefill logits with the kernel against the same model
    with mha_ref called explicitly: the served bf16 model, and its
    weights upcast to f32 (``upcast``).  Beside each: the plain path on
    the first two prompts alone (another batch size, so other matmul
    kernels), and a dropped key tile in every layer, which must read
    above the f32 gate; then the bf16 model's own distance from its f32
    upcast.  Returns, by dtype, the layers run and the flash launches of
    the kernel's prefill (the counts set to 0 just before it and read
    just after): the f32 wave is the f32 route's main path."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    cache_len = toks.shape[1]
    cfg32, m32 = upcast(cfg, model)
    plain, routes = {}, {}
    for dt, c, m in (("bfloat16", cfg, model), ("float32", cfg32, m32)):
        fa.reset_launch_counts()
        got, _ = lm.prefill(c, m, toks, cache_len=cache_len)
        torch.cuda.synchronize()
        routes[dt] = {"layers": c.num_layers, **fa.launch_counts}
        with ops_swapped("attention", ref.attention_ref):
            want, _ = lm.prefill(c, m, toks, cache_len=cache_len)
            half, _ = lm.prefill(c, m, toks[:2], cache_len=cache_len)
        with ops_swapped("attention", dropped_tile_attention):
            bad, _ = lm.prefill(c, m, toks, cache_len=cache_len)
        plain[dt] = want
        err = rel(got, want)
        finite = bool(torch.isfinite(got).all())
        emit(phase=phase, dtype=dt, layers=c.num_layers, rel_l2=err,
             tol=LOGIT_REL_TOL[dt], batch2_rel_l2=rel(half, want[:2]),
             dropped_tile_rel_l2=rel(bad, want),
             max_abs=float((got.float() - want.float()).abs().max()),
             max_ref=float(want.float().abs().max()),
             top1_agree=float((got.argmax(-1) == want.argmax(-1))
                              .float().mean()), finite=finite)
        if not finite or err > LOGIT_REL_TOL[dt] or (
                dt == "float32" and rel(bad, want) <= LOGIT_REL_TOL[dt]):
            raise AssertionError(f"{dt} prefill logits off mha_ref: {err}; "
                                 f"a dropped key tile: {rel(bad, want)}")
    if cfg32.num_layers == cfg.num_layers:
        emit(phase=phase + "_bf16_vs_f32",
             rel_l2=rel(plain["bfloat16"], plain["float32"]))
    del m32
    torch.cuda.empty_cache()
    return routes


def decode_idle_share(cfg, model, cache, tok, pos, phase):
    """Device busy time over a few decode steps under torch.profiler,
    after one unrecorded pass over the same steps, against the steps' wall
    (the profiler adds host time, so the idle share is an upper
    bound)."""
    from repro_torch.models import lm

    def steps():
        # the same positions each call: a warm-up call writes the cache
        # slots the recorded one writes again
        t = tok
        for i in range(DECODE_PROFILE_STEPS):
            logits, _ = lm.decode_step(cfg, model, cache, t, pos + i)
            t = logits.argmax(-1)

    wall, events = profiled(steps, warmup=1)
    busy, top = device_busy(events)
    launches = sum(e.count for e in events if "LaunchKernel" in e.key)
    rec = dict(steps=DECODE_PROFILE_STEPS, wall_s=wall,
               kernel_launches_per_step=launches / DECODE_PROFILE_STEPS,
               device_busy_s=busy if busy > 0 else "not measured",
               idle_share=1 - busy / wall if busy > 0 else "not measured",
               top=top)
    emit(phase=phase, **rec)
    return rec


def serve_traffic(cfg, model, counts, reset, phase, prompt_len=PROMPT_LEN,
                  cache_len=None, stubs=None):
    """The main path of a serving slice: ``generate`` on PROMPTS prompts
    of ``prompt_len`` random tokens with NEW_TOKENS new ones, then
    SERVE_REQUESTS such requests through SERVE_SLOTS ``ServeLoop`` slots
    (``cache_len``, by default prompt_len + NEW_TOKENS).  ``stubs``: the
    frontend stubs of a vision or audio model, one row a request (the
    static batch takes the first PROMPTS, each ServeLoop wave the next
    rows in the order it admits them).  The kernel counts are set to 0
    just before and read just after.  Checks the static batch's shape and
    the first wave's tokens; returns (prompts, launches, prefills, decode
    steps)."""
    import numpy as np
    import torch
    from repro_torch.serve import engine as serve
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size,
                           (SERVE_REQUESTS, prompt_len)).astype(np.int32)
    fed = [0]

    def extras_fn(n):
        fed[0] += n
        return rows(stubs, fed[0] - n, fed[0])

    reset()  # the main path starts here
    t0 = time.perf_counter()
    static = serve.generate(
        cfg, model, prompts[:PROMPTS], NEW_TOKENS,
        extras=None if stubs is None else rows(stubs, 0, PROMPTS))
    static_wall = time.perf_counter() - t0
    sl = serve.ServeLoop(cfg, model, num_slots=SERVE_SLOTS,
                         cache_len=cache_len or prompt_len + NEW_TOKENS,
                         extras_fn=None if stubs is None else extras_fn)
    reqs = [serve.Request(rid=i, prompt=prompts[i], max_new=NEW_TOKENS)
            for i in range(SERVE_REQUESTS)]
    for r in reqs:
        sl.submit(r)
    t0 = time.perf_counter()
    steps = sl.run()
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    launches = dict(counts)  # the main path ends here
    prefills = 1 + -(-SERVE_REQUESTS // SERVE_SLOTS)
    decode_steps = NEW_TOKENS - 1 + steps
    emit(phase=phase, static_wall_s=static_wall,
         serve_loop_wall_s=loop_wall, serve_loop_steps=steps,
         prefills=prefills, decode_steps=decode_steps, **launches)
    if static.shape != (PROMPTS, prompt_len + NEW_TOKENS) or \
            not (static[:, :prompt_len] == prompts[:PROMPTS]).all():
        raise AssertionError(f"generate returned {static.shape}")
    if stubs is not None and fed[0] != SERVE_REQUESTS:
        raise AssertionError(f"ServeLoop took {fed[0]} stubs for "
                             f"{SERVE_REQUESTS} requests")
    flips = check_tokens(cfg, model, prompts, static, reqs, stubs)
    emit(phase=phase + "_tokens", ok=True, flips=len(flips),
         flip_detail=flips, requests=len(reqs))
    return prompts, launches, prefills, decode_steps


def device_split(events, split, carve=None):
    """Device ms and launches of each group of kernels whose name holds
    one of the group's words (any case), and of the rest.  ``carve``:
    (name, us) of kernels that form a group of their own,
    ``plain_attention`` (``marked_kernels``), taken out of the groups
    their names give them."""
    from torch.autograd import DeviceType

    def group(key):
        key = key.lower()
        return next((n for n, words in split.items()
                     if any(w in key for w in words)), "rest")

    names = [*split, "rest"] + (["plain_attention"] if carve is not None
                                else [])
    out = {name: {"ms": 0.0, "launches": 0} for name in names}
    for e in events:
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        name = group(e.key)
        out[name]["ms"] += e.self_device_time_total / 1e3
        out[name]["launches"] += e.count
    for key, us in carve or ():
        for name, sign in ((group(key), -1), ("plain_attention", 1)):
            out[name]["ms"] += sign * us / 1e3
            out[name]["launches"] += sign
    return out


# a prefill's device time by kernel: cuBLAS's GEMMs, the flash and WKV6
# kernels, the RG-LRU time loop (one addcmul a step) and the rest
PREFILL_SPLIT = {"gemm": ("gemm", "nvjet", "xmma", "cutlass"),
                 "flash": ("flash_attention",), "wkv6": ("wkv6",),
                 "rg_lru_loop": ("addcmul",)}


class first_layers:
    """Within the block ``model.blocks`` holds only its first ``n``
    layers (all of them when ``n`` is None): a profiled prefill over
    fewer layers, whose logits are not used."""

    def __init__(self, model, n):
        self.model, self.n = model, n

    def __enter__(self):
        from torch import nn
        self.saved = self.model.blocks
        if self.n is not None:
            self.model.blocks = nn.ModuleList(list(self.saved)[:self.n])

    def __exit__(self, *exc):
        self.model.blocks = self.saved


def serving_metrics(cfg, model, toks, counts, phase, split=None,
                    extras=None, profile_layers=None):
    """Prefill tokens/s, TTFT, decode ms/step and tokens/s, the kernel's
    launches per decode step, and the device idle share over a few decode
    steps (host clock, synchronised).  TTFT: the prefill of the wave and
    its first tokens on the host, which every request of the wave waits
    for.  The profiled prefill's device time and launches by kernel
    group (``device_split`` by ``split``, by default PREFILL_SPLIT); with
    ``extras`` (the wave's frontend stubs) the kernels of the plain
    attention (the cross calls) form a group of their own,
    ``plain_attention``.  ``profile_layers``: the profiled prefill runs
    the first that many layers only (printed as ``profiled_layers``);
    the timed prefills run them all."""
    import contextlib
    import torch
    from repro_torch.models import lm
    prompts, prompt_len = toks.shape
    cache_len = prompt_len + NEW_TOKENS
    marked = plain_attention_marked if extras is not None else \
        contextlib.nullcontext
    with marked(), first_layers(model, profile_layers):
        wall, events, tree = profiled(
            lambda: lm.prefill(cfg, model, toks, cache_len=cache_len,
                               extras=extras), warmup=1, tree=True)
    busy, top = device_busy(events)
    emit(phase=phase + "_prefill_profile", wall_s=wall,
         profiled_layers=profile_layers or len(model.blocks),
         device_busy_s=busy if busy > 0 else "not measured",
         idle_share=1 - busy / wall if busy > 0 else "not measured",
         top=top, split=device_split(
             events, split or PREFILL_SPLIT,
             carve=marked_kernels(tree, PLAIN_ATTENTION)
             if extras is not None else None))
    prefill_s, ttft_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cfg, model, toks, cache_len=cache_len,
                                   extras=extras)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = logits.argmax(-1)
        tok.cpu()
        prefill_s.append(t1 - t0)
        ttft_s.append(time.perf_counter() - t0)
    steps_t = []
    pos = prompt_len
    before = dict(counts)
    for i in range(NEW_TOKENS - 1 - DECODE_PROFILE_STEPS):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(cfg, model, cache, tok, pos + i)
        tok = logits.argmax(-1)
        tok.cpu()  # the host reads every token, as generate does
        steps_t.append(time.perf_counter() - t0)
    per_step = {k: (counts[k] - before[k]) / len(steps_t) for k in counts}
    step_ms = statistics.median(steps_t) * 1e3
    prof = decode_idle_share(cfg, model, cache, tok, pos + len(steps_t),
                             phase + "_decode_profile")
    rec = dict(
        prefill_tokens_per_s=prompts * prompt_len / statistics.median(
            prefill_s),
        prefill_s=statistics.median(prefill_s),
        ttft_s=statistics.median(ttft_s),
        decode_ms_per_step=step_ms,
        decode_tokens_per_s=prompts / step_ms * 1e3,
        kernel_launches_per_decode_step=per_step,
        decode_idle_share=prof["idle_share"], batch=prompts,
        prompt_len=prompt_len, peak_gb=torch.cuda.max_memory_allocated()
        / 1e9)
    emit(phase=phase, **rec)
    return rec


def lm_path():
    """Serve granite-3-2b at full width: static generate and ServeLoop
    with every prefill through the kernel, then the serving metrics."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    cfg = get_config(LM_ARCH)
    if LM_REDUCED:
        cfg = cfg.reduced()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                    device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase="lm_init", arch=cfg.name, params=n_params,
         weight_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
         seconds=time.perf_counter() - t0)

    prompts, launches, prefills, _ = serve_traffic(
        cfg, model, fa.launch_counts, fa.reset_launch_counts, "lm_main_path")
    path = fa.route(getattr(torch, cfg.compute_dtype), cfg.head_dim)
    for key in ("flash_attention", "flash_attention_" + path):
        if launches[key] != cfg.num_layers * prefills:
            raise AssertionError(
                f"{key} launched {launches[key]} times, expected "
                f"{cfg.num_layers} x {prefills} prefills")

    toks = torch.as_tensor(prompts[:PROMPTS], dtype=torch.long,
                           device=DEVICE)
    check_prefill_logits(cfg, model, toks)
    rec = serving_metrics(cfg, model, toks, fa.launch_counts, "lm_serving")
    return launches, rec


def time_attention_case(gen, what, b, h, hkv, s, d, dt, window=None,
                        causal=True):
    """One kernel at one shape (causal unless ``causal`` is False): its
    call time (CUDA events around a call, median of 20), its device time
    (the profiler), its bound (the kept pairs under the mask), the plain
    version's time and SDPA's call and device times (the yardstick, never
    called by the port) with the kernel SDPA ran.  Emits and returns the
    row."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as tref
    q, k, v = _qkv(gen, b, h, hkv, s, d, dt)
    kernel = lambda: fa.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window)
    sdpa = sdpa_call(q, k, v, window, causal)
    ms = cuda_ms(kernel, reps=20)
    device_ms = kernel_device_ms(kernel)
    plain = cuda_ms(lambda: tref.attention_ref(q, k, v, causal=causal,
                                               window=window), reps=5)
    lib = cuda_ms(sdpa, reps=20)
    lib_device = kernel_device_ms(sdpa)
    measured = isinstance(device_ms, float) and isinstance(lib_device, float)
    torch.cuda.synchronize()
    sdpa_err = float((sdpa().float() - kernel().float()).abs().max())
    bound_ms, bound_by, n_ops, n_bytes = attention_bound(
        b, h, hkv, s, d, dt, causal, window)
    row = dict(ms=ms, device_ms=device_ms, plain_ms=plain, library_ms=lib,
               library_device_ms=lib_device, bound_ms=bound_ms,
               bound_by=bound_by)
    emit(phase="time", kernel="flash_attention", case=what,
         route=fa.route(dt, d), shape=[b, h, hkv, s, d],
         dtype=str(dt).split(".")[-1], window=window, causal=causal,
         sdpa_max_abs_diff=sdpa_err, sdpa_kernel=top_kernel(sdpa),
         flops=n_ops, bytes=n_bytes,
         tflops=n_ops / device_ms / 1e9 if measured else "not measured",
         device_vs_library=device_ms / lib_device if measured
         else "not measured", **row)
    return row


def time_attention(gen, errs_max, launches):
    """The kernels at the two prefill shapes, bf16 on the tensor cores:
    granite-3-2b (B 4, H 32, Hkv 8, S 1024, D 64) and a chatglm3-like one
    (Hkv 2, D 128); then the f32 route (CUDA cores) at granite's.  Returns
    the kernels line entry, at granite's shape."""
    import torch
    rows = {}
    for what, hkv, d, dt in (("granite", 8, 64, torch.bfloat16),
                             ("chatglm3-like", 2, 128, torch.bfloat16),
                             ("granite f32", 8, 64, torch.float32)):
        rows[what] = time_attention_case(gen, what, PROMPTS, 32, hkv,
                                         PROMPT_LEN, d, dt)
    return {"name": "flash_attention", "path": "tensor_cores",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:121",
            "launches": launches["flash_attention"],
            "max_abs_err": errs_max, **rows["granite"]}


# -- RWKV-6 serving: the WKV6 kernel and rwkv6-1.6b -------------------------

RWKV_ARCH = "rwkv6-1.6b"
WKV_HEADS, WKV_HS = 32, 64  # rwkv6-1.6b: d_model 2048 / head size 64
# kernel vs plain.  y: |Δ| <= tol·(|plain| + rms(plain)) elementwise (the
# rms term: y sums hs products, and an output near 0 keeps its terms'
# rounding), and ‖Δ‖₂/‖plain‖₂ <= rel; the final state (f32 in both
# dtypes) is held to the f32 limits.  The plain version repeats the
# kernel's order of operations (-fmad=false there), so both read 0; the
# limits are those of a sum over i in another order, which is what a
# kernel that reordered it would show: in f32 about 1.6e-7 relative L2,
# in bf16 one output in a few thousand a bf16 step away (2.7e-5).
WKV_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
WKV_REL_L2 = {"bfloat16": 1e-2, "float32": 1e-5}
# prefill logits, kernel vs the plain WKV6 over one wave, relative L2.
# The plain version repeats the kernel's order, so a right kernel reads
# 0.  Each limit must also pass a right kernel that sums y in another
# order (torch.einsum) and fail one that drops u in every layer: the
# script reads both and fails if either is on the wrong side.  f32 is
# the gate; bf16 is looser, since a bf16 step of y travels 24 layers.
# Read at full width on an H100 80GB HBM3 at 700 W: the other order
# 3.6e-6 (f32) and 3.5e-2 (bf16), a dropped u 0.27 in both.
RWKV_LOGIT_REL_TOL = {"bfloat16": 1e-1, "float32": 1e-4}


def wkv6_ops(b, t, h, hs, path):
    """The operations one call needs in the form ``path`` computes.

    recurrent: per step and head 5·hs² + 5·hs: r·S (2·hs²) and S ← w·S +
    kᵀv (3·hs²), and the u term folded into one dot product, y_j += v_j ·
    Σ_i r_i u_i k_i (3·hs, then 2·hs).  chunked: per sub-chunk of 16
    steps and head, (r E) S and (k F)ᵀ V (2·16·hs² each), A V over A's
    lower triangle (16·17·hs) and A's 136 entries (2·hs each), without
    the kernel's split products (the function needs one)."""
    if path == "recurrent":
        return (5 * hs * hs + 5 * hs) * b * h * t
    sub = 16
    per_sub = 4 * sub * hs * hs + sub * (sub + 1) * hs \
        + sub * (sub + 1) // 2 * 2 * hs
    return per_sub * b * h * -(-t // sub)


def wkv6_bound(b, t, h, hs, elem, path):
    """Least time for one call: r, k, v, w read, y written, u read and the
    f32 state read and written once at 3.35 TB/s, or the operations
    (``wkv6_ops``) at the peak of the units that route's kernel computes
    on, whichever is larger: the f32 CUDA cores for the recurrent kernel,
    the bf16 tensor cores for the chunked one."""
    n_ops = wkv6_ops(b, t, h, hs, path)
    n_bytes = 5 * b * t * h * hs * elem + 2 * b * h * hs * hs * 4 \
        + h * hs * 4
    peak = F32_PEAK_FLOPS if path == "recurrent" else BF16_PEAK_FLOPS
    t_ops, t_bytes = n_ops / peak, n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", n_ops, n_bytes)


def wkv6_inputs(gen, b, t, h, hs, dtype, model_like=True):
    """r, k, v ~ N(0, 1); w the decays of the model's init range,
    exp(-exp(U(-6, -1))) from 0.9975 down to 0.69 (model_like), or U(0.4,
    0.9) as tests/test_wkv6_kernel.py; u ~ N(0, 0.25), one row per head;
    s0 ~ N(0, 0.01), f32.  All made on the card from ``gen``."""
    import torch
    r, k, v = (torch.randn((b, t, h, hs), generator=gen, device=DEVICE)
               for _ in range(3))
    w = torch.rand((b, t, h, hs), generator=gen, device=DEVICE)
    w = torch.exp(-torch.exp(w * 5 - 6)) if model_like else w * 0.5 + 0.4
    u = torch.randn((h, hs), generator=gen, device=DEVICE) * 0.5
    s0 = torch.randn((b, h, hs, hs), generator=gen, device=DEVICE) * 0.1
    return [x.to(dtype) for x in (r, k, v, w)] + [u.to(dtype), s0]


def _wkv_check(got, want, dtype, what, part, key=None) -> float:
    """Hold one output (y or the state) of the kernel against the plain
    version's; returns max |Δ|.  The limits are ``key``'s, by default
    the dtype's for y and f32's for the state."""
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"wkv6 {what} {part}: {got.shape} {got.dtype}"
                             f" vs {want.shape} {want.dtype}")
    g, w = got.float(), want.float()
    if key is None:
        key = "float32" if part == "state" else str(dtype).split(".")[-1]
    tol, rel_tol = WKV_TOL[key], WKV_REL_L2[key]
    diff = (g - w).abs()
    rms = float(w.square().mean().sqrt())
    err = float(diff.max())
    rel = float((g - w).norm() / w.norm())
    emit(phase="wkv6_case", case=what, part=part, max_abs_err=err, tol=tol,
         rel_l2=rel, rel_l2_tol=rel_tol, rms=rms,
         worst_excess=float((diff - tol * (w.abs() + rms)).max()))
    if not bool(torch.isfinite(g).all()) or rel > rel_tol or \
            not bool((diff <= tol * (w.abs() + rms)).all()):
        raise AssertionError(f"wkv6 != plain ({what}, {part}): max |Δ| "
                             f"{err} (tolerance {tol}), relative L2 {rel} "
                             f"(limit {rel_tol})")
    return err


def _must_fail(got, want, dtype, what, part, key=None):
    try:
        _wkv_check(got, want, dtype, "planted fault: " + what, part, key)
    except AssertionError:
        return
    raise AssertionError(f"a planted fault ({what}) passed the wkv6 "
                         f"limits on {part}")


def wkv6_vs_plain(gen):
    """The WKV6 kernel against its plain version: the four shapes of
    tests/test_wkv6_kernel.py (JAX layout, one u), the rwkv6-1.6b prefill
    shape in bf16 and f32 with per-head u and a nonzero s0, and a decode
    step (T = 1) in place.  Two planted faults must fail: u dropped (y)
    and the last step's decay skipped (the state).  Returns the largest
    |kernel − plain|."""
    import torch
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import wkv6 as twkv
    worst = 0.0
    for bh, t, hs in ((4, 128, 16), (2, 64, 32), (3, 96, 8), (1, 200, 16)):
        r, k, v, w, u, s0 = wkv6_inputs(gen, 1, t, bh, hs, torch.float32,
                                        model_like=False)
        args = [x[0].transpose(0, 1).contiguous() for x in (r, k, v, w)]
        args += [u[0], s0[0]]
        y, s = twkv.wkv6(*args)
        want_y, want_s = tref.wkv6_ref(*args)
        what = f"jax layout BH {bh} T {t} hs {hs} f32"
        worst = max(worst, _wkv_check(y, want_y, torch.float32, what, "y"),
                    _wkv_check(s, want_s, torch.float32, what, "state"))
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v, w, u, s0 = wkv6_inputs(gen, PROMPTS, PROMPT_LEN, WKV_HEADS,
                                        WKV_HS, dtype)
        state = s0.clone()
        # the route sends the bf16 prefill to the chunked kernel: the
        # recurrent one is held here through the module's launcher
        y = twkv._launch(r, k, v, w, u, state, state, path="recurrent")
        want_y, want_s = tref.wkv6_heads_ref(r, k, v, w, u, s0)
        what = f"rwkv6 prefill B {PROMPTS} T {PROMPT_LEN} H {WKV_HEADS} " \
            f"hs {WKV_HS} {str(dtype)[6:]} recurrent"
        worst = max(worst, _wkv_check(y, want_y, dtype, what, "y"),
                    _wkv_check(state, want_s, dtype, what, "state"))
        if dtype == torch.bfloat16:
            no_u, _ = tref.wkv6_heads_ref(r, k, v, w, torch.zeros_like(u),
                                          s0)
            _must_fail(no_u, want_y, dtype, "u dropped", "y")
            w_skip = w.clone()
            w_skip[:, -1] = 1.0
            _, skip_s = tref.wkv6_heads_ref(r, k, v, w_skip, u, s0)
            _must_fail(skip_s, want_s, dtype, "last decay skipped", "state")
        # one decode step from the prefill's state, in place
        r1, k1, v1, w1, _, _ = wkv6_inputs(gen, PROMPTS, 1, WKV_HEADS,
                                           WKV_HS, dtype)
        before = state.clone()
        y1 = twkv.wkv6_heads(r1, k1, v1, w1, u, state)
        want_y1, want_s1 = tref.wkv6_heads_ref(r1, k1, v1, w1, u, before)
        what = f"rwkv6 decode T 1 in place {str(dtype)[6:]}"
        worst = max(worst, _wkv_check(y1, want_y1, dtype, what, "y"),
                    _wkv_check(state, want_s1, dtype, what, "state"))
    emit(phase="wkv6_vs_plain", ok=True, cases=8, max_abs_err=worst)
    return worst


def _one_bf16_step(got, want, what, part) -> float:
    """Chunked kernel against its plain version, y: every element within
    one bf16 step of max(|plain|, rms(plain) / 32), since the two round to
    bf16 f32 sums that differ only in the order inside the matrix
    products (the rms term: an output that cancels to near 0 keeps its
    terms' rounding).  Returns max |Δ|."""
    import torch
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    step = 2.0 ** -7 * torch.clamp(w.abs(), min=rms / 32)
    diff = (g - w).abs()
    err = float(diff.max())
    emit(phase="wkv6_chunked_case", case=what, part=part, vs="chunked plain",
         max_abs_err=err, worst_in_bf16_steps=float((diff / step).max()))
    if got.dtype != want.dtype or not bool((diff <= step).all()):
        raise AssertionError(f"wkv6 chunked != its plain version ({what}, "
                             f"{part}): max |Δ| {err}")
    return err


def _state_rel(got, want, what) -> None:
    """Chunked kernel's state against its plain version: relative L2
    within 1e-5 (f32 sums in another order)."""
    import torch
    torch.cuda.synchronize()
    rel = float((got - want).norm() / want.norm())
    emit(phase="wkv6_chunked_case", case=what, part="state",
         vs="chunked plain", rel_l2=rel, rel_l2_tol=1e-5)
    if not rel <= 1e-5:
        raise AssertionError(f"wkv6 chunked state != its plain version "
                             f"({what}): relative L2 {rel}")


def _diag_reads_c_i(r, k, w, u):
    """A planted fault: ``ref.wkv6_diag_block`` with the diagonal blocks
    decayed by e^{c_i − c_j}, one w too many."""
    sub = r.shape[-2]
    a = r.new_zeros(r.shape[:-1] + (sub,))
    kd = k.clone()
    for i in range(sub):
        kd[..., :i, :] *= w[..., i, None, :]
        a[..., i, :i] = (r[..., i, None, :] * kd[..., :i, :]).sum(-1)
        a[..., i, i] = (r[..., i, :] * u * k[..., i, :]).sum(-1)
    return a


def wkv6_chunked_vs_plain(gen):
    """The chunked WKV6 kernel (bf16, hs 64, T >= 128) against both plain
    versions: (a) ``wkv6_chunked_heads_ref``, its own algebra and
    blocking: y within one bf16 step, the state within 1e-5 relative L2;
    (b) the recurrent ``wkv6_heads_ref``: y and the state within the
    bf16 limits, WKV_TOL and WKV_REL_L2["bfloat16"].  The state is held
    to bf16's limits here, not f32's: the kernel rounds its operands to
    bf16 (a high part and a remainder) before the products.  Cases: the
    rwkv6 prefill shape with model-like decays and a nonzero s0; extreme
    decays (w from 1e-6 to 1, one in 16 set to 0); ragged T 777; T 128,
    the route's threshold; r, k, v, w as strided slices of one buffer;
    the state carried in place, then one decode step on the recurrent
    kernel.  Three planted faults in the chunked plain version must fail
    (b): u dropped (y), the last decay skipped (the state), the diagonal
    blocks decayed by e^{c_i − c_j} (y).  Two calls give the same bits.
    Returns the largest |kernel − chunked plain| over y."""
    import torch
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import wkv6 as twkv
    bf16 = torch.bfloat16
    worst = 0.0

    def both(args, state, y, what):
        r, k, v, w, u, s0 = args
        if twkv.route(r.dtype, r.shape[1], r.shape[3]) != "chunked":
            raise AssertionError(f"{what}: not on the chunked route")
        cy, cs = tref.wkv6_chunked_heads_ref(r, k, v, w, u, s0)
        err = _one_bf16_step(y, cy, what, "y")
        _state_rel(state, cs, what)
        del cy, cs
        ry, rs = tref.wkv6_heads_ref(r, k, v, w, u, s0)
        _wkv_check(y, ry, bf16, what + " vs recurrent plain", "y")
        _wkv_check(state, rs, bf16, what + " vs recurrent plain", "state",
                   key="bfloat16")
        return err

    def run(args):
        state = args[5].clone()
        before = dict(twkv.launch_counts)
        y = twkv.wkv6_heads(*args[:5], state)
        if twkv.launch_counts["wkv6_chunked"] != \
                before["wkv6_chunked"] + 1:
            raise AssertionError("the chunked kernel did not launch")
        return y, state

    prefill = wkv6_inputs(gen, PROMPTS, PROMPT_LEN, WKV_HEADS, WKV_HS, bf16)
    y, state = run(prefill)
    worst = max(worst, both(prefill, state, y, "rwkv6 prefill"))
    y2, state2 = run(prefill)
    if not (torch.equal(y, y2) and torch.equal(state, state2)):
        raise AssertionError("wkv6 chunked: two calls gave other bits")
    emit(phase="wkv6_chunked_deterministic", ok=True)
    del y2, state2

    # the planted faults, against the recurrence on the prefill case
    r, k, v, w, u, s0 = prefill
    ry, rs = tref.wkv6_heads_ref(r, k, v, w, u, s0)
    no_u, _ = tref.wkv6_chunked_heads_ref(r, k, v, w, torch.zeros_like(u),
                                          s0)
    _must_fail(no_u, ry, bf16, "chunked, u dropped", "y")
    w_skip = w.clone()
    w_skip[:, -1] = 1.0
    _, skip_s = tref.wkv6_chunked_heads_ref(r, k, v, w_skip, u, s0)
    _must_fail(skip_s, rs, bf16, "chunked, last decay skipped", "state",
               key="bfloat16")
    saved = tref.wkv6_diag_block
    tref.wkv6_diag_block = _diag_reads_c_i
    try:
        diag_y, _ = tref.wkv6_chunked_heads_ref(r, k, v, w, u, s0)
    finally:
        tref.wkv6_diag_block = saved
    _must_fail(diag_y, ry, bf16, "chunked, diagonal reads c_i", "y")
    del prefill, ry, rs, no_u, skip_s, diag_y, w_skip

    extreme = wkv6_inputs(gen, 2, 512, 8, WKV_HS, bf16)
    x = torch.rand(extreme[3].shape, generator=gen, device=DEVICE)
    zero = torch.rand(extreme[3].shape, generator=gen, device=DEVICE) < 1 / 16
    extreme[3] = torch.where(zero, 0.0, 10 ** (-6 * x)).to(bf16)
    for what, args in (
            ("extreme decays", extreme),
            ("ragged T 777", wkv6_inputs(gen, 2, 777, 8, WKV_HS, bf16)),
            ("T 128", wkv6_inputs(gen, PROMPTS, 128, WKV_HEADS, WKV_HS,
                                  bf16))):
        y, state = run(args)
        worst = max(worst, both(args, state, y, what))

    # strided slices of one (B, T, 4, H, hs) buffer, in the model's layout
    b, t, h = 2, 300, 8
    r, k, v, w, u, s0 = wkv6_inputs(gen, b, t, h, WKV_HS, bf16)
    buf = torch.stack([r, k, v, w], 2)
    args = [buf[:, :, i] for i in range(4)] + [u, s0]
    y, state = run(args)
    worst = max(worst, both(args, state, y, "strided slices"))

    # the state carried in place, then one decode step (recurrent kernel)
    r1, k1, v1, w1, _, _ = wkv6_inputs(gen, b, 1, h, WKV_HS, bf16)
    before = state.clone()
    n_rec = twkv.launch_counts["wkv6_recurrent"]
    y1 = twkv.wkv6_heads(r1, k1, v1, w1, args[4], state)
    if twkv.launch_counts["wkv6_recurrent"] != n_rec + 1:
        raise AssertionError("the decode step did not take the recurrent "
                             "kernel")
    want_y1, want_s1 = tref.wkv6_heads_ref(r1, k1, v1, w1, args[4], before)
    what = "decode step after a chunked prefill, in place"
    _wkv_check(y1, want_y1, bf16, what, "y")
    _wkv_check(state, want_s1, bf16, what, "state")
    emit(phase="wkv6_chunked_vs_plain", ok=True, cases=6, faults=3,
         max_abs_err=worst)
    return worst


RWKV_OUT_SCALE = 0.2  # wo and cv, from lm.init's 1/sqrt(fan-in)


def rwkv_weights(cfg, model, seed=0):
    """Make the random rwkv6 a fair test of its kernel.  The constant
    leaves are drawn around their init values, so that u and the five
    ddlerp rows all matter: mu, mu_c ~ U(0, 1); w0 ~ U(-6, -1) (decays
    0.9975 down to 0.69); u ~ N(0, 1); ln_x ~ U(0.5, 1.5).  Two kinds of
    matrix are scaled: the embedding to rows of unit rms (the scale that
    RWKV's LayerNorm after the embedding gives them) and each layer's
    output projections wo and cv by RWKV_OUT_SCALE (RWKV-6's own init
    starts both at zero).  At lm.init's scales the 24 random layers
    amplify rounding: y summed in another order moved the f32 logits by
    5.24e-4 and the bf16 ones by 0.459, and the bf16 model was 0.897 from
    its own f32 upcast, so no limit told a right kernel from a wrong
    one."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        model.embed.mul_(cfg.d_model ** 0.5)
        for blk in model.blocks:
            p = blk.rwkv
            p.mu.uniform_(0.0, 1.0, generator=gen)
            p.mu_c.uniform_(0.0, 1.0, generator=gen)
            p.w0.uniform_(-6.0, -1.0, generator=gen)
            p.u.normal_(0.0, 1.0, generator=gen)
            p.ln_x.uniform_(0.5, 1.5, generator=gen)
            p.wo.mul_(RWKV_OUT_SCALE)
            p.cv.mul_(RWKV_OUT_SCALE)


def _plain_wkv6(r, k, v, w, u, state):
    from repro_torch.kernels import ref
    y, s = ref.wkv6_heads_ref(r, k, v, w, u, state)
    state.copy_(s)
    return y


def _no_u_wkv6(r, k, v, w, u, state):
    """A planted fault: the kernel with u dropped."""
    import torch
    from repro_torch.kernels import wkv6 as twkv
    return twkv.wkv6_heads(r, k, v, w, torch.zeros_like(u), state)


def _einsum_order_wkv6(r, k, v, w, u, state):
    """The recurrence with y summed by ``torch.einsum``, in cuBLAS's order
    (as the JAX package's references sum it in XLA's): what a right
    kernel that sums in another order would give, which the logit limit
    must pass."""
    import torch
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state.clone()
    ys = []
    for t in range(r.shape[1]):
        a = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * a))
        s = wf[:, t, :, :, None] * s + a
    state.copy_(s)
    return torch.stack(ys, dim=1).to(r.dtype)


def check_rwkv_logits(cfg, model, toks):
    """One wave's prefill logits with the kernel against the same model
    with the plain WKV6: the served bf16 model, and its weights upcast to
    f32.  Beside each, y summed in another order, which must read under
    the limit, and a dropped u in every layer, which must read above it;
    then the bf16 model's own distance from its f32 upcast."""
    import copy
    import torch
    from repro_torch.kernels import wkv6 as twkv
    from repro_torch.models import lm

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    m32 = copy.deepcopy(model).float()
    plain = {}
    for dt, m in (("bfloat16", model), ("float32", m32)):
        got, _ = lm.prefill(cfg, m, toks, cache_len=PROMPT_LEN)
        with ops_swapped("wkv6", _plain_wkv6):
            want, _ = lm.prefill(cfg, m, toks, cache_len=PROMPT_LEN)
        with ops_swapped("wkv6", _no_u_wkv6):
            bad, _ = lm.prefill(cfg, m, toks, cache_len=PROMPT_LEN)
        with ops_swapped("wkv6", _einsum_order_wkv6):
            other, _ = lm.prefill(cfg, m, toks, cache_len=PROMPT_LEN)
        plain[dt] = want
        err, fault = rel(got, want), rel(bad, want)
        sound = rel(other, want)
        finite = bool(torch.isfinite(got).all())
        emit(phase="rwkv_logits", dtype=dt, rel_l2=err,
             route=twkv.route(getattr(torch, dt), toks.shape[1],
                              cfg.rwkv_head_size),
             tol=RWKV_LOGIT_REL_TOL[dt], dropped_u_rel_l2=fault,
             other_sum_order_rel_l2=sound,
             max_abs=float((got.float() - want.float()).abs().max()),
             max_ref=float(want.float().abs().max()),
             top1_agree=float((got.argmax(-1) == want.argmax(-1))
                              .float().mean()), finite=finite)
        if not finite or err > RWKV_LOGIT_REL_TOL[dt]:
            raise AssertionError(f"{dt} prefill logits off the plain WKV6: "
                                 f"{err}")
        if fault <= RWKV_LOGIT_REL_TOL[dt]:
            raise AssertionError(f"{dt}: a dropped u ({fault}) passes the "
                                 f"logit limit")
        if sound > RWKV_LOGIT_REL_TOL[dt]:
            raise AssertionError(f"{dt}: y summed in another order ({sound})"
                                 f" fails the logit limit")
    emit(phase="rwkv_logits_bf16_vs_f32",
         rel_l2=rel(plain["bfloat16"], plain["float32"]))
    del m32
    torch.cuda.empty_cache()


def rwkv_path():
    """Serve rwkv6-1.6b at full width and depth: static generate and
    ServeLoop with every prefill and every decode step of every layer
    through the kernel, then the logit gate and the serving metrics."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as twkv
    from repro_torch.models import lm

    cfg = get_config(RWKV_ARCH)
    if LM_REDUCED:
        cfg = cfg.reduced()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                    device=DEVICE)
    rwkv_weights(cfg, model)
    torch.cuda.synchronize()
    emit(phase="rwkv_init", arch=cfg.name,
         params=sum(p.numel() for p in model.parameters()),
         param_count=cfg.param_count(),
         weight_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
         seconds=time.perf_counter() - t0)

    prompts, launches, prefills, decode_steps = serve_traffic(
        cfg, model, twkv.launch_counts, twkv.reset_launch_counts,
        "rwkv_main_path")
    want = cfg.num_layers * (prefills + decode_steps)
    if launches["wkv6"] != want:
        raise AssertionError(
            f"wkv6 launched {launches['wkv6']} times, expected "
            f"{cfg.num_layers} x ({prefills} prefills + {decode_steps} "
            f"decode steps) = {want}")
    # every prefill (T = PROMPT_LEN) on its route, every decode step (T =
    # 1) on the recurrent kernel
    prefill_path = twkv.route(getattr(torch, cfg.compute_dtype), PROMPT_LEN,
                              cfg.rwkv_head_size)
    per_route = {"wkv6_chunked": 0, "wkv6_recurrent":
                 cfg.num_layers * decode_steps}
    per_route["wkv6_" + prefill_path] += cfg.num_layers * prefills
    for key, n in per_route.items():
        if launches[key] != n:
            raise AssertionError(f"{key} launched {launches[key]} times, "
                                 f"expected {n}")
    emit(phase="rwkv_routes", prefill_route=prefill_path, **per_route)

    toks = torch.as_tensor(prompts[:PROMPTS], dtype=torch.long,
                           device=DEVICE)
    check_rwkv_logits(cfg, model, toks)
    rec = serving_metrics(cfg, model, toks, twkv.launch_counts,
                          "rwkv_serving")
    return launches, rec


def time_wkv6(gen, errs_max, launches):
    """Both WKV6 kernels at the rwkv6-1.6b prefill shape (B 4, T 1024, H
    32, hs 64, bf16), the recurrent one also at a decode step (T 1): each
    call's time (CUDA events around a call, median of 20), the kernel's
    own device time (profiler; at a decode step far less than a call),
    its bound and its plain version's time.  At the prefill shape the
    route takes the chunked kernel; the recurrent one is reached through
    the module's launcher.  No single PyTorch call computes WKV6, so
    there is no library time.  Returns the kernels line's two rows;
    ``errs_max`` is (recurrent, chunked) max |kernel − plain|."""
    import torch
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import wkv6 as twkv
    plain = {"recurrent": tref.wkv6_heads_ref,
             "chunked": tref.wkv6_chunked_heads_ref}
    kernel = {"recurrent": "wkv6_kernel", "chunked": "wkv6_chunked_kernel"}
    out = {}
    for t, path in ((PROMPT_LEN, "chunked"), (PROMPT_LEN, "recurrent"),
                    (1, "recurrent")):
        r, k, v, w, u, s0 = wkv6_inputs(gen, PROMPTS, t, WKV_HEADS, WKV_HS,
                                        torch.bfloat16)
        u = u.float()  # the wrapper's cast to f32 is then no launch

        def call():
            return twkv._launch(r, k, v, w, u, s0, s0, path=path)
        ms = cuda_ms(call, reps=20)
        plain_ms = cuda_ms(lambda: plain[path](r, k, v, w, u, s0),
                           reps=3 if t > 1 else 20, warmup=1)
        device_ms = kernel_device_ms(call, kernel[path])
        bound_ms, bound_by, n_ops, n_bytes = wkv6_bound(
            PROMPTS, t, WKV_HEADS, WKV_HS, 2, path)
        out[t, path] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        emit(phase="time", kernel="wkv6", path=path,
             shape=[PROMPTS, t, WKV_HEADS, WKV_HS], dtype="bfloat16",
             ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
             bound_ms=bound_ms, bound_by=bound_by, flops=n_ops,
             bytes=n_bytes, gflops=n_ops / ms / 1e6)
    rows = []
    for path, source, err in (("recurrent", "wkv6.cu", errs_max[0]),
                              ("chunked", "wkv6_chunked.cu", errs_max[1])):
        rec = out[PROMPT_LEN, path]
        rows.append({
            "name": "wkv6", "path": path, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + source,
            "replaces": "src/repro/kernels/wkv6.py:70",
            "launches": launches["wkv6_" + path], "max_abs_err": err,
            "ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    return rows


# -- Griffin serving: the CUDA-core flash kernel at D 256 and recurrentgemma-9b

GRIFFIN_ARCH = "recurrentgemma-9b"
# 4 prompts of 3072 tokens, so the 2048-key window masks every query past
# 2047 and each prefill's ring buffer wraps; 32 new tokens each
GRIFFIN_PROMPT_LEN, GRIFFIN_CACHE_LEN = 3072, 3200
GRIFFIN_WINDOW = 2048
GRIFFIN_PARAM_COUNT = 9_396_297_728   # configs' param_count()
# the profiled prefill's layers: two superblocks (4 recurrent, 2 local);
# all 38 put 2 x 79,872 RG-LRU launches through the profiler (82 s)
GRIFFIN_PROFILE_LAYERS = 6
ATTN_ERR = {}   # attention_vs_plain's |kernel − plain| by case


def griffin_path():
    """Serve recurrentgemma-9b at full width and depth: static generate and
    ServeLoop with every prefill's local-attention layers through the
    tensor-core flash kernel (none on the CUDA cores, none at decode),
    then the logit gate, whose f32 upcast's prefill wave runs the f32
    route (the CUDA-core kernel, once a local layer), and the serving
    metrics with the prefill's device time split.  Returns the serving
    launches, the f32 wave's and the metrics."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    cfg = get_config(GRIFFIN_ARCH)
    if LM_REDUCED:
        cfg = cfg.reduced()
    kinds = lm.layer_kinds(cfg)
    n_local, n_rec = kinds.count("local_attn"), kinds.count("recurrent")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(3),
                    device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase="griffin_init", arch=cfg.name, layers=cfg.num_layers,
         local_attn_layers=n_local, recurrent_layers=n_rec, params=n_params,
         param_count=cfg.param_count(),
         weight_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
         seconds=time.perf_counter() - t0)
    # param_count counts three lru_dim vectors a recurrent layer (the
    # block holds two, conv_b and lam) and leaves out ln_f
    if n_params != cfg.param_count() - n_rec * cfg.lru_dim + cfg.d_model or (
            not LM_REDUCED and (cfg.param_count(), cfg.num_layers)
            != (GRIFFIN_PARAM_COUNT, 38)):
        raise AssertionError(f"{cfg.name}: {n_params} parameters, "
                             f"param_count {cfg.param_count()}")

    prompts, launches, prefills, _ = serve_traffic(
        cfg, model, fa.launch_counts, fa.reset_launch_counts,
        "griffin_main_path", prompt_len=GRIFFIN_PROMPT_LEN,
        cache_len=GRIFFIN_CACHE_LEN)
    path = fa.route(getattr(torch, cfg.compute_dtype), cfg.head_dim)
    want = {"flash_attention": n_local * prefills,
            "flash_attention_tensor_cores": n_local * prefills,
            "flash_attention_cuda_cores": 0}
    if path != "tensor_cores" or launches != want:
        raise AssertionError(f"flash launches {launches} on {path}, "
                             f"expected {want}: {n_local} local layers x "
                             f"{prefills} prefills, none at decode")

    toks = torch.as_tensor(prompts[:PROMPTS], dtype=torch.long,
                           device=DEVICE)
    routes = check_prefill_logits(cfg, model, toks, phase="griffin_logits")
    for dt, on, off in (("bfloat16", "tensor_cores", "cuda_cores"),
                        ("float32", "cuda_cores", "tensor_cores")):
        n = lm.layer_kinds(dataclasses.replace(
            cfg, num_layers=routes[dt]["layers"])).count("local_attn")
        got = {k: routes[dt][k] for k in want}
        need = {"flash_attention": n, "flash_attention_" + on: n,
                "flash_attention_" + off: 0}
        emit(phase="griffin_logits_launches", dtype=dt, route=on,
             layers=routes[dt]["layers"], local_attn_layers=n, **got)
        if got != need or n == 0:
            raise AssertionError(f"{dt} prefill wave: flash launches {got}, "
                                 f"expected {need}")
    rec = serving_metrics(cfg, model, toks, fa.launch_counts,
                          "griffin_serving",
                          profile_layers=GRIFFIN_PROFILE_LAYERS)
    emit(phase="griffin_rg_lru_loop",
         launches_per_prefill=n_rec * GRIFFIN_PROMPT_LEN,
         launches_per_decode_step=n_rec, recurrent_layers=n_rec)
    return launches, routes["float32"], rec


def griffin_phases():
    """Slice 4: recurrentgemma-9b served at full width and depth, then the
    flash kernels' times at its prefill shape (D 256, window 2048): bf16
    on the tensor cores, f32 on the CUDA cores; and at nemotron-4-340b's
    D 192 in bf16 (tensor cores).  Returns the kernels line entries: the
    tensor-core route at D 256 (launches: the served prefills') and the
    CUDA-core route (launches: the f32 prefill wave's).  The kernels
    against their plain version at these shapes run in
    ``attention_vs_plain``."""
    import gc
    import torch
    launches, f32_wave, _ = griffin_path()
    gc.collect()
    torch.cuda.empty_cache()  # the model's 18.8 GB, before the timings
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rows = {}
    for what, b, h, hkv, s, d, dt, window in (
            ("recurrentgemma", PROMPTS, 16, 1, GRIFFIN_PROMPT_LEN, 256,
             torch.bfloat16, GRIFFIN_WINDOW),
            ("nemotron D=192", 1, 96, 8, 1024, 192, torch.bfloat16, None),
            ("recurrentgemma f32", PROMPTS, 16, 1, GRIFFIN_PROMPT_LEN, 256,
             torch.float32, GRIFFIN_WINDOW)):
        rows[what] = time_attention_case(gen, what, b, h, hkv, s, d, dt,
                                         window)
    entry = {"name": "flash_attention", "route": "cuda",
             "replaces": "src/repro/kernels/flash_attention.py:121"}
    return [{**entry, "path": "tensor_cores", "shape": "D 256",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "launches": launches["flash_attention_tensor_cores"],
             "max_abs_err": ATTN_ERR[
                 "recurrentgemma prefill D=256 window 2048 bf16"],
             **rows["recurrentgemma"]},
            {**entry, "path": "cuda_cores", "shape": "D 256 f32",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "launches": f32_wave["flash_attention_cuda_cores"],
             "max_abs_err": ATTN_ERR[
                 "recurrentgemma D=256 window 2048 S=1024 f32"],
             **rows["recurrentgemma f32"]}]


# -- MoE and MLA serving: dbrx-132b (8 of 40 layers) and minicpm3-4b -------

MOE_ARCH = "dbrx-132b"
# 8 of dbrx's 40 layers at full width: 27.31 B parameters, 54.6 GB in bf16
# (16 experts of 3 x 6144 x 10752 a layer); ten would be 67.6 GB, too
# close to 80 GB beside the prefill waves and the logit checks
MOE_LAYERS = 8
MOE_PARAM_COUNT = 27_305_803_776     # param_count() of the 8-layer config
MLA_ARCH = "minicpm3-4b"
MLA_PARAM_COUNT = 4_261_836_800      # param_count(), 62 layers
# a decode step at position S (absorbed latent attention) against the last
# logits of a prefill of S + 1 tokens (K and V materialised), in f32
MLA_DECODE_TOL = 1e-4
# a prefill's device time with the MoE's routing, dispatch and combine
# (sort, cumsum, index_copy_, the gather) beside the GEMMs
MOE_PREFILL_SPLIT = {**PREFILL_SPLIT,
                     "moe_dispatch": ("sort", "scan", "index", "scatter",
                                      "gather")}


class routes_recorded:
    """Within the block every call of the port's ``moe.router`` (one a
    MoE layer and forward) is recorded in ``calls``, its result passed on
    unchanged: the top-k experts, kept pairs and gates the model used."""

    def __enter__(self):
        from repro_torch.models import moe
        self.saved, self.calls = moe.router, []

        def record(*args, **kwargs):
            r = self.saved(*args, **kwargs)
            self.calls.append(r)
            return r

        moe.router = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.router = self.saved


class routes_held:
    """Within the block the port's ``moe.router`` returns, call by call,
    the top-k experts, positions, kept pairs and slots of ``calls`` (an
    earlier run's ``routes_recorded``) with this run's own logits and
    gates, and its own gate weights at those experts renormalised as the
    router does: the discrete choices held, every value computed."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        import dataclasses
        from repro_torch.models import moe
        self.saved, held = moe.router, iter(self.calls)

        def replay(*args, **kwargs):
            own, r = self.saved(*args, **kwargs), next(held)
            topw = own.gates.gather(-1, r.topi)
            return dataclasses.replace(
                r, logits=own.logits, gates=own.gates,
                topw=topw / topw.sum(-1, keepdim=True).clamp_min(1e-9))

        moe.router = replay
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.router = self.saved


def route_agreement(a, b):
    """(share of the (token, layer, choice) routes equal in two runs'
    ``routes_recorded`` calls, the tokens whose routes differ, and at
    those the smallest gap between adjacent gates among the first run's
    top k + 1: the tie that the run's rounding crossed)."""
    import torch
    same = total = flipped = 0
    gaps = []
    for ra, rb in zip(a, b, strict=True):
        eq = ra.topi == rb.topi
        same += int(eq.sum())
        total += eq.numel()
        moved = ~eq.all(-1)
        if bool(moved.any()):
            k = ra.topi.shape[-1]
            top = torch.sort(ra.gates, -1, descending=True).values[..., :k + 1]
            gaps += (top[..., :-1] - top[..., 1:]).min(-1).values[moved] \
                .tolist()
            flipped += int(moved.sum())
    return same / total, flipped, max(gaps) if gaps else None


def moe_logit_gate(cfg, model, toks, dt, phase):
    """One wave's prefill logits with the kernel against the same model
    with mha_ref called explicitly (``LOGIT_REL_TOL``), beside a dropped
    key tile in every layer, which must read above the gate.

    Routing is discrete: a gate that the two paths' roundings put on
    either side of the k-th largest moves a token's output by a whole
    expert, and a moved token moves the capacity positions of the tokens
    behind it.  So in bf16 the plain path and the fault run on the
    kernel path's routes (``routes_held``), and the free plain run's
    distance is printed beside the gate with the share of (token, layer,
    choice) routes on which the free runs agree, the tokens moved with
    their largest gate gap, and each layer's dropped share.  In f32 the
    runs are free, and every route must be equal.  Returns the flash
    launches of the kernel's prefill (the counts set to 0 just before it
    and read just after)."""
    import contextlib
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    def rel(x, y):
        return float((x.float() - y.float()).norm() / y.float().norm())

    def prefill():
        return lm.prefill(cfg, model, toks, cache_len=toks.shape[1])[0]

    fa.reset_launch_counts()
    with routes_recorded() as kern:
        got = prefill()
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    with ops_swapped("attention", ref.attention_ref), \
            routes_recorded() as free:
        want_free = prefill()
    hold = dt == "bfloat16"
    held = (lambda: routes_held(kern.calls)) if hold else \
        contextlib.nullcontext
    with ops_swapped("attention", ref.attention_ref), held():
        want = prefill() if hold else want_free
    with ops_swapped("attention", dropped_tile_attention), held():
        bad = prefill()
    agree, moved, gap = route_agreement(kern.calls, free.calls)
    err, fault = rel(got, want), rel(bad, want)
    finite = bool(torch.isfinite(got).all())
    emit(phase=phase, dtype=dt, layers=cfg.num_layers, routes_held=hold,
         rel_l2=err, tol=LOGIT_REL_TOL[dt], free_rel_l2=rel(got, want_free),
         dropped_tile_rel_l2=fault, route_agreement=agree,
         moved_tokens=moved, moved_gate_gap_max=gap,
         frac_dropped=[1 - float(r.keep.float().mean()) for r in kern.calls],
         max_abs=float((got.float() - want.float()).abs().max()),
         top1_agree=float((got.argmax(-1) == want.argmax(-1)).float()
                          .mean()), finite=finite, **launches)
    if not finite or err > LOGIT_REL_TOL[dt] or \
            fault <= LOGIT_REL_TOL[dt] or (not hold and agree != 1.0):
        raise AssertionError(f"{dt} prefill logits off mha_ref: {err}; "
                             f"routes equal {agree}; a dropped key tile: "
                             f"{fault}")
    return launches


def weight_bits(model, n_blocks):
    """Per parameter of the embedding, head, ln_f and the first
    ``n_blocks`` blocks: the sums of its bit patterns, all and every
    997th (two models drawn alike give equal sums)."""
    import torch
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("blocks.") and int(name.split(".")[1]) >= n_blocks:
            continue
        bits = p.detach().view(torch.int16 if p.element_size() == 2
                               else torch.int32).flatten()
        out[name] = (int(bits.sum(dtype=torch.int64)),
                     int(bits[::997].sum(dtype=torch.int64)))
    return out


def moe_path():
    """Serve dbrx-132b at full width, its first MOE_LAYERS layers: static
    generate and ServeLoop with every prefill's attention through the
    tensor-core flash kernel (none on the CUDA cores, none at decode),
    the bf16 logit gate with its routes, the serving metrics; then the
    f32 gate on the first two layers, drawn anew from the same seed (an
    f32 copy of two layers, 31 GB, does not fit beside the eight in
    bf16), whose wave runs the f32 route.  Returns the serving launches,
    the f32 wave's and the metrics."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm, moe

    full = get_config(MOE_ARCH)
    cfg = full.reduced() if LM_REDUCED else dataclasses.replace(
        full, num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(5),
                    device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase="moe_init", arch=cfg.name, layers=cfg.num_layers,
         cut_from=full.num_layers, experts=cfg.num_experts,
         top_k=cfg.top_k, group=cfg.moe_group_size,
         capacity=moe.capacity(cfg, cfg.moe_group_size, False),
         params=n_params, param_count=cfg.param_count(),
         weight_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
         seconds=time.perf_counter() - t0)
    # param_count leaves out ln_f
    if n_params != cfg.param_count() + cfg.d_model or (
            not LM_REDUCED and cfg.param_count() != MOE_PARAM_COUNT):
        raise AssertionError(f"{cfg.name}: {n_params} parameters, "
                             f"param_count {cfg.param_count()}")

    # prompts of PROMPT_LEN = moe_group_size tokens: every prefill group is
    # one whole prompt, in the static batch and in any ServeLoop wave, so
    # capacity drops are the same in both and the token check holds
    if not LM_REDUCED and PROMPT_LEN != cfg.moe_group_size:
        raise AssertionError(f"prompts of {PROMPT_LEN} tokens, groups of "
                             f"{cfg.moe_group_size}")
    prompts, launches, prefills, _ = serve_traffic(
        cfg, model, fa.launch_counts, fa.reset_launch_counts,
        "moe_main_path")
    path = fa.route(getattr(torch, cfg.compute_dtype), cfg.head_dim)
    n = cfg.num_layers * prefills
    want = {"flash_attention": n, "flash_attention_tensor_cores": n,
            "flash_attention_cuda_cores": 0}
    if path != "tensor_cores" or launches != want:
        raise AssertionError(f"flash launches {launches} on {path}, "
                             f"expected {want}: {cfg.num_layers} layers x "
                             f"{prefills} prefills, none at decode")

    toks = torch.as_tensor(prompts[:PROMPTS], dtype=torch.long,
                           device=DEVICE)
    moe_logit_gate(cfg, model, toks, "bfloat16", "moe_logits")
    rec = serving_metrics(cfg, model, toks, fa.launch_counts, "moe_serving",
                          split=MOE_PREFILL_SPLIT)
    bits = weight_bits(model, 2)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    m32 = lm.init(cfg2, torch.Generator(device=DEVICE).manual_seed(5),
                  device=DEVICE)
    if weight_bits(m32, 2) != bits:
        raise AssertionError("the 2-layer model's weights differ from the "
                             "served model's first two layers")
    m32.float()
    f32_wave = moe_logit_gate(cfg2, m32, toks, "float32", "moe_logits")
    need = {"flash_attention": 2, "flash_attention_cuda_cores": 2,
            "flash_attention_tensor_cores": 0}
    if {k: f32_wave[k] for k in need} != need:
        raise AssertionError(f"f32 prefill wave: flash launches {f32_wave}, "
                             f"expected {need}")
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    return launches, f32_wave, rec


def moe_phases():
    """Slice 5: the tensor-core flash kernel against its plain version at
    dbrx-132b's prefill shape (B 4, H 48, Hkv 8: GQA group 6, S 1024, D
    128, causal, bf16) with a dropped key tile that must fail; dbrx-132b
    served at full width (8 of 40 layers); the kernel's times at that
    shape.  Returns the kernels line entry."""
    import gc
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as tref
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    bf16, errs = torch.bfloat16, []
    path = fa.route(bf16, 128)
    for layout in (False, True):
        what = "dbrx prefill D=128 Hkv=8 (group 6) bf16" + (
            ", model layout (B,S,H,D)" if layout else "")
        q, k, v = _qkv(gen, PROMPTS, 48, 8, PROMPT_LEN, 128, bf16,
                       model_layout=layout)
        before = fa.launch_counts["flash_attention_" + path]
        got = fa.flash_attention(q, k, v)
        if fa.launch_counts["flash_attention_" + path] != before + 1:
            raise AssertionError(f"{what}: not launched on {path}")
        want = tref.attention_ref(q, k, v)
        errs.append(_attn_check(got, want, bf16, what, path))
        if not layout:
            _planted_fault(q, k, v, want, True, None, what)
    del q, k, v, got, want
    launches, _, _ = moe_path()
    gc.collect()
    torch.cuda.empty_cache()
    row = time_attention_case(gen, "dbrx", PROMPTS, 48, 8, PROMPT_LEN, 128,
                              bf16)
    emit(phase="moe_freed", device_gb=torch.cuda.memory_allocated() / 1e9)
    return [{"name": "flash_attention", "route": "cuda",
             "path": "tensor_cores", "shape": "dbrx D 128, Hkv 8 of 48",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention.py:121",
             "launches": launches["flash_attention_tensor_cores"],
             "max_abs_err": max(errs), **row}]


def mla_decode_gate(cfg, model, prompts, flash=False):
    """On the model upcast to f32 (``upcast``): the logits of a decode
    step at position S, MLA's absorbed attention in the latent space over
    the prefilled (c_kv, k_rope) cache, against the last logits of a
    prefill of the S + 1 tokens, which materialises K and V per head
    (MLA_DECODE_TOL, relative L2); beside it the same in bf16 and the
    bf16 prefill's distance from the f32 one.  No flash kernel may launch
    (MLA's value head is narrower than its key head), but for ``flash`` (a
    CPU rehearsal's reduced config) in the prefills."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    def rel(x, y):
        return float((x.float() - y.float()).norm() / y.float().norm())

    s = prompts.shape[1]
    full = torch.as_tensor(np.concatenate(
        [prompts[:PROMPTS], prompts[PROMPTS:2 * PROMPTS, :1]], 1),
        dtype=torch.long, device=DEVICE)
    cfg32, m32 = upcast(cfg, model)
    fa.reset_launch_counts()
    out = {}
    for dt, c, m in (("float32", cfg32, m32), ("bfloat16", cfg, model)):
        whole, _ = lm.prefill(c, m, full, cache_len=s + 1)
        _, cache = lm.prefill(c, m, full[:, :s], cache_len=s + 1)
        step, _ = lm.decode_step(c, m, cache, full[:, s], s)
        out[dt] = (whole, step)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    err = rel(out["float32"][1], out["float32"][0])
    finite = bool(torch.isfinite(out["float32"][1]).all())
    emit(phase="mla_decode_vs_prefill", dtype="float32",
         layers=cfg32.num_layers, position=s, rel_l2=err,
         tol=MLA_DECODE_TOL,
         max_abs=float((out["float32"][1] - out["float32"][0]).abs().max()),
         bf16_rel_l2=rel(out["bfloat16"][1], out["bfloat16"][0]),
         bf16_vs_f32_rel_l2=rel(out["bfloat16"][0], out["float32"][0])
         if cfg32.num_layers == cfg.num_layers else "not measured (cut)",
         finite=finite, **launches)
    if not finite or err > MLA_DECODE_TOL or (
            any(launches.values()) and not flash):
        raise AssertionError(f"MLA decode off its prefill in f32: {err}; "
                             f"flash launches {launches}")
    del m32, out
    torch.cuda.empty_cache()


def mla_path():
    """Serve minicpm3-4b at full width and depth: static generate and
    ServeLoop, no flash kernel on any route; the decode-against-prefill
    gate in f32; the serving metrics.  Returns the metrics."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    cfg = get_config(MLA_ARCH)
    if LM_REDUCED:
        cfg = cfg.reduced()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(7),
                    device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase="mla_init", arch=cfg.name, layers=cfg.num_layers,
         q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank,
         qk_head=cfg.qk_nope_dim + cfg.qk_rope_dim,
         v_head=cfg.v_head_dim, params=n_params,
         param_count=cfg.param_count(),
         weight_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
         seconds=time.perf_counter() - t0)
    # param_count leaves out ln_f and MLA's two norm scales a layer
    norms = cfg.d_model + cfg.num_layers * (cfg.q_lora_rank
                                            + cfg.kv_lora_rank)
    if n_params != cfg.param_count() + norms or (
            not LM_REDUCED and (cfg.param_count(), cfg.num_layers)
            != (MLA_PARAM_COUNT, 62)):
        raise AssertionError(f"{cfg.name}: {n_params} parameters, "
                             f"param_count {cfg.param_count()}")

    prompts, launches, prefills, _ = serve_traffic(
        cfg, model, fa.launch_counts, fa.reset_launch_counts,
        "mla_main_path")
    # minicpm3's value head (64) is narrower than its key head (96), so
    # ops.attention takes the plain path; a CPU rehearsal's reduced config
    # has 16 and 16 and takes the flash wrapper
    flash = cfg.v_head_dim == cfg.qk_nope_dim + cfg.qk_rope_dim
    if flash != LM_REDUCED or launches["flash_attention"] != (
            cfg.num_layers * prefills if flash else 0):
        raise AssertionError(f"MLA served with flash launches {launches}")
    mla_decode_gate(cfg, model, prompts, flash)
    toks = torch.as_tensor(prompts[:PROMPTS], dtype=torch.long,
                           device=DEVICE)
    rec = serving_metrics(cfg, model, toks, fa.launch_counts, "mla_serving")
    if any(rec["kernel_launches_per_decode_step"].values()):
        raise AssertionError("MLA decode launched a flash kernel")
    return rec


def mla_phases():
    """Slice 5, MLA: minicpm3-4b served at full width and depth (no hand
    kernel on its path: the reference's plain attention at D_v != D_qk).
    Frees the model before returning."""
    import gc
    import torch
    mla_path()
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="mla_freed", device_gb=torch.cuda.memory_allocated() / 1e9)


# -- vision and audio serving: llama-3.2-vision-11b and whisper-tiny -------

VISION_ARCH = "llama-3.2-vision-11b"
VISION_PARAM_COUNT = 9_791_930_368    # param_count(), 40 layers
WHISPER_ARCH = "whisper-tiny"
WHISPER_PARAM_COUNT = 49_600_896      # param_count(), 4 + 4 layers
# whisper's own text context: a prompt of 1500 tokens would equal
# encoder_seq, and prefill's cross call would take the flash route
WHISPER_PROMPT_LEN = 448
WHISPER_ENCODER_SEQ = 1500
WHISPER_ENCODER_CASE = "whisper encoder D=64 H=Hkv=6 S=1500 full bf16"
VISION_PREFILL_CASE = "vision prefill D=128 Hkv=8 (group 4) bf16"
# a cross_attn block's gates are 0 at init, and tanh(0) = 0 hides the
# whole cross path; the served models draw them from this range
GATE_RANGE = (0.5, 1.5)


def draw_gates(model, seed):
    """Every ``cross_attn`` block's gate and gate_mlp, drawn in layer order
    from ``seed`` in GATE_RANGE (two models cut at a superblock boundary
    get the same gates in the layers they share).  Returns them."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    lo, hi = GATE_RANGE
    out = []
    for blk in model.blocks:
        if blk.kind == "cross_attn":
            for g in (blk.gate, blk.gate_mlp):
                g.fill_(float(torch.rand((), generator=gen)) * (hi - lo) + lo)
                out.append(float(g))
    return out


def draw_stubs(cfg, seed):
    """The frontend stubs of SERVE_REQUESTS requests, one row each, N(0, 1)
    in f32 on the card from ``seed``: img_embeds (B, img_seq, d) or
    enc_embeds (B, encoder_seq, d)."""
    import torch
    key, seq = ("enc_embeds", cfg.encoder_seq) if cfg.encdec else \
        ("img_embeds", cfg.img_seq)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return {key: torch.randn((SERVE_REQUESTS, seq, cfg.d_model),
                             generator=gen, device=DEVICE)}


def plain_beside_cross(q, k, v, causal=True, window=None, scale=None):
    """A planted fault for a model with cross-attention: a dropped key
    tile (``dropped_tile_attention``) wherever S == Skv, as a kernel that
    skipped one would compute; the plain version elsewhere."""
    from repro_torch.kernels import ref
    if q.shape[2] == k.shape[2]:
        return dropped_tile_attention(q, k, v, causal, window, scale)
    return ref.attention_ref(q, k, v, causal, window, scale)


class attention_calls_recorded:
    """Within the block every ``ops.attention`` call is recorded in
    ``calls`` with the route it took (``flash_<route>`` where S == Skv,
    else ``plain``), its result passed on unchanged."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops
        self.saved, self.calls = ops.attention, []

        def record(q, k, v, causal=True, window=None, scale=None):
            s, skv = q.shape[2], k.shape[2]
            route = "flash_" + fa.route(q.dtype, q.shape[3]) \
                if s == skv and s > 1 else "plain"
            self.calls.append((route, s, skv, bool(causal), q.shape[1],
                               k.shape[1]))
            return self.saved(q, k, v, causal, window, scale)

        ops.attention = record
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.attention = self.saved

    def counts(self):
        out = {}
        for route, s, skv, causal, h, hkv in self.calls:
            key = f"{route} S={s} Skv={skv} " + \
                ("causal" if causal else "full") + f" H={h} Hkv={hkv}"
            out[key] = out.get(key, 0) + 1
        return out


def cross_logit_gate(cfg, model, toks, extras, dt, phase):
    """One wave's prefill logits (its frontend stubs ``extras``) with the
    kernel against the same model with mha_ref called explicitly
    (``LOGIT_REL_TOL``), the plain path on the first two prompts alone
    beside it, and a dropped key tile in every flash call
    (``plain_beside_cross``), which must read above the f32 gate.  Returns
    the flash launches of the kernel's prefill (the counts set to 0 just
    before it and read just after), the route of each attention call (a
    recorded prefill of its own) and the plain logits."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    def rel(x, y):
        return float((x.float() - y.float()).norm() / y.float().norm())

    def prefill(n=None):
        return lm.prefill(cfg, model, toks[:n], cache_len=toks.shape[1],
                          extras=extras if n is None else rows(extras, 0,
                                                               n))[0]

    fa.reset_launch_counts()
    got = prefill()
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    with attention_calls_recorded() as rec:
        prefill()
    with ops_swapped("attention", ref.attention_ref):
        want, half = prefill(), prefill(2)
    with ops_swapped("attention", plain_beside_cross):
        bad = prefill()
    err, fault = rel(got, want), rel(bad, want)
    finite = bool(torch.isfinite(got).all())
    emit(phase=phase, dtype=dt, layers=cfg.num_layers, rel_l2=err,
         tol=LOGIT_REL_TOL[dt], batch2_rel_l2=rel(half, want[:2]),
         dropped_tile_rel_l2=fault,
         max_abs=float((got.float() - want.float()).abs().max()),
         max_ref=float(want.float().abs().max()),
         top1_agree=float((got.argmax(-1) == want.argmax(-1)).float()
                          .mean()), finite=finite,
         attention_calls=rec.counts(), **launches)
    if not finite or err > LOGIT_REL_TOL[dt] or (
            dt == "float32" and fault <= LOGIT_REL_TOL[dt]):
        raise AssertionError(f"{dt} prefill logits off mha_ref: {err}; a "
                             f"dropped key tile: {fault}")
    return launches, rec.counts(), want


def cross_init(cfg, seed, phase):
    """``lm.init`` of ``cfg`` on the card from ``seed``, its gates drawn
    from the same seed (``draw_gates``); checks its parameter count
    against ``param_count()``, which leaves out ln_f, the gates, and the
    bias of a LayerNorm but in the encoder's blocks, and counts the
    encoder's attention as MHA (a reduced config has 2 kv heads of 4)."""
    import torch
    from repro_torch.models import lm
    t0 = time.perf_counter()
    model = lm.init(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                    device=DEVICE)
    gates = draw_gates(model, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = lm.layer_kinds(cfg)
    norms = {"decoder": 3, "cross_attn": 2}
    extra = cfg.d_model + 2 * kinds.count("cross_attn")
    if cfg.norm == "layernorm":
        extra += (sum(norms.get(k, 2) for k in kinds) + 1
                  + 2 * cfg.encdec) * cfg.d_model
    if cfg.encdec:
        extra -= cfg.encoder_layers * 2 * cfg.d_model * cfg.head_dim * (
            cfg.num_heads - cfg.num_kv_heads)
    emit(phase=phase, arch=cfg.name, layers=cfg.num_layers,
         kinds={k: kinds.count(k) for k in dict.fromkeys(kinds)},
         encoder_layers=cfg.encoder_layers if cfg.encdec else 0,
         params=n_params, param_count=cfg.param_count(), gates=gates,
         weight_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
         seconds=time.perf_counter() - t0)
    if n_params != cfg.param_count() + extra:
        raise AssertionError(f"{cfg.name}: {n_params} parameters, "
                             f"param_count {cfg.param_count()} + {extra}")
    return model


def cross_served_launches(cfg, launches, prefills, phase):
    """The flash launches of a served cross model: every S == Skv call of
    each prefill on the route of its dtype and head dim (the self calls,
    and the encoder's), none at decode, none on the other route."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    kinds = lm.layer_kinds(cfg)
    per_prefill = kinds.count("attn") + kinds.count("decoder") + (
        cfg.encoder_layers if cfg.encdec else 0)
    path = fa.route(getattr(torch, cfg.compute_dtype), cfg.head_dim)
    other = "cuda_cores" if path == "tensor_cores" else "tensor_cores"
    n = per_prefill * prefills
    want = {"flash_attention": n, "flash_attention_" + path: n,
            "flash_attention_" + other: 0}
    emit(phase=phase, route=path, per_prefill=per_prefill,
         prefills=prefills, **launches)
    if launches != want or n == 0:
        raise AssertionError(f"flash launches {launches}, expected {want}: "
                             f"{per_prefill} a prefill x {prefills}")


def vision_path():
    """Serve llama-3.2-vision-11b at full width and depth, its gates and
    image stubs drawn from the seed: static generate and ServeLoop with
    every prefill's 32 self-attention layers on the tensor-core flash
    kernel and the 8 cross layers (1024 queries against 1601 image
    tokens) on the plain attention; the bf16 logit gate; the serving
    metrics; then the f32 gate on the first superblock (4 attn and 1
    cross_attn layers) drawn anew from the same seed, its wave on the
    CUDA-core kernel.  Returns the serving launches and the metrics."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    cfg = get_config(VISION_ARCH)
    if LM_REDUCED:
        cfg = cfg.reduced()
    elif (cfg.param_count(), cfg.num_layers) != (VISION_PARAM_COUNT, 40):
        raise AssertionError(f"{cfg.name}: param_count {cfg.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    model = cross_init(cfg, 8, "vision_init")
    stubs = draw_stubs(cfg, 8)
    prompts, launches, prefills, _ = serve_traffic(
        cfg, model, fa.launch_counts, fa.reset_launch_counts,
        "vision_main_path", stubs=stubs)
    cross_served_launches(cfg, launches, prefills, "vision_launches")
    toks = torch.as_tensor(prompts[:PROMPTS], dtype=torch.long,
                           device=DEVICE)
    wave = rows(stubs, 0, PROMPTS)
    cross_logit_gate(cfg, model, toks, wave, "bfloat16", "vision_logits")
    rec = serving_metrics(cfg, model, toks, fa.launch_counts,
                          "vision_serving", extras=wave)
    if any(rec["kernel_launches_per_decode_step"].values()):
        raise AssertionError("vision decode launched a flash kernel")
    n = len(cfg.block_pattern)
    bits = weight_bits(model, n)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cfg1 = dataclasses.replace(cfg, num_layers=n)
    m32 = cross_init(cfg1, 8, "vision_f32_init")
    if weight_bits(m32, n) != bits:
        raise AssertionError("the first superblock's weights differ from "
                             "the served model's")
    m32.float()
    f32_wave, _, _ = cross_logit_gate(cfg1, m32, toks, wave, "float32",
                                      "vision_logits")
    n_attn = lm.layer_kinds(cfg1).count("attn")
    need = {"flash_attention": n_attn, "flash_attention_cuda_cores": n_attn,
            "flash_attention_tensor_cores": 0}
    if {k: f32_wave[k] for k in need} != need:
        raise AssertionError(f"f32 prefill wave: flash launches {f32_wave}, "
                             f"expected {need}")
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def whisper_path():
    """Serve whisper-tiny at full width and depth, frame stubs drawn from
    the seed: static generate and ServeLoop at 448-token prompts, every
    prefill's 4 encoder layers (unmasked, S 1500) and 4 decoder
    self-attention layers on the tensor-core flash kernel and its 4
    cross calls (448 queries against 1500 frames) on the plain attention;
    the logit gate in bf16 and on the whole model upcast to f32 (50 M
    parameters), each with the route of every attention call; the
    serving metrics.  Returns the serving launches and the metrics."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config(WHISPER_ARCH)
    prompt_len = WHISPER_PROMPT_LEN
    if LM_REDUCED:
        # room for a rehearsal's prompts, and frames enough that a
        # dropped key tile reaches the encoder's later queries
        cfg = dataclasses.replace(cfg.reduced(), max_seq=1024,
                                  encoder_seq=300)
        prompt_len = PROMPT_LEN
    elif (cfg.param_count(), cfg.encoder_seq) != (WHISPER_PARAM_COUNT,
                                                  WHISPER_ENCODER_SEQ):
        raise AssertionError(f"{cfg.name}: param_count {cfg.param_count()}")
    if prompt_len == cfg.encoder_seq:
        raise AssertionError("prompts as long as the encoder's frames send "
                             "the cross calls to the flash kernel")
    torch.cuda.reset_peak_memory_stats()
    model = cross_init(cfg, 9, "whisper_init")
    stubs = draw_stubs(cfg, 9)
    prompts, launches, prefills, _ = serve_traffic(
        cfg, model, fa.launch_counts, fa.reset_launch_counts,
        "whisper_main_path", prompt_len=prompt_len, stubs=stubs)
    cross_served_launches(cfg, launches, prefills, "whisper_launches")
    toks = torch.as_tensor(prompts[:PROMPTS], dtype=torch.long,
                           device=DEVICE)
    wave = rows(stubs, 0, PROMPTS)
    plain = {}
    for dt, (c, m) in (("bfloat16", (cfg, model)),
                       ("float32", upcast(cfg, model))):
        wave_launches, calls, plain[dt] = cross_logit_gate(
            c, m, toks, wave, dt, "whisper_logits")
        on = "tensor_cores" if dt == "bfloat16" else "cuda_cores"
        n = cfg.num_layers + cfg.encoder_layers
        routes = {"flash_" + on: n, "plain": cfg.num_layers}
        got = {}
        for key, count in calls.items():
            route = key.split()[0]
            got[route] = got.get(route, 0) + count
        emit(phase="whisper_attention_routes", dtype=dt, calls=calls)
        if got != routes or wave_launches["flash_attention_" + on] != n:
            raise AssertionError(f"{dt} attention calls {calls}, expected "
                                 f"{routes}")
        del m
    emit(phase="whisper_logits_bf16_vs_f32",
         rel_l2=float((plain["bfloat16"].float() - plain["float32"]).norm()
                      / plain["float32"].norm()))
    rec = serving_metrics(cfg, model, toks, fa.launch_counts,
                          "whisper_serving", extras=wave)
    if any(rec["kernel_launches_per_decode_step"].values()):
        raise AssertionError("whisper decode launched a flash kernel")
    return launches, rec


def cross_phases():
    """Slice 6: llama-3.2-vision-11b and whisper-tiny served at full width
    and depth (nonzero gates, seeded stubs), then the tensor-core flash
    kernel's times at vision's prefill shape (B 4, H 32, Hkv 8, S 1024, D
    128, causal) and whisper's encoder (B 4, H = Hkv = 6, S 1500, D 64,
    unmasked).  The kernel against its plain version at these shapes runs
    in ``attention_vs_plain``.  Returns the kernels line entries (launches:
    each model's served prefills') and frees the models."""
    import gc
    import torch
    launches = {}
    for name, path in (("vision", vision_path), ("whisper", whisper_path)):
        launches[name], _ = path()
        gc.collect()
        torch.cuda.empty_cache()
        emit(phase=name + "_freed",
             device_gb=torch.cuda.memory_allocated() / 1e9)
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    bf16 = torch.bfloat16
    entry = {"name": "flash_attention", "route": "cuda",
             "path": "tensor_cores",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention.py:121"}
    out = []
    for name, shape, case, args in (
            ("vision", "vision D 128, Hkv 8 of 32", VISION_PREFILL_CASE,
             (PROMPTS, 32, 8, PROMPT_LEN, 128, bf16)),
            ("whisper", "whisper encoder D 64, MHA, S 1500, full",
             WHISPER_ENCODER_CASE,
             (PROMPTS, 6, 6, WHISPER_ENCODER_SEQ, 64, bf16))):
        row = time_attention_case(gen, name, *args,
                                  causal=name == "vision")
        out.append({**entry, "shape": shape,
                    "launches": launches[name]["flash_attention_tensor_cores"],
                    "max_abs_err": ATTN_ERR[case], **row})
    return out


# -- training: granite-3-2b at full width and depth ---------------------------

TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 8
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
# gate (a): the first layers at full width in f32 compute, the kernel's
# forward against the plain attention's (only the summation order differs)
TRAIN_F32_LAYERS = 2
TRAIN_F32_TOL = {"loss": 1e-5, "grad": 1e-4, "master": 1e-4}
# gate (b): the first step at full depth in bf16, the kernel's forward
# against the plain attention's: relative distance of the loss, of the
# global grad norm and of the whole gradient (relative L2 over every
# leaf).  The kernel keeps p in f32 where mha_ref rounds it to bf16, in
# each of 40 layers.  Measured free on the H100 (NVIDIA H100 80GB HBM3,
# 700.00 W): loss 2.2e-5, grad norm 2.4e-4, gradient 2.5e-2; a dropped key
# tile in every layer: 1.3e-3, 2.8e-3, 0.69.  The limits sit 4-9x above
# the free distances, and the dropped tile breaks all three
TRAIN_BF16_TOL = {"loss": 2e-4, "grad_norm": 2e-3, "grad": 1e-1}
# gate (c): tests/test_train_infra.py::test_loss_decreases_end_to_end
TRAIN_LEARN = dict(steps=40, batch_size=8, seq_len=64, lr=2e-3, warmup=5,
                   log_every=10)
TRAIN_LEARN_DROP = 0.3
# gate (d): full width, 4 layers, a failure at step 3 of 4, checkpoints
# every 2 steps
TRAIN_RESTART_LAYERS = 4
TRAIN_RESTART = dict(steps=4, batch_size=4, seq_len=512, lr=TRAIN_LR,
                     warmup=1, log_every=1, ckpt_every=2)
TRAIN_FAIL_AT = 3
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
# the checkpoint's save and restore are timed on the trained state cut to
# its first superblocks (4 of granite's 40 layers: 4.1 GB, not 30.4), the
# bytes a second of the full one being the same path's
TRAIN_CKPT_LAYERS = 4
# a profiled step's device time by group: the ranges below carve out the
# optimizer and the plain attention's backward (its recompute and its
# autograd), the kernel names give the scans' backward and forward, the
# GEMMs and the flash forward
TRAIN_SPLIT = {"scan_backward": ("wkv6_backward", "wkv6_du_reduce",
                                 "rg_lru_backward"),
               "scan_forward": ("wkv6_kernel", "wkv6_chunked",
                                "rg_lru_forward"),
               "gemm": ("gemm", "nvjet", "xmma", "cutlass"),
               "flash_forward": ("flash_attention",)}
OPTIMIZER_RANGE = "optimizer_update"
ATTN_BACKWARD_RANGE = "attention_plain_backward"


def tree_rel_l2(got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂ over every leaf of two trees, in f32 leaf
    by leaf."""
    from repro_torch.train import tree as T
    num = den = 0.0
    for a, b in zip(T.leaves(got), T.leaves(want)):
        a, b = a.float(), b.float()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return (num / max(den, 1e-30)) ** 0.5


def clone_tree(tree):
    from repro_torch.train import tree as T
    return T.tree_map(lambda t: t.clone(), tree)


def train_counts():
    """The flash, WKV6 and RG-LRU kernels' launch counts, one dict."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as trg
    from repro_torch.kernels import wkv6 as twkv
    return {**twkv.launch_counts, **trg.launch_counts, **fa.launch_counts}


def reset_train_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as trg
    from repro_torch.kernels import wkv6 as twkv
    for mod in (twkv, trg, fa):
        mod.reset_launch_counts()


def train_cfg(layers=None, arch=TRAIN_ARCH, **over):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if LM_REDUCED:
        cfg = cfg.reduced()
    if layers is not None:
        over["num_layers"] = min(layers, cfg.num_layers)
    return dataclasses.replace(cfg, **over)


def train_batch(cfg, index=0, batch=None, seq=None):
    from repro_torch.data.pipeline import SyntheticCorpus
    return SyntheticCorpus(cfg.vocab_size, seed=0).batch(
        index, batch or TRAIN_BATCH, seq or TRAIN_SEQ)


def train_attention_check(gen):
    """The kernel at the training shape (B 8, H 32, Hkv 8, S 1024, D 64,
    bf16, the model's memory) through ``flash_attention_train``: its
    output against the plain attention within the attention limits, one
    launch, the gradients equal to the plain attention's autograd (the
    backward is that autograd, from the same q, k, v), and a dropped key
    tile that must fail the limits.  Returns |kernel − plain|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as tref
    d = train_cfg().head_dim
    q, k, v = (t.requires_grad_(True) for t in _qkv(
        gen, TRAIN_BATCH, 32, 8, TRAIN_SEQ, d, torch.bfloat16,
        model_layout=True))
    do = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    before = fa.launch_counts["flash_attention"]
    o = fa.flash_attention_train(q, k, v)
    got = torch.autograd.grad(o, (q, k, v), do)
    if fa.launch_counts["flash_attention"] != before + 1:
        raise AssertionError("flash_attention_train: not one launch")
    want_o = tref.attention_ref(q, k, v)
    want = torch.autograd.grad(want_o, (q, k, v), do)
    err = _attn_check(o.detach(), want_o.detach(), torch.bfloat16,
                      "granite training shape B=8, model layout",
                      fa.route(torch.bfloat16, d))
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    emit(phase="train_attention", max_abs_err=err, grads_equal=same)
    if not all(same):
        raise AssertionError(f"flash_attention_train's gradients differ "
                             f"from the plain attention's: {same}")
    with torch.no_grad():
        _planted_fault(q.detach(), k.detach(), v.detach(),
                       want_o.detach(), True, None, "granite training")
    return err


def train_f32_gate(arch, op, plain, want, phase, batch_size):
    """Gates ``train_f32_gate`` (a), ``train_rwkv_f32_gate`` and
    ``train_griffin_f32_gate``: the first TRAIN_F32_LAYERS layers of
    ``arch`` at full width in f32 compute, one ``make_grad_fn`` step and
    AdamW update through the kernels and one with ``ops.<op>`` swapped for
    ``plain`` (the plain attention; the scans' plain versions, forward and
    backward), from the same masters and batch (``batch_size`` x
    TRAIN_SEQ): loss, every gradient (each nonzero: a kernel without a
    gradient would leave its inputs' leaves at 0) and the updated
    masters; the nonzero flash, WKV6 and RG-LRU launch counts exactly
    ``want``, the plain side's none."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from repro_torch.train import tree as T
    cfg = train_cfg(TRAIN_F32_LAYERS, arch, compute_dtype="float32")
    batch = train_batch(cfg, batch=batch_size)
    base = tstep.init_masters(cfg, 0, DEVICE)
    grad_fn = tstep.make_grad_fn(cfg, device=DEVICE)
    out = {}
    for name, swap in (("kernel", None), ("plain", plain)):
        masters = clone_tree(base)
        opt = topt.make_optimizer(cfg.optimizer, topt.warmup_cosine(
            TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
        reset_train_counts()
        with (ops_swapped(op, swap) if swap else contextlib.nullcontext()):
            loss, _, grads = grad_fn(masters, batch)
            grads = clone_tree(grads)
        launches = {k: v for k, v in train_counts().items() if v}
        zero = [k for k, g in T.items(grads) if not bool(g.abs().sum() > 0)]
        opt.update(clone_tree(grads), opt.init(masters), masters)
        out[name] = (float(loss), grads, masters, launches, zero)
    (lk, gk, mk, nk, zk), (lp, gp, mp, np_, zp) = out["kernel"], \
        out["plain"]
    grad_rel = max(tree_rel_l2({0: a}, {0: b}) for a, b in
                   zip(T.leaves(gk), T.leaves(gp)))
    master_rel = max(tree_rel_l2({0: a}, {0: b}) for a, b in
                     zip(T.leaves(mk), T.leaves(mp)))
    delta_rel = tree_rel_l2(T.tree_map(lambda a, b: a - b, mk, base),
                            T.tree_map(lambda a, b: a - b, mp, base))
    rec = dict(arch=cfg.name, layers=cfg.num_layers, batch=batch_size,
               seq=TRAIN_SEQ, loss=lk, loss_plain=lp,
               loss_rel=abs(lk - lp) / abs(lp), grad_rel_l2_max=grad_rel,
               master_rel_l2_max=master_rel, update_rel_l2=delta_rel,
               leaves=len(T.leaves(gk)),
               zero_grads=["/".join(k) for k in zk + zp], launches=nk,
               launches_plain=np_, tol=TRAIN_F32_TOL)
    emit(phase=phase, **rec)
    if rec["loss_rel"] > TRAIN_F32_TOL["loss"] or \
            grad_rel > TRAIN_F32_TOL["grad"] or \
            master_rel > TRAIN_F32_TOL["master"] or zk or zp or \
            nk != want or np_:
        raise AssertionError(f"{phase}: {rec} (launches expected {want})")
    return rec


def train_bf16_gate():
    """Gate (b): the first step's loss, global grad norm and gradient at
    full width and depth in bf16, the kernel's forward against the plain
    attention's; a dropped key tile in every layer must break the
    limits."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as tref
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    cfg = train_cfg()
    batch = train_batch(cfg)
    masters = tstep.init_masters(cfg, 0, DEVICE)
    grad_fn = tstep.make_grad_fn(cfg, device=DEVICE)
    got = {}
    for name, swap in (("plain", tref.attention_ref), ("kernel", None),
                       ("dropped_tile", dropped_tile_attention)):
        fa.reset_launch_counts()
        with (ops_swapped("attention", swap) if swap else
              contextlib.nullcontext()):
            loss, _, grads = grad_fn(masters, batch)
        gn = float(topt.global_norm(grads))
        if name == "plain":
            plain = clone_tree(grads)
            got[name] = dict(loss=float(loss), grad_norm=gn)
            continue
        lp, gp = got["plain"]["loss"], got["plain"]["grad_norm"]
        got[name] = dict(loss=float(loss), grad_norm=gn,
                         loss_rel=abs(float(loss) - lp) / abs(lp),
                         grad_norm_rel=abs(gn - gp) / gp,
                         grad=tree_rel_l2(grads, plain),
                         launches=dict(fa.launch_counts))
    del plain
    k, f = got["kernel"], got["dropped_tile"]
    passes = {name: all(got[name][key] <= tol for key, tol in
                        (("loss_rel", TRAIN_BF16_TOL["loss"]),
                         ("grad_norm_rel", TRAIN_BF16_TOL["grad_norm"]),
                         ("grad", TRAIN_BF16_TOL["grad"])))
              for name in ("kernel", "dropped_tile")}
    n = cfg.num_layers
    emit(phase="train_bf16_gate", layers=n, tol=TRAIN_BF16_TOL,
         passes=passes, **got)
    if k["launches"]["flash_attention_tensor_cores"] != 2 * n or \
            k["launches"]["flash_attention"] != 2 * n:
        raise AssertionError(f"bf16 step: flash launches {k['launches']}, "
                             f"expected {2 * n} on the tensor cores")
    if not passes["kernel"] or passes["dropped_tile"] or \
            not all(torch.isfinite(torch.tensor([k["loss"],
                                                 k["grad_norm"]]))):
        raise AssertionError(f"train bf16 gate: {got}")
    return got


def profiled_once(fn):
    """(wall s, key_averages, events) of one call of ``fn`` under
    torch.profiler; the profiler's warm-up records one small kernel, not a
    call of ``fn`` (it misses launches right after it starts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    return wall, prof.key_averages(), prof.events()


class train_ranges_marked:
    """Within the block the optimizer's update and the flash wrapper's
    backward (the plain attention recomputed and differentiated) run
    inside profiler ranges, so ``marked_kernels`` finds their kernels."""

    def __init__(self, opt):
        self.opt = opt

    def __enter__(self):
        import torch
        from repro_torch.kernels import flash_attention as fa
        cls = fa._KernelForwardPlainBackward
        self.saved = cls.backward
        saved = self.saved

        def backward(ctx, do):
            with torch.profiler.record_function(ATTN_BACKWARD_RANGE):
                return saved(ctx, do)

        cls.backward = staticmethod(backward)
        update = self.opt.update

        def marked(*args):
            with torch.profiler.record_function(OPTIMIZER_RANGE):
                return update(*args)
        return marked

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        fa._KernelForwardPlainBackward.backward = staticmethod(self.saved)


def train_split(events, tree):
    """Device ms and launches of one profiled step by group: the kernels
    inside the optimizer's range and inside the attention backward's
    range, then the groups of TRAIN_SPLIT by name, and the rest."""
    from torch.autograd import DeviceType
    out = {n: {"ms": 0.0, "launches": 0} for n in
           (*TRAIN_SPLIT, "attention_backward", "optimizer", "rest")}

    def group(key):
        key = key.lower()
        return next((n for n, words in TRAIN_SPLIT.items()
                     if any(w in key for w in words)), "rest")

    for e in events:
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        out[group(e.key)]["ms"] += e.self_device_time_total / 1e3
        out[group(e.key)]["launches"] += e.count
    for name, rng in (("attention_backward", ATTN_BACKWARD_RANGE),
                      ("optimizer", OPTIMIZER_RANGE)):
        for key, us in marked_kernels(tree, rng):
            for g, sign in ((group(key), -1), (name, 1)):
                out[g]["ms"] += sign * us / 1e3
                out[g]["launches"] += sign
    return out


def train_main_path(cfg, batch_size, steps, want_step, phase):
    """Phases ``train_main_path`` (granite), ``train_rwkv_main_path`` and
    ``train_griffin_main_path``: ``train`` (the port's entry point) takes
    ``steps`` AdamW steps of ``cfg`` on batches of ``batch_size`` x
    TRAIN_SEQ tokens, remat on, logging every step.  The flash, WKV6 and
    RG-LRU counts are set to 0 just before and read just after:
    ``want_step`` a step, exactly.  Returns (the run's output, its
    record)."""
    import math
    import torch
    from repro_torch.train import loop
    from repro_torch.train import tree as T
    args = loop.TrainArgs(steps=steps, batch_size=batch_size,
                          seq_len=TRAIN_SEQ, lr=TRAIN_LR,
                          warmup=TRAIN_WARMUP, log_every=1)
    log = []
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()       # the main path starts here
    t0 = time.perf_counter()
    out = loop.train(cfg, args, hooks={"on_log": log.append},
                     device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = train_counts()    # the main path ends here
    launches = {k: counts[k] for k in want_step}
    want = {k: n * steps for k, n in want_step.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in log]
    walls = [r["wall_s"] for r in log]
    step_s = statistics.median(b - a for a, b in zip(walls, walls[1:]))
    tokens = batch_size * TRAIN_SEQ
    n_params = sum(t.numel() for t in T.leaves(out["params"]))
    model_flops = 6 * n_params * tokens
    rec = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
               steps=len(log), batch=batch_size, seq=TRAIN_SEQ,
               wall_s=wall, first_step_s=walls[0], step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s,
               model_flops_per_step=model_flops,
               model_flop_share=model_flops / step_s / BF16_PEAK_FLOPS,
               bound_ms=model_flops / BF16_PEAK_FLOPS * 1e3,
               bound_with_recompute_ms=model_flops * 8 / 6
               / BF16_PEAK_FLOPS * 1e3,
               peak_gb=peak / 1e9, losses=losses,
               grad_norms=[r["grad_norm"] for r in log], launches=launches,
               launches_expected=want)
    emit(phase=phase, **rec)
    if launches != want or len(losses) != steps or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: launches {launches} (expected "
                             f"{want}), losses {losses}")
    return out, rec


def train_profile(cfg, out, batch_size, steps, phase):
    """One more step on the trained state under the profiler: wall, device
    busy time and idle share, device ms and launches by group (the scans'
    forward and backward, GEMMs, flash forward, the plain attention's
    backward, the optimizer, the rest)."""
    import torch
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    opt = topt.make_optimizer(cfg.optimizer, topt.warmup_cosine(
        TRAIN_LR, TRAIN_WARMUP, steps + 1))
    batch = train_batch(cfg, index=steps, batch=batch_size)
    with train_ranges_marked(opt) as update:
        grad_fn = tstep.make_grad_fn(cfg, device=DEVICE)

        def step():
            loss, _, grads = grad_fn(out["params"], batch)
            update(grads, out["opt_state"], out["params"])
            return loss

        wall, events, tree = profiled_once(step)
    busy, top = device_busy(events)
    rec = dict(arch=cfg.name, wall_s=wall,
               device_busy_s=busy if busy > 0 else "not measured",
               idle_share=1 - busy / wall if busy > 0 else "not measured",
               kernel_launches=sum(e.count for e in events
                                   if "LaunchKernel" in e.key),
               top=top, split=train_split(events, tree))
    emit(phase=phase, **rec)
    del grad_fn
    return rec


def depth_cut(tree, n, stacked=False):
    """``tree`` with every leaf under a "blocks" key cut to the first n
    entries of its stack axis (the first n superblocks), as views."""
    if isinstance(tree, dict):
        return {k: depth_cut(v, n, stacked or k == "blocks")
                for k, v in tree.items()}
    return tree[:n] if stacked else tree


def train_checkpoint_timing(out):
    """One save of the trained masters and AdamW state (the reference's
    format, synchronous) and one restore onto the card from a template of
    shapes alone, each timed; the restored leaves must equal the saved
    ones.  Then the directory is deleted.  ``out`` may be cut in depth
    (``depth_cut``)."""
    import shutil
    import torch
    from repro_torch import ckpt
    from repro_torch.train import tree as T
    params, state = out["params"], out["opt_state"]
    nbytes = sum(t.numel() * t.element_size()
                 for t in T.leaves(params) + T.leaves(state))
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    TRAIN_CKPT.mkdir(parents=True)
    free = shutil.disk_usage(TRAIN_CKPT).free
    if free < 1.2 * nbytes:
        raise AssertionError(f"{free / 1e9:.1f} GB free under "
                             f"{TRAIN_CKPT} for a {nbytes / 1e9:.1f} GB "
                             "checkpoint")
    t0 = time.perf_counter()
    ckpt.save(str(TRAIN_CKPT), TRAIN_STEPS, params, state, keep=1)
    save_s = time.perf_counter() - t0
    disk = sum(p.stat().st_size for p in TRAIN_CKPT.rglob("*")
               if p.is_file())
    meta_of = lambda t: torch.empty(t.shape, dtype=t.dtype,  # noqa: E731
                                    device="meta")
    t0 = time.perf_counter()
    p2, s2, meta = ckpt.restore(str(TRAIN_CKPT), T.tree_map(meta_of, params),
                                T.tree_map(meta_of, state), device=DEVICE)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    equal = all(bool(torch.equal(a, b)) for a, b in zip(
        T.leaves(params) + T.leaves(state), T.leaves(p2) + T.leaves(s2)))
    del p2, s2
    shutil.rmtree(TRAIN_CKPT)
    rec = dict(gb=nbytes / 1e9, disk_gb=disk / 1e9, free_gb=free / 1e9,
               save_s=save_s, restore_s=restore_s,
               save_gb_per_s=nbytes / 1e9 / save_s,
               restore_gb_per_s=nbytes / 1e9 / restore_s, equal=equal,
               step=meta["step"])
    emit(phase="train_checkpoint", **rec)
    if not equal or meta["step"] != TRAIN_STEPS:
        raise AssertionError(f"checkpoint round trip: {rec}")
    return rec


def train_learning_gate():
    """Gate (c): ``train`` on reduced granite on the card with the
    reference's end-to-end test's arguments: the last logged loss at
    least TRAIN_LEARN_DROP below the first."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import loop
    cfg = get_config(TRAIN_ARCH).reduced()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = loop.train(cfg, loop.TrainArgs(**TRAIN_LEARN), device=DEVICE)
    losses = [r["loss"] for r in out["history"]]
    rec = dict(arch=cfg.name, seconds=time.perf_counter() - t0,
               losses=losses, drop=losses[0] - losses[-1],
               launches=dict(fa.launch_counts), **TRAIN_LEARN)
    emit(phase="train_learning_gate", **rec)
    want = 2 * cfg.num_layers * TRAIN_LEARN["steps"]
    if not all(math.isfinite(x) for x in losses) or \
            losses[-1] > losses[0] - TRAIN_LEARN_DROP or \
            rec["launches"]["flash_attention"] != want:
        raise AssertionError(f"train learning gate: {rec}")
    return rec


def train_restart_gate():
    """Gate (d): ``train_with_restarts`` at full width and
    TRAIN_RESTART_LAYERS layers, failing at step TRAIN_FAIL_AT and resumed
    from the checkpoint of step 2, against the uninterrupted run: the
    masters and the AdamW state bit for bit.  Both runs under
    ``torch.use_deterministic_algorithms(True)`` (the embedding's and the
    label gather's backwards otherwise add with atomics, in any order);
    cuBLAS takes CUBLAS_WORKSPACE_CONFIG, set before CUDA starts."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.train import loop
    from repro_torch.train import tree as T
    cfg = train_cfg(TRAIN_RESTART_LAYERS)
    args = loop.TrainArgs(**TRAIN_RESTART)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        a = loop.train(cfg, args, device=DEVICE)
        t1 = time.perf_counter()
        b = loop.train_with_restarts(cfg, dataclasses.replace(
            args, ckpt_dir=str(TRAIN_CKPT), fail_at_step=TRAIN_FAIL_AT),
            device=DEVICE)
        t2 = time.perf_counter()
    finally:
        torch.use_deterministic_algorithms(before)
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    pairs = list(zip(T.leaves(a["params"]) + T.leaves(a["opt_state"]),
                     T.leaves(b["params"]) + T.leaves(b["opt_state"])))
    differ = sum(not bool(torch.equal(x, y)) for x, y in pairs)
    rec = dict(layers=cfg.num_layers, restarts=b["restarts"],
               leaves=len(pairs), leaves_differ=differ,
               straight_s=t1 - t0, restarted_s=t2 - t1,
               loss=a["history"][-1]["loss"],
               loss_restarted=b["history"][-1]["loss"], **TRAIN_RESTART)
    emit(phase="train_restart_gate", **rec)
    if differ or b["restarts"] != 1:
        raise AssertionError(f"train restart gate: {rec}")
    return rec


def train_phases():
    """Slice 7: training granite-3-2b on the card through the ported
    ``train/``, ``data/`` and ``ckpt/``: the kernel at the training shape
    with its recomputed plain backward, gates (a) f32 and (b) bf16 against
    the plain attention, the main path (``train``, TRAIN_STEPS steps at
    full width and depth), one profiled step, the save and restore of the
    trained state's first TRAIN_CKPT_LAYERS layers, gates (c) learning and
    (d) restart.  Returns the kernels line entry of the training path
    (launches: the main path's)."""
    import gc
    import torch
    from repro_torch.kernels import ref as tref
    phase_t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    err = train_attention_check(gen)
    n = TRAIN_F32_LAYERS
    train_f32_gate(TRAIN_ARCH, "attention", tref.attention_ref,
                   {"flash_attention": 2 * n,
                    "flash_attention_cuda_cores": 2 * n},
                   "train_f32_gate", TRAIN_BATCH)
    gc.collect()
    train_bf16_gate()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = train_cfg()
    n = cfg.num_layers
    out, rec = train_main_path(
        cfg, TRAIN_BATCH, TRAIN_STEPS,
        {"flash_attention": 2 * n, "flash_attention_tensor_cores": 2 * n,
         "flash_attention_cuda_cores": 0}, "train_main_path")
    gc.collect()
    train_profile(cfg, out, TRAIN_BATCH, TRAIN_STEPS, "train_step_profile")
    gc.collect()
    torch.cuda.empty_cache()
    train_checkpoint_timing({k: depth_cut(out[k], TRAIN_CKPT_LAYERS)
                             for k in ("params", "opt_state")})
    del out
    gc.collect()
    torch.cuda.empty_cache()
    train_learning_gate()
    train_restart_gate()
    gc.collect()
    torch.cuda.empty_cache()
    row = time_attention_case(gen, "granite training", TRAIN_BATCH, 32, 8,
                              TRAIN_SEQ, cfg.head_dim, torch.bfloat16)
    emit(phase="train_phases", seconds=time.perf_counter() - phase_t0,
         device_gb=torch.cuda.memory_allocated() / 1e9)
    return [{"name": "flash_attention", "route": "cuda",
             "path": "tensor_cores",
             "shape": f"D 64 training (B {TRAIN_BATCH}, S {TRAIN_SEQ})",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention.py:121",
             "launches": rec["launches"]["flash_attention"],
             "max_abs_err": err, **row}]


# -- training the scan families: rwkv6-1.6b and recurrentgemma-9b -------------

# the WKV6 backward kernel against its plain version at rwkv6's training
# shape, cut in batch for the plain version (its states and G take 2 · T·B·
# H·hs² f32: 4.3 GB at B 2), and at a short f32 shape (B, T, H, hs)
SCAN_WKV_CHECK_BATCH = 2
SCAN_WKV_SHORT = (2, 77, 3, 64)
# the limits a planted fault must fail, relative L2 of each output: the
# kernel and the plain version agree bit for bit (same order, -fmad=false
# on both sides), so these are the limits of a right backward summed in
# another order (``wkv6_backward_einsum``), which must pass them: one
# bf16 step on a share of the bf16 outputs; f32 rounding for f32 outputs
WKV_BWD_REL_L2 = {"bfloat16": 1e-2, "float32": 1e-5}
RG_LRU_SHAPE = (4, 1024, 4096)  # recurrentgemma's training B, S, lru_dim
RG_LRU_REL_L2 = 1e-5
SCAN_F32_BATCH = 2   # the plain WKV6 forward keeps T·B·H·hs² f32 terms
SCAN_TRAIN_STEPS = 4
RWKV_TRAIN_BATCH = 8
GRIFFIN_TRAIN_LAYERS = 6   # two (rec, rec, local_attn) superblocks of 38
GRIFFIN_TRAIN_BATCH = 4
SCAN_REPLACES = {
    "wkv6_backward": "none: the reference differentiates a lax.scan by "
                     "XLA (src/repro/models/rwkv.py:83)",
    "rg_lru": "none: the reference runs a lax.scan "
              "(src/repro/models/griffin.py:43)",
    "rg_lru_backward": "none: the reference differentiates a lax.scan by "
                       "XLA (src/repro/models/griffin.py:43)"}


def plain_wkv6_train(r, k, v, w, u, s0):
    """``ops.wkv6_train`` on the plain versions, forward and backward,
    whatever the device: the f32 gate's other side."""
    from repro_torch.kernels import wkv6 as twkv
    return twkv._Train.apply(r, k, v, w, u, s0, True)


def plain_rg_lru_scan(a, g, h0):
    """``ops.rg_lru_scan`` on the plain versions, whatever the device."""
    from repro_torch.kernels import rg_lru as trg
    return trg._Scan.apply(a, g, h0, True)


def wkv6_backward_einsum(r, k, v, w, u, s0, dy, ds_last, fault=None):
    """The WKV6 gradient in another order (a step at a time, every sum an
    einsum), independent of the plain version: a right backward the
    limits must pass.  ``fault``: "w_next" uses w_{t+1} for w_t in G_{t−1}
    (the last step keeps w_T); "no_u_dk" drops the u term from dk."""
    import torch
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()
    n = rf.shape[1]
    s, states = s0.float(), []
    for t in range(n):
        states.append(s)
        s = wf[:, t, ..., None] * s + torch.einsum(
            "bhi,bhj->bhij", kf[:, t], vf[:, t])
    g = ds_last.float()
    out = {x: [None] * n for x in ("dr", "dk", "dv", "dw")}
    du = torch.zeros_like(uf)
    for t in range(n - 1, -1, -1):
        rt, kt, vt, dyt = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        sp = states[t]
        a = torch.einsum("bhi,bhj->bhij", kt, vt)
        out["dr"][t] = torch.einsum("bhij,bhj->bhi",
                                    sp + uf[None, :, :, None] * a, dyt)
        out["dw"][t] = (g * sp).sum(-1)
        da = g + torch.einsum("bhi,bhj->bhij", rt * uf, dyt)
        dk = torch.einsum("bhij,bhj->bhi", da, vt)
        if fault == "no_u_dk":
            dk = dk - rt * uf * (dyt * vt).sum(-1, keepdim=True)
        out["dk"][t] = dk
        out["dv"][t] = torch.einsum("bhij,bhi->bhj", da, kt)
        du = du + (rt * kt * (dyt * vt).sum(-1, keepdim=True)).sum(0)
        wt = wf[:, min(t + 1, n - 1)] if fault == "w_next" else wf[:, t]
        g = wt[..., None] * g + torch.einsum("bhi,bhj->bhij", rt, dyt)
    return (*(torch.stack(out[x], 1).to(r.dtype)
              for x in ("dr", "dk", "dv", "dw")), du, g)


WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def wkv6_backward_rel(got, want):
    """Relative L2 of each of the six gradients."""
    return {name: float((a.float() - b.float()).norm()
                        / b.float().norm().clamp_min(1e-30))
            for name, a, b in zip(WKV_BWD_NAMES, got, want)}


def wkv6_backward_within(rel, dtype) -> bool:
    """Each gradient within its limit: dr, dk, dv, dw at the inputs'
    dtype's, du and ds0 (f32 in both) at f32's."""
    return all(v <= WKV_BWD_REL_L2["float32" if name in ("du", "ds0")
                                   else str(dtype).split(".")[-1]]
               for name, v in rel.items())


def wkv6_backward_scratch(b, t, h, hs) -> int:
    """The backward kernel's scratch bytes, as its wrapper allocates them:
    ceil(T / steps) checkpointed and ``steps`` recomputed states of hs²
    f32 a (b, h), and du's (B, H, hs) partials."""
    from repro_torch.kernels import wkv6 as twkv
    steps = twkv.LIBRARY_BACKWARD.load().wkv6_backward_scratch_steps()
    return 4 * b * h * ((-(-t // steps) + steps) * hs * hs + hs)


def wkv6_backward_case(gen, what, b, t, h, hs, dtype):
    """One shape: the kernel against its plain version bit for bit (every
    output, its dtype), a second launch bit-equal to the first, the
    einsum order within the limits, and both planted faults outside
    them.  Returns max |kernel − plain| (0 when right)."""
    import torch
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import wkv6 as twkv
    r, k, v, w, u, s0 = wkv6_inputs(gen, b, t, h, hs, dtype)
    u = u.float()
    dy = torch.randn((b, t, h, hs), generator=gen, device=DEVICE).to(dtype)
    ds_last = torch.randn((b, h, hs, hs), generator=gen,
                          device=DEVICE) * 0.1
    args = (r, k, v, w, u, s0, dy, ds_last)
    before = twkv.launch_counts["wkv6_backward"]
    got = twkv._launch_backward(*args)
    again = twkv._launch_backward(*args)
    want = tref.wkv6_heads_backward_ref(*args)
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, c)) and a.dtype == c.dtype
             for a, c in zip(got, want)]
    same = [bool(torch.equal(a, c)) for a, c in zip(got, again)]
    err = max(float((a.float() - c.float()).abs().max())
              for a, c in zip(got, want))
    other = wkv6_backward_rel(wkv6_backward_einsum(*args), got)
    faults = {f: wkv6_backward_rel(wkv6_backward_einsum(*args, fault=f),
                                   got) for f in ("w_next", "no_u_dk")}
    rec = dict(case=what, shape=[b, t, h, hs], dtype=str(dtype),
               bit_equal=dict(zip(WKV_BWD_NAMES, equal)),
               two_launches_equal=all(same), max_abs_err=err,
               einsum_rel_l2=other, faults_rel_l2=faults,
               tol=WKV_BWD_REL_L2,
               launches=twkv.launch_counts["wkv6_backward"] - before,
               scratch_mb=wkv6_backward_scratch(b, t, h, hs) / 1e6)
    emit(phase="wkv6_backward_vs_plain", **rec)
    if not all(equal) or not all(same) or rec["launches"] != 2 or \
            not wkv6_backward_within(other, dtype) or \
            any(wkv6_backward_within(f, dtype) for f in faults.values()):
        raise AssertionError(f"wkv6 backward: {rec}")
    return err


def rg_lru_inputs(gen, b, s, ld):
    """a in (0.88, 1): recurrentgemma's σ(Λ)^(8 r) at init, r in (0, 1);
    g ~ N(0, 1) · 0.1; h0, dh, dh_last ~ N(0, 1); f32 on the card."""
    import torch
    a = torch.exp(-0.125 * torch.rand((b, s, ld), generator=gen,
                                      device=DEVICE))
    g = 0.1 * torch.randn((b, s, ld), generator=gen, device=DEVICE)
    dh = torch.randn((b, s, ld), generator=gen, device=DEVICE)
    h0, dh_last = (torch.randn((b, ld), generator=gen, device=DEVICE)
                   for _ in range(2))
    return a, g, h0, dh, dh_last


def rg_lru_case(gen):
    """Both RG-LRU kernels at recurrentgemma's training shape against their
    plain versions, bit for bit; a planted off-by-one (da_t = H_t h_t in
    place of H_t h_{t−1}) outside RG_LRU_REL_L2.  Returns max |kernel −
    plain| over the five outputs."""
    import torch
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import rg_lru as trg
    a, g, h0, dh, dh_last = rg_lru_inputs(gen, *RG_LRU_SHAPE)
    before = dict(trg.launch_counts)
    h_all, h_last = trg._launch(a, g, h0)
    grads = trg._launch_backward(a, h0, h_all, dh, dh_last)
    want_h, want_last = tref.rg_lru_scan_ref(a, g, h0)
    want = tref.rg_lru_scan_backward_ref(a, h0, want_h, dh, dh_last)
    torch.cuda.synchronize()
    got, ref_all = (h_all, h_last, *grads), (want_h, want_last, *want)
    names = ("h", "h_last", "da", "dg", "dh0")
    equal = {n: bool(torch.equal(x, y)) for n, x, y in
             zip(names, got, ref_all)}
    err = max(float((x - y).abs().max()) for x, y in zip(got, ref_all))
    off_by_one = grads[1] * h_all                  # H_t · h_t
    fault_rel = float((off_by_one - want[0]).norm() / want[0].norm())
    rec = dict(shape=list(RG_LRU_SHAPE), bit_equal=equal, max_abs_err=err,
               off_by_one_rel_l2=fault_rel, tol=RG_LRU_REL_L2,
               launches={k: trg.launch_counts[k] - before[k]
                         for k in before})
    emit(phase="rg_lru_vs_plain", **rec)
    if not all(equal.values()) or fault_rel <= RG_LRU_REL_L2 or \
            rec["launches"] != {"rg_lru": 1, "rg_lru_backward": 1}:
        raise AssertionError(f"rg_lru kernels: {rec}")
    return err


def train_scan_kernels(gen):
    """Phase ``train_scan_kernels``: the WKV6 backward at rwkv6's training
    shape cut in batch (H 32, hs 64, T 1024, bf16, init decays, nonzero
    ds_last) and at a short f32 shape; both RG-LRU kernels at
    recurrentgemma's.  Returns max |kernel − plain| by kernel."""
    import torch
    t0 = time.perf_counter()
    errs = {"wkv6_backward": max(
        wkv6_backward_case(gen, "rwkv6 training, cut in batch",
                           SCAN_WKV_CHECK_BATCH, TRAIN_SEQ, WKV_HEADS,
                           WKV_HS, torch.bfloat16),
        wkv6_backward_case(gen, "short f32", *SCAN_WKV_SHORT,
                           torch.float32))}
    errs["rg_lru"] = errs["rg_lru_backward"] = rg_lru_case(gen)
    torch.cuda.empty_cache()
    emit(phase="train_scan_kernels", seconds=time.perf_counter() - t0,
         max_abs_err=errs)
    return errs


def time_scan_kernels(gen, errs, launches):
    """The three kernels at their main path's shapes: the WKV6 backward at
    rwkv6's training batch (B 8, T 1024, H 32, hs 64, bf16), its output
    bit-equal to the plain version's there too; both RG-LRU kernels at
    recurrentgemma's (B 4, S 1024, ld 4096, f32).  Each call's time (CUDA
    events, median), the kernel's device time (profiler), the bound
    (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s, whichever is
    larger) and the plain version's time.  No PyTorch call computes
    either scan: no library time.  Returns the kernels line's rows."""
    import torch
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import rg_lru as trg
    from repro_torch.kernels import wkv6 as twkv
    b, t, h, hs = RWKV_TRAIN_BATCH, TRAIN_SEQ, WKV_HEADS, WKV_HS
    r, k, v, w, u, s0 = wkv6_inputs(gen, b, t, h, hs, torch.bfloat16)
    dy = torch.randn((b, t, h, hs), generator=gen,
                     device=DEVICE).to(torch.bfloat16)
    ds_last = torch.randn((b, h, hs, hs), generator=gen,
                          device=DEVICE) * 0.1
    wargs = (r, k, v, w, u.float(), s0, dy, ds_last)
    rows = {}

    def row(name, call, plain, n_bytes, n_ops, kernel):
        ms = cuda_ms(call, reps=10)
        t1 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        got = call()
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(a, c)) for a, c in zip(got, want))
        del want
        device_ms = kernel_device_ms(call, kernel, reps=5, warmup=2)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_PEAK_FLOPS
        rows[name] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops) * 1e3,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes", library_ms=None)
        emit(phase="time", kernel=name, bytes=n_bytes, flops=n_ops,
             bit_equal=equal, **rows[name])
        if not equal:
            raise AssertionError(f"{name} != plain at the main path's shape")

    bt, hs2 = b * t * h * hs, b * h * hs * hs
    row("wkv6_backward", lambda: twkv._launch_backward(*wargs),
        lambda: tref.wkv6_heads_backward_ref(*wargs),
        9 * bt * 2 + 3 * hs2 * 4 + 2 * h * hs * 4,
        (14 * hs * hs + 10 * hs) * b * t * h, "wkv6_backward")
    del r, k, v, w, dy, wargs
    torch.cuda.empty_cache()
    a, g, h0, dh, dh_last = rg_lru_inputs(gen, *RG_LRU_SHAPE)
    n = a.numel()
    h_all, _ = trg._launch(a, g, h0)
    row("rg_lru", lambda: trg._launch(a, g, h0),
        lambda: tref.rg_lru_scan_ref(a, g, h0), 3 * n * 4 + 2 * h0.numel()
        * 4, 2 * n, "rg_lru_forward")
    row("rg_lru_backward",
        lambda: trg._launch_backward(a, h0, h_all, dh, dh_last),
        lambda: tref.rg_lru_scan_backward_ref(a, h0, h_all, dh, dh_last),
        5 * n * 4 + 3 * h0.numel() * 4, 3 * n, "rg_lru_backward")
    source = {"wkv6_backward": "wkv6_backward.cu", "rg_lru": "rg_lru.cu",
              "rg_lru_backward": "rg_lru.cu"}
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/" + source[name],
             "replaces": SCAN_REPLACES[name], "launches": launches[name],
             "max_abs_err": errs[name], **rows[name]} for name in rows]


def scan_train_phases():
    """Slice 8: training rwkv6-1.6b and recurrentgemma-9b through the
    scans' hand-written backward kernels: the kernels against their plain
    versions, the f32 gates on 2 layers, rwkv6-1.6b at full width and
    depth and recurrentgemma-9b at full width (6 of 38 layers) through
    ``train``, one profiled step each, the kernels' times.  Returns the
    kernels line's rows (launches: the main paths')."""
    import gc
    import torch
    from repro_torch.kernels import wkv6 as twkv
    phase_t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    errs = train_scan_kernels(gen)
    n = TRAIN_F32_LAYERS
    train_f32_gate(RWKV_ARCH, "wkv6_train", plain_wkv6_train,
                   {"wkv6": 2 * n, "wkv6_recurrent": 2 * n,
                    "wkv6_backward": n}, "train_rwkv_f32_gate",
                   SCAN_F32_BATCH)
    gc.collect()
    train_f32_gate(GRIFFIN_ARCH, "rg_lru_scan", plain_rg_lru_scan,
                   {"rg_lru": n, "rg_lru_backward": n},
                   "train_griffin_f32_gate", SCAN_F32_BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    cfg = train_cfg(arch=RWKV_ARCH)
    n = cfg.num_layers
    # bf16 at hs 64 and T 1024: the chunked kernel, forward and recompute
    path = twkv.route(getattr(torch, cfg.compute_dtype), TRAIN_SEQ,
                      cfg.rwkv_head_size)
    want = {"wkv6": 2 * n, "wkv6_chunked": 0, "wkv6_recurrent": 0,
            "wkv6_backward": n}
    want["wkv6_" + path] = 2 * n
    out, rec = train_main_path(cfg, RWKV_TRAIN_BATCH, SCAN_TRAIN_STEPS,
                               want, "train_rwkv_main_path")
    launches.update(rec["launches"])
    train_profile(cfg, out, RWKV_TRAIN_BATCH, SCAN_TRAIN_STEPS,
                  "train_rwkv_step_profile")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    cfg = train_cfg(GRIFFIN_TRAIN_LAYERS, GRIFFIN_ARCH)
    kinds = list(cfg.block_pattern * cfg.pattern_repeats)
    n_rec, n_local = kinds.count("recurrent"), kinds.count("local_attn")
    out, rec = train_main_path(
        cfg, GRIFFIN_TRAIN_BATCH, SCAN_TRAIN_STEPS,
        {"rg_lru": 2 * n_rec, "rg_lru_backward": n_rec,
         "flash_attention": 2 * n_local,
         "flash_attention_tensor_cores": 2 * n_local,
         "flash_attention_cuda_cores": 0}, "train_griffin_main_path")
    launches.update(rec["launches"])
    train_profile(cfg, out, GRIFFIN_TRAIN_BATCH, SCAN_TRAIN_STEPS,
                  "train_griffin_step_profile")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    rows = time_scan_kernels(gen, errs, launches)
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="scan_train_phases", seconds=time.perf_counter() - phase_t0,
         device_gb=torch.cuda.memory_allocated() / 1e9)
    return rows


def ptxas_kernels(log, name_of) -> dict:
    """Registers and spill bytes from a ptxas log for each entry function
    that ``name_of(mangled name)`` names (None: left out)."""
    import re
    kernels, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = name_of(m.group(1))
            if name:
                kernels[name] = {"registers": None, "spill_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[name]["registers"] = int(m.group(1))
    return kernels


def flash_kernel_name(mangled):
    """The CUDA-core flash kernel's dtype (f: f32, 13__nv_bfloat16: bf16)
    and padded head dim DP, from its mangled name."""
    import re
    k = re.search(r"flash_attention_kernelI(\w+?)Li(\d+)E", mangled)
    return None if k is None else f"{k.group(1)},{k.group(2)}"


def build_all():
    """The eight libraries, one nvcc each, started together; then the
    compacted SpMV library's registers and spills, the ptxas report and
    SASS of the two tensor-core libraries (attention: HGMMA; chunked
    WKV6: HMMA), and the training scans' registers and spills."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import bsr_spmv as tk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rg_lru as trg
    from repro_torch.kernels import wkv6 as twkv
    libraries = [tk.LIBRARY, tk.LIBRARY_COMPACT, *fa.LIBRARIES.values(),
                 twkv.LIBRARY, twkv.LIBRARY_CHUNKED, twkv.LIBRARY_BACKWARD,
                 trg.LIBRARY]

    def timed(lib):
        t1 = time.perf_counter()
        return lib.build(), time.perf_counter() - t1
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as ex:
        built = list(ex.map(timed, libraries))
    paths = [path for path, _ in built]
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in paths],
         library_seconds={lib.name: sec for lib, (_, sec) in
                          zip(libraries, built)})
    for p in paths:
        print(p.with_suffix(".log").read_text(), flush=True)
    log = tk.LIBRARY_COMPACT.path().with_suffix(".log").read_text()
    emit(phase="build_compact", library=tk.LIBRARY_COMPACT.path().name,
         registers=[int(n) for n in re.findall(r"Used (\d+) registers",
                                               log)],
         spill_bytes=[int(a) + int(b) for a, b in re.findall(
             r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)],
         **compact_ptxas(log))
    tensor_core_report(fa.LIBRARIES["tensor_cores"].path(), "HGMMA",
                       sm90_flash_instance,
                       [f"DP {d}" for d in fa.TENSOR_CORE_HEAD_DIMS])
    tensor_core_report(twkv.LIBRARY_CHUNKED.path(), "HMMA")
    log = fa.LIBRARIES["cuda_cores"].path().with_suffix(".log").read_text()
    emit(phase="build_cuda_core_flash",
         library=fa.LIBRARIES["cuda_cores"].path().name,
         kernels=ptxas_kernels(log, flash_kernel_name))
    emit(phase="build_scan_kernels", **{
        lib.name: ptxas_kernels(lib.path().with_suffix(".log").read_text(),
                                scan_kernel_name)
        for lib in (twkv.LIBRARY_BACKWARD, trg.LIBRARY)})


def scan_kernel_name(mangled):
    """The training scans' kernels (the WKV6 backward by dtype and padded
    head size) from their mangled names."""
    import re
    k = re.search(r"(wkv6_backward_kernel|wkv6_du_reduce_kernel|"
                  r"rg_lru_forward_kernel|rg_lru_backward_kernel)"
                  r"(?:I(\w+?)Li(\d+)E)?", mangled)
    if k is None:
        return None
    return k.group(1) + (f"<{k.group(2)},{k.group(3)}>" if k.group(2)
                         else "")


def compact_ptxas(log) -> dict:
    """The compacted SpMV kernels' registers and spill bytes from a ptxas
    log, by kernel, B, ring code, launch bound and (unfused) whether a
    thread walks several rows (the bound and the flag are absent in a
    source built before the kernels took knobs: one bound of 256, one
    row): ``default_bound`` holds the kernels a launch of the default
    knobs runs (8 warps, one row a thread), ``by_bound`` the most
    registers and the spill bytes per bound, ``spills`` every kernel
    that spills."""
    import re

    def name_of(mangled):
        k = re.search(r"(bsr_spmv(?:_fused)?_compact_kernel)ILi(\d+)ELi"
                      r"(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?E", mangled)
        return None if k is None else (
            f"{k.group(1)}<{k.group(2)},{k.group(3)},{k.group(4) or 256}"
            f"{'' if k.group(5) is None else ',' + k.group(5)}>")
    kernels = ptxas_kernels(log, name_of)
    by_bound = {}
    for k, v in kernels.items():
        bound = k.split(",")[2].rstrip(">")
        agg = by_bound.setdefault(bound, {"max_registers": 0,
                                          "spill_bytes": 0, "kernels": 0})
        agg["max_registers"] = max(agg["max_registers"], v["registers"] or 0)
        agg["spill_bytes"] += v["spill_bytes"]
        agg["kernels"] += 1
    return {"default_bound": {k: v["registers"] for k, v in kernels.items()
                              if k.endswith(",256>") or k.endswith(",256,0>")},
            "by_bound": by_bound,
            "spills": {k: v["spill_bytes"] for k, v in kernels.items()
                       if v["spill_bytes"]}}


def nvcc_report(source) -> dict:
    """nvcc's seconds for one SpMV source alone, with the compacted
    library's flags, and ``compact_ptxas`` of its log: the build of two
    versions of ``csrc/bsr_spmv_compact.cu`` compared in one call."""
    from repro_torch.kernels import bsr_spmv as tk
    from repro_torch.kernels.cuda_lib import nvcc
    out = ROOT / "build" / "nvcc_report.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *tk.NVCC_FLAGS, "-o", str(out),
                           str(source)], capture_output=True, text=True,
                          check=True)
    seconds = time.perf_counter() - t0
    out.unlink()
    return dict(source=str(source), seconds=seconds,
                **compact_ptxas(proc.stdout + proc.stderr))


def sm90_flash_instance(mangled):
    """The tensor-core flash kernel's instance ("DP 64" ... "DP 256") from
    its mangled name."""
    import re
    k = re.search(r"flash_attention_sm90_kernelILi(\d+)E", mangled)
    return None if k is None else f"DP {k.group(1)}"


def tensor_core_report(lib, instruction, name_of=None, expect=()):
    """Registers and spill bytes of each kernel from ptxas's log, and the
    tensor-core instructions in the SASS: HGMMA (wgmma) or HMMA
    (mma.sync); with ``name_of``, also by instance, every name in
    ``expect`` present.  Raises on a spill, on ptxas's "wgmma ...
    serialized" warning, on nvcc's warning of a variable used before it
    is set, on a missing instance, or on a SASS without the
    instruction."""
    import re
    from repro_torch.kernels.cuda_lib import nvcc
    log = lib.with_suffix(".log").read_text()
    registers = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    instances = ptxas_kernels(log, name_of) if name_of else {}
    missing = sorted(set(expect) - set(instances))
    sass = subprocess.run(
        [str(pathlib.Path(nvcc()).with_name("cuobjdump")), "-sass",
         str(lib)], capture_output=True, text=True, check=True).stdout
    count = len(re.findall(rf"\b{instruction}\.", sass))
    serialized = [ln for ln in log.splitlines()
                  if "wgmma" in ln and "serialized" in ln]
    unset = [ln for ln in log.splitlines()
             if "before its value is set" in ln]
    emit(phase="build_tensor_cores", library=lib.name, registers=registers,
         spill_bytes=spills, instruction=instruction, instructions=count,
         serialized_warnings=serialized, unset_warnings=unset,
         instances=instances, missing_instances=missing)
    if not registers or any(spills) or serialized or unset or count == 0 \
            or missing or any(v["registers"] is None or v["spill_bytes"]
                              for v in instances.values()):
        raise AssertionError(f"{lib.name}: spills {spills}, {instruction} "
                             f"{count}, warnings {serialized + unset}, "
                             f"instances {instances}, missing {missing}")


def graph_phases():
    """Slice 1: the SpMV kernels against their plain versions, the graph
    main path at full width, the SpMV times; returns the kernels line's
    entries.  Frees the graph plans before returning."""
    import gc
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core import graph as G

    # kernel vs plain at the scale-0.02 CA plans
    gen = torch.Generator().manual_seed(0)
    errs = Errors()
    g02 = G.make_paper_graph("ca", scale=SMALL_SCALE, seed=0)
    for b in (16, 32):
        for semiring in SEMIRINGS:
            p = E.prepare(g02, semiring, b=b, num_clusters=64,
                          device=DEVICE)
            compare_plan(p.vals, p.cols, p.nnz, p.r_pad, semiring, errs,
                         gen, f"ca-0.02 b={b}")
            if semiring == "min_plus":
                garbage_check(p.vals, p.cols, p.nnz, p.r_pad, semiring,
                              gen)
    emit(phase="kernel_vs_plain", ok=True, max_abs_err=errs.max)

    proc, g, launches, res = main_path(errs, gen)
    kernels, q64 = time_kernels(proc, g, errs, launches)
    autotune_phase(proc, g, res, kernels)
    platform_phase(proc, res)
    runners_phase(proc, g)
    dist = distributed_phase(proc, g, res)
    for entry in kernels:
        entry["distributed_launches"] = (
            dist if entry["name"] == "bsr_spmv_compact" else 0)
    graph_serving(proc, g, res, q64, kernels)
    del proc, g, p, res
    gc.collect()
    torch.cuda.empty_cache()  # 25.4 GB of plans, before the LM phases
    emit(phase="graph_freed", device_gb=torch.cuda.memory_allocated() / 1e9)
    return kernels


def lm_phases():
    """Slice 2: flash attention against its plain version, granite-3-2b
    served at full width, the kernel's times; returns its kernels line
    entry.  Frees the model before returning."""
    import gc
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    attn_err, case_err = attention_vs_plain(gen)
    ATTN_ERR.update(case_err)
    launches, _ = lm_path()
    kernels = [time_attention(gen, attn_err["tensor_cores"], launches)]
    gc.collect()
    torch.cuda.empty_cache()  # granite's weights, before the RWKV phases
    emit(phase="lm_freed", device_gb=torch.cuda.memory_allocated() / 1e9)
    return kernels


def rwkv_phases():
    """Slice 3: both WKV6 kernels against their plain versions,
    rwkv6-1.6b served at full width and depth, the kernels' times;
    returns their kernels line entries.  Frees the model before
    returning."""
    import gc
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    err = wkv6_vs_plain(gen)
    chunked_err = wkv6_chunked_vs_plain(gen)
    launches, _ = rwkv_path()
    kernels = time_wkv6(gen, (err, chunked_err), launches)
    gc.collect()
    torch.cuda.empty_cache()  # rwkv6's weights, before the Griffin phases
    emit(phase="rwkv_freed", device_gb=torch.cuda.memory_allocated() / 1e9)
    return kernels


def setup():
    """Phase 1: the card's name and power limit, versions, TF32 off."""
    import torch
    smi = nvidia_smi()
    name, limit = [s.strip() for s in smi.split(",", 1)]
    CARD.update(name=name, power_limit=limit)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the port, not JAX; fails outside)
    setup()
    # 2. build; 3.-5. the graph engine; 6.-8. LM serving; 9.-11. RWKV;
    # 12.-13. Griffin
    build_all()
    kernels = graph_phases()
    kernels += lm_phases()
    kernels += rwkv_phases()
    kernels += griffin_phases()
    # 14.-15. MoE (dbrx-132b) and MLA (minicpm3-4b)
    kernels += moe_phases()
    mla_phases()
    # 16.-17. vision (llama-3.2-vision-11b) and audio (whisper-tiny)
    kernels += cross_phases()
    # 18. training granite-3-2b
    kernels += train_phases()
    # 19. training rwkv6-1.6b and recurrentgemma-9b
    kernels += scan_train_phases()

    # 20. the card, the kernels line, and the result
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
