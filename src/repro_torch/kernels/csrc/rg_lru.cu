// The RG-LRU scan of Griffin / RecurrentGemma for Hopper (sm_90a), forward
// and backward, on the CUDA cores.
//
// Replaces no Pallas kernel: the JAX package runs this scan as a
// `lax.scan` in `_rg_lru` (src/repro/models/griffin.py) and trains
// through XLA's autodiff of it.  On the card a scan on the hot path is a
// kernel; kernels/rg_lru.py (`rg_lru_scan`) binds both with ctypes as one
// autograd Function.
//
// What it computes, per (batch, channel), in f32:
//   forward   h_t = a_t·h_{t−1} + g_t from h0, every h_t kept;
//   backward  H_t = dh_t + a_{t+1}·H_{t+1} from H_S = dh_S + dh_last,
//             da_t = H_t·h_{t−1} (h_0 = h0), dg_t = H_t, dh0 = a_1·H_1.
// a, g, h (the forward's every step), dh, da, dg: (B, S, ld) f32,
// contiguous; h0, h_last, dh_last, dh0: (B, ld) f32.
//
// Work split.  One thread per (b, channel), 256 threads a block, h (or H)
// in a register across the whole sequence.  At step t the threads of a
// warp read 32 consecutive channels of row (b, t): coalesced.  Each
// thread loads PF = 8 steps of its inputs into registers before it runs
// them, so eight loads are in flight where the dependent chain would
// issue one.
//
// Arithmetic.  Built with -fmad=false: each product and sum rounds once,
// as written.  The plain versions (ref.rg_lru_scan_ref,
// ref.rg_lru_scan_backward_ref) do the same torch ops in the same order:
// the kernels and they agree bit for bit.
//
// Bound on the H100.  Bytes: the forward reads a and g and writes h (3 ·
// B·S·ld f32), the backward reads a, h and dh and writes da and dg (5 ·
// B·S·ld f32).  At recurrentgemma-9b's training shape (B 4, S 1024, ld
// 4096) that is 201 MB, 0.060 ms, and 336 MB, 0.100 ms, at 3.35 TB/s; the
// operations (2 and 3 a step and channel) are far below that.  What the
// design leaves on the table: 16,384 threads, 64 blocks on 132 SMs, each
// walking 1024 dependent steps: a step's latency is the chain's, and the
// card is far from its memory rate.  Splitting the sequence into blocks
// scanned in parallel (a two-level scan: local scans, a scan of the block
// carries, a fix-up) would fill it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PF = 8;  // steps loaded ahead

__global__ void __launch_bounds__(THREADS)
rg_lru_forward_kernel(const float* a, const float* g, const float* h0,
                      float* h_all, float* h_last, int B, int S, int L) {
  const long long x = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (x >= (long long)B * L) return;
  const long long base = x / L * S * L + x % L;  // (b, 0, c)
  float h = h0[x];
  for (int t0 = 0; t0 < S; t0 += PF) {
    float av[PF], gv[PF];
#pragma unroll
    for (int s = 0; s < PF; ++s) {
      if (t0 + s < S) {
        const long long at = base + (long long)(t0 + s) * L;
        av[s] = a[at];
        gv[s] = g[at];
      }
    }
#pragma unroll
    for (int s = 0; s < PF; ++s) {
      if (t0 + s < S) {
        h = av[s] * h + gv[s];
        h_all[base + (long long)(t0 + s) * L] = h;
      }
    }
  }
  h_last[x] = h;
}

__global__ void __launch_bounds__(THREADS)
rg_lru_backward_kernel(const float* a, const float* h0, const float* h_all,
                       const float* dh, const float* dh_last, float* da,
                       float* dg, float* dh0, int B, int S, int L) {
  const long long x = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (x >= (long long)B * L) return;
  const long long base = x / L * S * L + x % L;
  float carry = dh_last[x];  // a_{t+1}·H_{t+1}; dh_last at t = S
  for (int t0 = S - 1; t0 >= 0; t0 -= PF) {
    float av[PF], dhv[PF], hp[PF];
#pragma unroll
    for (int s = 0; s < PF; ++s) {
      const int t = t0 - s;
      if (t >= 0) {
        const long long at = base + (long long)t * L;
        av[s] = a[at];
        dhv[s] = dh[at];
        hp[s] = t > 0 ? h_all[at - L] : h0[x];
      }
    }
#pragma unroll
    for (int s = 0; s < PF; ++s) {
      const int t = t0 - s;
      if (t >= 0) {
        const float ht = dhv[s] + carry;
        const long long at = base + (long long)t * L;
        da[at] = ht * hp[s];
        dg[at] = ht;
        carry = av[s] * ht;
      }
    }
  }
  dh0[x] = carry;
}

int grid(int B, int L) {
  return (int)(((long long)B * L + THREADS - 1) / THREADS);
}

}  // namespace

// C interface.  Returns 0 or a cudaError_t.
extern "C" {

int rg_lru_forward_launch(const float* a, const float* g, const float* h0,
                          float* h_all, float* h_last, int B, int S, int L,
                          void* stream) {
  if (B == 0 || L == 0) return 0;
  rg_lru_forward_kernel<<<grid(B, L), THREADS, 0, (cudaStream_t)stream>>>(
      a, g, h0, h_all, h_last, B, S, L);
  return (int)cudaGetLastError();
}

int rg_lru_backward_launch(const float* a, const float* h0,
                           const float* h_all, const float* dh,
                           const float* dh_last, float* da, float* dg,
                           float* dh0, int B, int S, int L, void* stream) {
  if (B == 0 || L == 0) return 0;
  rg_lru_backward_kernel<<<grid(B, L), THREADS, 0, (cudaStream_t)stream>>>(
      a, h0, h_all, dh, dh_last, da, dg, dh0, B, S, L);
  return (int)cudaGetLastError();
}

const char* rg_lru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
