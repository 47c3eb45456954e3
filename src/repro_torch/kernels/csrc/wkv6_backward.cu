// The gradient of the RWKV-6 WKV recurrence for Hopper (sm_90a), on the
// CUDA cores.
//
// Replaces no Pallas kernel: the JAX package trains through XLA's
// autodiff of its `lax.scan` (`_wkv_scan`, src/repro/models/rwkv.py).  On
// the card a scan on the hot path is a kernel, so the port's training
// differentiates its forward kernels (csrc/wkv6.cu, csrc/wkv6_chunked.cu)
// with this one.  Bound to Python with ctypes by kernels/wkv6.py
// (`wkv6_train`).
//
// What it computes.  The forward, per (batch, head), per step t, in f32:
//   a_t = k_tᵀ v_t,   y_t = r_t (S_{t−1} + u ⊙ a_t),
//   S_t = diag(w_t) S_{t−1} + a_t          (S keyed [k dim i, v dim j]).
// Given dy and G_T = ∂L/∂S_T (ds_last), walking back with G_t = ∂L/∂S_t:
//   dA_t = (r_t ⊙ u)ᵀ dy_t + G_t           (∂L/∂a_t)
//   dk_t = dA_t v_t,   dv_t = dA_tᵀ k_t,   dr_t = (S_{t−1} + u ⊙ a_t) dy_t
//   dw_t = Σ_j G_t ⊙ S_{t−1},   du += r_t ⊙ k_t (dy_t · v_t)
//   G_{t−1} = diag(w_t) G_t + r_tᵀ dy_t,   ds0 = G_0.
//
// Layout.  r, k, v, w, dy contiguous (B, T, H, hs), one dtype, bf16 or
// f32, upcast on load; dr, dk, dv, dw written in that dtype, contiguous.
// u (H, hs) f32; s0, ds_last and ds0 (B, H, hs, hs) f32, contiguous.  du
// (H, hs) f32 sums over the batch: each block writes its (b, h) partial
// to du_part (B, H, hs), and a second kernel adds the partials in
// ascending b, one thread an element, so du is the same bits run to run
// (no atomics).  Head size at most 64.
//
// Work split.  One block per (b, h), blockIdx.x = b·H + h, with HSP
// threads (hs rounded up to 32 or 64).  Thread i owns row i of S and of
// G, each HSP registers: both recurrences are row by row (w_t[i] scales
// row i), so every sum over j (dr, dk, dw, dy·v) is the thread's own, and
// only dv's sum over i crosses threads, through a padded (HSP, HSP + 1)
// shared tile and two __syncthreads a step.  The states S_{t−1} are
// recomputed, not stored by the forward:
//   1. a forward pass from s0 writes S at every CH-th step (the first
//      step of each chunk of CH = 16 steps) to the checkpoint scratch;
//   2. chunk by chunk from the last, the block stages the chunk's r, k,
//      w, v, dy in shared memory (20 KB at HSP 64), recomputes the chunk's
//      CH states from its checkpoint into the chunk scratch, then walks
//      back through them.
// Scratch, allocated by the wrapper: ceil(T / CH) + CH states of hs² f32
// a (b, h): (64 + 16) · 16 KB = 1.31 MB at T 1024, hs 64; 335.5 MB for
// rwkv6-1.6b's training batch (B 8, H 32).  Both are laid out [step][j]
// [i], so the threads of a block read and write consecutive addresses.
//
// Arithmetic.  Built with -fmad=false: every product and sum rounds once,
// as written in the loops below, and every running sum starts at +0 and
// adds in ascending index.  The plain version
// (ref.wkv6_heads_backward_ref) does the same torch ops in the same
// order, so the two agree bit for bit.  Rows and columns at or past hs
// are staged as zeros: their S and G stay ±0, and the ±0 terms they add
// to a running sum that is never −0 change nothing.
//
// Bound on the H100.  Operations, counting what the function needs per
// step and head: the states again (3 hs²), dr, dw, dk and dv as four
// hs-long dot products per row or column (8 hs², the u terms folded into
// dot products of length hs), G's update (3 hs²): 14 hs² + O(hs).  At
// rwkv6-1.6b's training shape (B 8, T 1024, H 32, hs 64) that is 15.0
// GFLOP, 0.224 ms at the 67 TFLOP/s of the f32 CUDA cores, against 0.090
// ms for its 302 MB (r, k, v, w, dy read, dr, dk, dv, dw written in bf16;
// the f32 states in and out).  This simple kernel does more: the states
// twice (both passes), u·(k·v) and dA·k for every (i, j).  What it leaves
// on the table: 256 blocks of 2 warps, each walking 1024 dependent steps
// with two barriers a step; no tensor cores (a chunked backward, matrix
// products over blocks of steps as csrc/wkv6_chunked.cu does forward,
// would be the fast form); -fmad=false doubles the issue count of the
// products an FMA could fuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;  // steps a chunk: staged, and between checkpoints

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* dy;
  const float* u;
  const float* s0;
  const float* ds_last;
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  float* du_part;
  float* ds0;
  float* ckpt;  // (B·H, ceil(T / CH), hs, hs), [chunk][j][i]
  float* buf;   // (B·H, CH, hs, hs), [step][j][i]
  int T, H, hs;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int HSP>
__global__ void __launch_bounds__(HSP) wkv6_backward_kernel(Args a) {
  __shared__ __align__(16) float rs[CH][HSP];
  __shared__ __align__(16) float ks[CH][HSP];
  __shared__ __align__(16) float ws[CH][HSP];
  __shared__ __align__(16) float vs[CH][HSP];
  __shared__ __align__(16) float dys[CH][HSP];
  __shared__ float ps[HSP][HSP + 1];  // dA_ij · k_i, row i by thread i

  const int i = threadIdx.x;
  const int hs = a.hs;
  const bool live = i < hs;
  const int h = blockIdx.x % a.H;
  const long long row = (long long)a.H * hs;  // elements from t to t + 1
  // element (b, t, h, 0) is at base + t·row
  const long long base = (long long)blockIdx.x / a.H * a.T * row +
                         (long long)h * hs;
  const T* r = static_cast<const T*>(a.r) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* w = static_cast<const T*>(a.w) + base;
  const T* dy = static_cast<const T*>(a.dy) + base;
  T* dr = static_cast<T*>(a.dr) + base;
  T* dk = static_cast<T*>(a.dk) + base;
  T* dv = static_cast<T*>(a.dv) + base;
  T* dw = static_cast<T*>(a.dw) + base;
  const long long hs2 = (long long)hs * hs;
  const long long slice = (long long)blockIdx.x * hs2;
  const int nc = (a.T + CH - 1) / CH;
  float* ckpt = a.ckpt + (long long)blockIdx.x * nc * hs2;
  float* buf = a.buf + (long long)blockIdx.x * CH * hs2;
  const float ui = live ? a.u[h * hs + i] : 0.0f;

  // stage steps t0 .. t0 + n − 1 of the inputs (lanes past hs as zeros)
  auto stage = [&](int t0, int n, bool all) {
    __syncthreads();  // the previous chunk's readers are done
    for (int c = 0; c < n; ++c) {
      const long long at = (long long)(t0 + c) * row + i;
      ks[c][i] = live ? load_f32(k + at) : 0.0f;
      ws[c][i] = live ? load_f32(w + at) : 0.0f;
      vs[c][i] = live ? load_f32(v + at) : 0.0f;
      if (all) {
        rs[c][i] = live ? load_f32(r + at) : 0.0f;
        dys[c][i] = live ? load_f32(dy + at) : 0.0f;
      }
    }
    __syncthreads();
  };

  // 1. forward from s0, S at the first step of each chunk checkpointed
  float S[HSP];
#pragma unroll
  for (int j = 0; j < HSP; ++j)
    S[j] = (live && j < hs) ? a.s0[slice + (long long)i * hs + j] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    if (live) {
#pragma unroll
      for (int j = 0; j < HSP; ++j)
        if (j < hs) ckpt[((long long)c * hs + j) * hs + i] = S[j];
    }
    if (c == nc - 1) break;  // the last chunk is recomputed in pass 2
    stage(c * CH, CH, false);
    for (int s = 0; s < CH; ++s) {
      const float ki = ks[s][i], wi = ws[s][i];
#pragma unroll
      for (int j = 0; j < HSP; ++j) S[j] = wi * S[j] + ki * vs[s][j];
    }
  }

  // 2. backward, chunk by chunk from the last
  float G[HSP];
#pragma unroll
  for (int j = 0; j < HSP; ++j)
    G[j] = (live && j < hs) ? a.ds_last[slice + (long long)i * hs + j]
                            : 0.0f;
  float du = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CH, n = min(CH, a.T - t0);
    stage(t0, n, true);
    // the chunk's states S_{t0 − 1 + s + 1}, s = 0 .. n − 1, into buf
#pragma unroll
    for (int j = 0; j < HSP; ++j)
      S[j] = (live && j < hs) ? ckpt[((long long)c * hs + j) * hs + i]
                              : 0.0f;
    for (int s = 0; s < n; ++s) {
      if (live) {
#pragma unroll
        for (int j = 0; j < HSP; ++j)
          if (j < hs) buf[((long long)s * hs + j) * hs + i] = S[j];
      }
      if (s + 1 < n) {
        const float ki = ks[s][i], wi = ws[s][i];
#pragma unroll
        for (int j = 0; j < HSP; ++j) S[j] = wi * S[j] + ki * vs[s][j];
      }
    }
    for (int s = n - 1; s >= 0; --s) {
      const float ri = rs[s][i], ki = ks[s][i], wi = ws[s][i];
      const float ru = ri * ui;
      const float rk = ri * ki;
      float vdy = 0.0f;
#pragma unroll
      for (int j = 0; j < HSP; ++j) vdy = vdy + dys[s][j] * vs[s][j];
      float gr = 0.0f, gw = 0.0f, gk = 0.0f;
      const float* sp = buf + (long long)s * hs2 + i;
#pragma unroll
      for (int j = 0; j < HSP; ++j) {
        const float sij = (live && j < hs) ? sp[(long long)j * hs] : 0.0f;
        const float vj = vs[s][j], dyj = dys[s][j];
        const float term = sij + ui * (ki * vj);
        gr = gr + term * dyj;
        const float g = G[j];
        gw = gw + g * sij;
        const float da = ru * dyj + g;
        gk = gk + da * vj;
        ps[i][j] = da * ki;
        G[j] = wi * g + ri * dyj;
      }
      du = du + rk * vdy;
      const long long at = (long long)(t0 + s) * row + i;
      if (live) {
        store_f32(dr + at, gr);
        store_f32(dk + at, gk);
        store_f32(dw + at, gw);
      }
      __syncthreads();  // every row of ps written
      if (live) {
        float gv = 0.0f;
#pragma unroll
        for (int q = 0; q < HSP; ++q) gv = gv + ps[q][i];
        store_f32(dv + at, gv);
      }
      __syncthreads();  // ps read before the next step writes it
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < HSP; ++j)
      if (j < hs) a.ds0[slice + (long long)i * hs + j] = G[j];
    a.du_part[(long long)blockIdx.x * hs + i] = du;
  }
}

// du[x] = Σ_b du_part[b][x], b ascending from 0, for x over H·hs
__global__ void wkv6_du_reduce_kernel(const float* part, float* du, int B,
                                      int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float s = part[x];
  for (int b = 1; b < B; ++b) s = s + part[(long long)b * n + x];
  du[x] = s;
}

template <typename T, int HSP>
int launch(const Args& a, int B, float* du, cudaStream_t stream) {
  wkv6_backward_kernel<T, HSP><<<B * a.H, HSP, 0, stream>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int n = a.H * a.hs;
  wkv6_du_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(a.du_part, du,
                                                            B, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hs(const Args& a, int B, float* du, cudaStream_t stream) {
  if (a.hs <= 32) return launch<T, 32>(a, B, du, stream);
  return launch<T, 64>(a, B, du, stream);
}

}  // namespace

// C interface.  dtype: 0 = float32, 1 = bfloat16.  ckpt: B·H·ceil(T /
// 16)·hs² floats; buf: B·H·16·hs² floats; du_part: B·H·hs floats.
// Returns 0, a cudaError_t, or -1 for a dtype or head size the kernel
// does not take.
extern "C" {

int wkv6_backward_scratch_steps() { return CH; }

int wkv6_backward_launch(const void* r, const void* k, const void* v,
                         const void* w, const void* dy, const float* u,
                         const float* s0, const float* ds_last, void* dr,
                         void* dk, void* dv, void* dw, float* du,
                         float* du_part, float* ds0, float* ckpt, float* buf,
                         int B, int T, int H, int hs, int dtype,
                         void* stream) {
  if (hs < 1 || hs > 64 || dtype < 0 || dtype > 1) return -1;
  if (B == 0 || H == 0) return 0;
  Args a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.dy = dy;
  a.u = u; a.s0 = s0; a.ds_last = ds_last;
  a.dr = dr; a.dk = dk; a.dv = dv; a.dw = dw;
  a.du_part = du_part; a.ds0 = ds0; a.ckpt = ckpt; a.buf = buf;
  a.T = T; a.H = H; a.hs = hs;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hs<float>(a, B, du, st);
  return dispatch_hs<__nv_bfloat16>(a, B, du, st);
}

const char* wkv6_backward_error_string(int code) {
  if (code == -1) return "unsupported dtype or head size (at most 64)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
