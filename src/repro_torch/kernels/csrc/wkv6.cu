// The RWKV-6 WKV recurrence for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas kernel `wkv6` (body `_wkv6_kernel`) in the JAX
// package's src/repro/kernels/wkv6.py.  Per (batch, head), per step t, in
// f32:
//   a_t = k_tᵀ v_t                 (hs x hs outer product)
//   y_t = r_t (S + u ⊙ a_t)        (u scales the rows of a_t)
//   S  ← diag(w_t) S + a_t         (S keyed [k dim, v dim])
// Bound to Python with ctypes by kernels/wkv6.py.
//
// Layout.  r, k, v, w in the model's (B, T, H, hs) layout, read through
// element strides for b, t and h (hs contiguous), so the model's reshapes
// cost no copy; the JAX package's (B·H, T, hs) layout with one shared u is
// the H = 1 case.  One dtype for r, k, v, w and y: bf16 or f32, upcast on
// load.  u (H, hs) f32, one row per head (the Pallas kernel takes one
// (hs,) u; the model has one per head).  s0 and s_out (B, H, hs, hs) f32,
// contiguous.  y is written in r's dtype through its own strides.
//
// In place.  Each block reads its (hs, hs) slice of s0 before its first
// step and writes s_out after its last, and no other block touches that
// slice, so s0 and s_out may be the same memory.  The model's decode step
// (T = 1) and its prefill pass the f32 state cache as both: the cache is
// updated in place.
//
// Work split.  One block per (b, h), blockIdx.x = b·H + h, with HSP
// threads (hs rounded up to 32, 64 or 128).  Thread j owns column j of
// the state, S[:, j], in HSP registers for the whole sequence: the TPU's
// VMEM scratch carried across time chunks becomes registers carried
// across a loop.  The block stages CH = 2048 / HSP steps of r, k, w and v
// in shared memory (32 KB, f32) between two __syncthreads, then each
// thread runs the CH steps on its own: it reads r_t, k_t, w_t and u as
// broadcasts, computes
//   y_j = Σ_i r_i (S_ij + u_i k_i v_j)     (i ascending, from 0)
//   S_ij ← w_i S_ij + k_i v_j
// and stores y_j.  Rows and columns at or past hs are staged as zeros, so
// their state stays 0 and adds nothing; those threads store nothing.
//
// Arithmetic.  Built with -fmad=false: every product and sum rounds once,
// as written above.  The plain version (ref.wkv6_heads_ref) does the same
// torch ops in the same order, the sum over i ascending from 0 included,
// so kernel and plain version agree bit for bit, y and the final state,
// and a comparison of the two reads 0 unless the kernel is wrong.
//
// Bound on the H100.  Operations, at the rwkv6-1.6b prefill shape (B 4,
// T 1024, H 32, hs 64, bf16), counting what the function needs: r·S
// (2 hs²) and S ← w·S + kᵀv (3 hs²) per step and head, and the u term
// folded into one dot product, y_j += v_j · Σ_i r_i u_i k_i (5 hs); so
// (5 · 4096 + 320) · 128 · 1024 = 2.73 GFLOP, 40.7 us at the 67 TFLOP/s
// of the f32 CUDA cores, against 88 MB (r, k, v, w read and y written in
// bf16, the f32 state read and written): 26 us at 3.35 TB/s.  This kernel
// does more than that, 7 hs² per step and head: it forms u_i k_i v_j for
// every (i, j) rather than the one dot product.  At a decode step (T = 1)
// the 4.2 MB of state in and out set the bound instead: 1.3 us.  What this
// simple design leaves on the table: 128 blocks of 2 warps on 132 SMs, one
// per SM, each walking 1024 dependent steps, so a multiprocessor issues
// from 2 warps where it could from 64; each step's running sum over i is a
// chain of 64 dependent adds; -fmad=false doubles the issue count of the
// products that an FMA could fuse.  The chunked form of RWKV-6 (matrix
// products over blocks of steps, on the tensor cores) is what a fast
// kernel would do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* s0;
  void* y;
  float* s_out;
  long long rs[3], ks[3], vs[3], ws[3], ys[3];  // strides of b, t, h
  int steps, H, hs;
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
__global__ void __launch_bounds__(HSP) wkv6_kernel(Args a) {
  constexpr int CH = 2048 / HSP;  // steps staged per chunk
  __shared__ __align__(16) float rs[CH][HSP];
  __shared__ __align__(16) float ks[CH][HSP];
  __shared__ __align__(16) float ws[CH][HSP];
  __shared__ __align__(16) float vs[CH][HSP];
  __shared__ __align__(16) float us[HSP];

  const int j = threadIdx.x;
  const int hs = a.hs;
  const bool live = j < hs;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const T* r = static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const T* w = static_cast<const T*>(a.w) + b * a.ws[0] + h * a.ws[2];
  T* y = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[2];
  const long long slice = (long long)blockIdx.x * hs * hs;

  us[j] = live ? a.u[h * hs + j] : 0.0f;
  float S[HSP];
#pragma unroll
  for (int i = 0; i < HSP; ++i)
    S[i] = (live && i < hs) ? a.s0[slice + (long long)i * hs + j] : 0.0f;

  for (int t0 = 0; t0 < a.steps; t0 += CH) {
    const int n = min(CH, a.steps - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int c = 0; c < n; ++c) {
      const long long t = t0 + c;
      rs[c][j] = live ? load_f32(r + t * a.rs[1] + j) : 0.0f;
      ks[c][j] = live ? load_f32(k + t * a.ks[1] + j) : 0.0f;
      ws[c][j] = live ? load_f32(w + t * a.ws[1] + j) : 0.0f;
      vs[c][j] = live ? load_f32(v + t * a.vs[1] + j) : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < HSP; ++i) {
        const float aij = ks[c][i] * vj;
        acc += rs[c][i] * (S[i] + us[i] * aij);
        S[i] = ws[c][i] * S[i] + aij;
      }
      if (live) store_f32(y + (t0 + c) * a.ys[1] + j, acc);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < HSP; ++i)
      if (i < hs) a.s_out[slice + (long long)i * hs + j] = S[i];
  }
}

template <typename T, int HSP>
int launch(const Args& a, int B, cudaStream_t stream) {
  wkv6_kernel<T, HSP><<<B * a.H, HSP, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hs(const Args& a, int B, cudaStream_t stream) {
  if (a.hs <= 32) return launch<T, 32>(a, B, stream);
  if (a.hs <= 64) return launch<T, 64>(a, B, stream);
  return launch<T, 128>(a, B, stream);
}

}  // namespace

// C interface.  dtype: 0 = float32, 1 = bfloat16.  strides: 15 element
// strides, (b, t, h) of r, k, v, w and y in that order.  Returns 0, a
// cudaError_t, or -1 for a dtype or head size the kernel does not take.
extern "C" {

int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* s0, void* y, float* s_out,
                const long long* strides, int B, int T, int H, int hs,
                int dtype, void* stream) {
  if (hs < 1 || hs > 128 || dtype < 0 || dtype > 1) return -1;
  if (B == 0 || H == 0) return 0;
  Args a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = u; a.s0 = s0;
  a.y = y; a.s_out = s_out;
  for (int i = 0; i < 3; ++i) {
    a.rs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.ws[i] = strides[9 + i];
    a.ys[i] = strides[12 + i];
  }
  a.steps = T; a.H = H; a.hs = hs;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hs<float>(a, B, st);
  return dispatch_hs<__nv_bfloat16>(a, B, st);
}

const char* wkv6_error_string(int code) {
  if (code == -1) return "unsupported dtype or head size";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
