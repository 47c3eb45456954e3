// Block-sparse semiring SpMV for Hopper (sm_90a): the NALE array on the GPU.
//
// Two kernels, bound to Python with ctypes by kernels/bsr_spmv.py:
//
//   bsr_spmv_kernel        replaces the Pallas kernel `bsr_spmv` (body
//                          `_bsr_spmv_kernel`) in the JAX package's
//                          src/repro/kernels/bsr_spmv.py.
//   bsr_spmv_fused_kernel  replaces the Pallas kernel `bsr_spmv_fused` (body
//                          `_fused_kernel`) in the same file: one frontier-
//                          masked sweep, SpMV + update rule + changed bits +
//                          the any-changed flag in one launch.
//
// Layout (ELL of B x B tiles, all row-major and contiguous):
//   vals (R, K, B, B) f32, cols (R, K) i32, nnz (R,) i32,
//   x (Q, C, B) f32 — Q independent queries share the plan,
//   y / x_new (Q, R, B) f32.
//
// Work split.  One thread block per (row-block r, query q) — blockIdx.x = r,
// blockIdx.y = q — with B*B threads: thread t owns tile element (i, j) =
// (t / B, t % B).  It walks the true tiles k < nnz[r] only (tiles beyond
// nnz are never read: the self-timed bound), ⊕-accumulating
// vals[r,k,i,j] ⊗ x[q, cols[r,k], j] in a register.  Neighbouring threads
// read neighbouring 4-byte words of the tile and of the gathered x block,
// so every load is coalesced and each tile element is read exactly once;
// there is nothing to stage in shared memory.  The B lanes of row i are B
// consecutive lanes of one warp (B = 8, 16, 32), and a butterfly of warp
// shuffles ⊕-reduces them.  Blocks share nothing and run in any order: no
// carried accumulator, no sequential grid axis.  The fused kernel reads x
// and writes a separate x_new buffer, so a sweep stays Jacobi.
//
// Bound on the H100 (3.35 TB/s).  Bytes, not operations: each tile element
// is used by one ⊗ and one ⊕.  At the full-scale CA plan (b=16, 1,280,485
// tiles) one unfused sweep must read 1,280,485 x 1 KiB of tiles plus
// 1,280,485 x 64 B of gathered x blocks and write R x B x 4 B of y:
// about 1.4 GB, 0.42 ms.  A fused sweep reads only the rows in `act`.
//
// What this simple design leaves on the table: at b=16 the CA tiles are
// about 1.6% filled, so almost all of those bytes are padding (a CSR SpMV
// of the same graph reads about 70 MB); the block count per sweep is
// R x Q with only B*B threads each, and no block overlaps its next tile's
// load with the current tile's arithmetic (no cp.async/TMA pipeline); an
// inactive row of the fused kernel still costs a block launch.
//
// Arithmetic.  Every rounding is spelled out: the ⊗/⊕ use __fmul_rn and
// __fadd_rn, so no product and sum are contracted into an FMA, and the
// PageRank rules compute (1-d)*inv_n + d*y as fma(d, y, (1-d)*inv_n) with
// __fmaf_rn, the one contraction XLA makes on the CPU for the JAX
// package's expression (the plain torch version reproduces it in float64).
// The build passes -fmad=false and never --use_fast_math, which would
// break the inf arithmetic of min_plus and min_select.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Ring { PLUS_TIMES = 0, MIN_PLUS = 1, MAX_MIN = 2, MIN_SELECT = 3 };
enum Rule { RELAX = 0, PAGERANK = 1, PAGERANK_DELTA = 2, KCORE = 3,
            IDENTITY = 4 };

template <int RING>
__device__ __forceinline__ float ring_zero() {
  return (RING == PLUS_TIMES || RING == MAX_MIN) ? 0.0f : INFINITY;
}

// ⊕
template <int RING>
__device__ __forceinline__ float ring_add(float a, float b) {
  if (RING == PLUS_TIMES) return __fadd_rn(a, b);
  if (RING == MAX_MIN) return fmaxf(a, b);
  return fminf(a, b);  // MIN_PLUS, MIN_SELECT
}

// ⊗ of an edge weight w and a source value xv
template <int RING>
__device__ __forceinline__ float ring_mul(float w, float xv) {
  if (RING == PLUS_TIMES) return __fmul_rn(w, xv);
  if (RING == MIN_PLUS) return __fadd_rn(w, xv);
  if (RING == MAX_MIN) return fminf(w, xv);
  return isfinite(w) ? xv : INFINITY;  // MIN_SELECT: select-right on edges
}

template <int RING>
__device__ __forceinline__ bool ring_improves(float n, float o) {
  if (RING == PLUS_TIMES) return n != o;
  if (RING == MAX_MIN) return n > o;
  return n < o;
}

// Shared by both kernels: gather the x block of each true tile, combine it
// with the tile, ⊕-accumulate over k in a register, then ⊕-reduce the B
// lanes of the row.  Every lane of row i returns y[q, r, i].
template <int B, int RING>
__device__ __forceinline__ float row_block_reduce(
    const float* __restrict__ vals_r, const int* __restrict__ cols_r,
    int n, const float* __restrict__ xq, int t, int j) {
  float acc = ring_zero<RING>();
  for (int k = 0; k < n; ++k) {
    const int c = __ldg(cols_r + k);
    const float w = __ldg(vals_r + (size_t)k * (B * B) + t);
    const float xv = __ldg(xq + (size_t)c * B + j);
    acc = ring_add<RING>(acc, ring_mul<RING>(w, xv));
  }
#pragma unroll
  for (int off = B / 2; off > 0; off >>= 1)
    acc = ring_add<RING>(acc, __shfl_xor_sync(0xffffffffu, acc, off, B));
  return acc;
}

__device__ __forceinline__ int clamp_nnz(int n, int K) {
  return n < 0 ? 0 : (n > K ? K : n);
}

template <int B, int RING>
__global__ void __launch_bounds__(B * B)
bsr_spmv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const int* __restrict__ nnz, const float* __restrict__ x,
                float* __restrict__ y, int R, int K, int C) {
  const int r = blockIdx.x, q = blockIdx.y;
  const int t = threadIdx.x, i = t / B, j = t % B;
  const float acc = row_block_reduce<B, RING>(
      vals + (size_t)r * K * (B * B), cols + (size_t)r * K,
      clamp_nnz(nnz[r], K), x + (size_t)q * C * B, t, j);
  if (j == 0) y[((size_t)q * R + r) * B + i] = acc;
}

// The engine's update rules (core/engine._apply), one element at a time.
template <int RING>
__device__ __forceinline__ void apply_rule(int rule, float y, float xo,
                                           bool vg, float d, float tol,
                                           float inv_n, float* xn_out,
                                           bool* imp_out) {
  float xn;
  bool imp;
  switch (rule) {
    case RELAX:
      xn = ring_add<RING>(y, xo);
      imp = ring_improves<RING>(xn, xo);
      break;
    case PAGERANK:
      xn = __fmaf_rn(d, y, __fmul_rn(__fsub_rn(1.0f, d), inv_n));
      if (!vg) xn = 0.0f;
      imp = fabsf(__fsub_rn(xn, xo)) > tol;
      break;
    case PAGERANK_DELTA: {
      const float cand =
          __fmaf_rn(d, y, __fmul_rn(__fsub_rn(1.0f, d), inv_n));
      imp = __fsub_rn(cand, xo) > tol;
      xn = imp ? cand : xo;
      break;
    }
    case KCORE:
      xn = (xo > 0.0f && y >= d) ? xo : 0.0f;
      imp = xn < xo;
      break;
    default:  // IDENTITY
      xn = vg ? y : xo;
      imp = ring_improves<RING>(xn, xo);
      break;
  }
  *xn_out = vg ? xn : xo;
  *imp_out = imp && vg;
}

// x_new must hold a copy of xg and changed/conv zeros before the launch:
// rows outside `act` exit at once and so pass through bitwise.
template <int B, int RING>
__global__ void __launch_bounds__(B * B)
bsr_spmv_fused_kernel(const float* __restrict__ vals,
                      const int* __restrict__ cols,
                      const int* __restrict__ nnz,
                      const float* __restrict__ x,
                      const float* __restrict__ xg,
                      const bool* __restrict__ valid,
                      const bool* __restrict__ act, float damping, float tol,
                      float inv_n, int rule, float* __restrict__ x_new,
                      bool* __restrict__ changed, int* __restrict__ conv,
                      int R, int K, int C) {
  const int r = blockIdx.x, q = blockIdx.y;
  const size_t qr = (size_t)q * R + r;
  if (!act[qr]) return;
  const int t = threadIdx.x, i = t / B, j = t % B;
  const float y = row_block_reduce<B, RING>(
      vals + (size_t)r * K * (B * B), cols + (size_t)r * K,
      clamp_nnz(nnz[r], K), x + (size_t)q * C * B, t, j);
  bool imp = false;
  if (j == 0) {
    const size_t e = qr * B + i;
    float xn;
    apply_rule<RING>(rule, y, xg[e], valid[(size_t)r * B + i], damping, tol,
                     inv_n, &xn, &imp);
    x_new[e] = xn;
  }
  // one write per block: a flag per improved row would put up to R*B
  // atomics on the one conv word; a block skips its atomic once the word
  // is already set
  if (__syncthreads_or(imp) && t == 0) {
    changed[qr] = true;
    if (*(volatile int*)(conv + q) == 0) atomicOr(conv + q, 1);
  }
}

template <int B, int RING>
int launch_spmv(const float* vals, const int* cols, const int* nnz,
                const float* x, float* y, int R, int K, int C, int Q,
                cudaStream_t stream) {
  bsr_spmv_kernel<B, RING><<<dim3(R, Q), B * B, 0, stream>>>(
      vals, cols, nnz, x, y, R, K, C);
  return (int)cudaGetLastError();
}

template <int B, int RING>
int launch_fused(const float* vals, const int* cols, const int* nnz,
                 const float* x, const float* xg, const bool* valid,
                 const bool* act, float damping, float tol, float inv_n,
                 int rule, float* x_new, bool* changed, int* conv, int R,
                 int K, int C, int Q, cudaStream_t stream) {
  bsr_spmv_fused_kernel<B, RING><<<dim3(R, Q), B * B, 0, stream>>>(
      vals, cols, nnz, x, xg, valid, act, damping, tol, inv_n, rule, x_new,
      changed, conv, R, K, C);
  return (int)cudaGetLastError();
}

// one instantiation per (B, ring); the rule is a uniform runtime branch
#define BSR_DISPATCH(FN, ...)                                              \
  switch (B * 4 + ring) {                                                  \
    case 8 * 4 + PLUS_TIMES: return FN<8, PLUS_TIMES>(__VA_ARGS__);        \
    case 8 * 4 + MIN_PLUS: return FN<8, MIN_PLUS>(__VA_ARGS__);            \
    case 8 * 4 + MAX_MIN: return FN<8, MAX_MIN>(__VA_ARGS__);              \
    case 8 * 4 + MIN_SELECT: return FN<8, MIN_SELECT>(__VA_ARGS__);        \
    case 16 * 4 + PLUS_TIMES: return FN<16, PLUS_TIMES>(__VA_ARGS__);      \
    case 16 * 4 + MIN_PLUS: return FN<16, MIN_PLUS>(__VA_ARGS__);          \
    case 16 * 4 + MAX_MIN: return FN<16, MAX_MIN>(__VA_ARGS__);            \
    case 16 * 4 + MIN_SELECT: return FN<16, MIN_SELECT>(__VA_ARGS__);      \
    case 32 * 4 + PLUS_TIMES: return FN<32, PLUS_TIMES>(__VA_ARGS__);      \
    case 32 * 4 + MIN_PLUS: return FN<32, MIN_PLUS>(__VA_ARGS__);          \
    case 32 * 4 + MAX_MIN: return FN<32, MAX_MIN>(__VA_ARGS__);            \
    case 32 * 4 + MIN_SELECT: return FN<32, MIN_SELECT>(__VA_ARGS__);      \
    default: return -1;                                                    \
  }

bool bad_ring(int ring) { return ring < 0 || ring > 3; }

}  // namespace

// C interface.  Each returns 0, a cudaError_t from the launch, or -1 for a
// block size / ring / rule the kernels do not implement.
extern "C" {

int bsr_spmv_launch(const float* vals, const int* cols, const int* nnz,
                    const float* x, float* y, int R, int K, int C, int B,
                    int Q, int ring, void* stream) {
  if (bad_ring(ring)) return -1;
  if (R == 0 || Q == 0) return 0;
  BSR_DISPATCH(launch_spmv, vals, cols, nnz, x, y, R, K, C, Q,
               (cudaStream_t)stream)
}

int bsr_spmv_fused_launch(const float* vals, const int* cols, const int* nnz,
                          const float* x, const float* xg, const bool* valid,
                          const bool* act, float damping, float tol,
                          float inv_n, float* x_new, bool* changed,
                          int* conv, int R, int K, int C, int B, int Q,
                          int ring, int rule, void* stream) {
  if (bad_ring(ring) || rule < RELAX || rule > IDENTITY) return -1;
  if (R == 0 || Q == 0) return 0;
  BSR_DISPATCH(launch_fused, vals, cols, nnz, x, xg, valid, act, damping,
               tol, inv_n, rule, x_new, changed, conv, R, K, C, Q,
               (cudaStream_t)stream)
}

const char* bsr_error_string(int code) {
  if (code == -1) return "unsupported block size, semiring or update rule";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
