// Flash attention for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas kernel `flash_attention` (body `_flash_kernel`) in the
// JAX package's src/repro/kernels/flash_attention.py: causal, sliding-window
// or full online-softmax attention with S == Skv (training and prefill).
// Bound to Python with ctypes by kernels/flash_attention.py.
//
// Layout.  q (B, H, S, D), k and v (B, Hkv, S, D), o (B, H, S, D), each in
// bf16 or f32 (one dtype for all four), addressed through element strides
// for b, h and s; d is contiguous.  Hkv divides H: query head h reads kv
// head h / (H / Hkv), so GQA needs no repeated copy of k and v.  D <= 256:
// the kernel is built for padded head dims DP of 32, 64, 128, 192 and 256.
//
// Work split.  One thread block per (q-tile of 64 rows, b*H + h):
// blockIdx.x = q-tile (heaviest causal tiles first), blockIdx.y = b*H + h.
// The block loops over its own 64-key tiles; the loop stands in for the
// TPU's sequential `ki` grid axis, and the running max, denominator and
// output accumulator stay in registers (f32) across it.  256 threads = 8
// warps; warp w owns query rows 8w..8w+7 of the tile; lane t owns keys t and
// t+32 of each key tile for the scores, and output dims t + 32u for u <
// DP / 32 (those below D) for the accumulator: 8 x DP / 32 f32 a thread,
// 64 at DP 256.  Q (scaled), K and V tiles are
// staged in shared memory as f32 (upcast once at load), rows of Q and K
// padded by 4 floats so that the lanes' float4 reads of 32 different K rows
// hit distinct banks; each warp writes its rows of P to shared memory and
// reads them back as broadcasts for the PV product.
//
// Skipped tiles.  The loop bounds cover only the key tiles that some row of
// the q-tile can see: up to the causal diagonal, and from the left edge of
// the window (the `run` predicate of the Pallas kernel), so the work grows
// with the real dependencies.  Inside a tile every key is masked by the
// causal and window rules and by key < S: padded key rows never attend,
// causal or not (the Pallas kernel leaves them unmasked when not causal).
//
// Arithmetic.  As the Pallas body: q * scale in f32, scores and PV in f32,
// masked scores at -1e30 with their p forced to 0, the denominator 1 where
// a row saw no key, the output rounded once to the input dtype.
//
// Bound on the H100.  Operations, at the serving shapes: one granite-3-2b
// prefill wave (B 4, H 32, Hkv 8, S 1024, D 64, causal) does
// 4*32 * 1024*1025/2 * 4*64 = 17.2 GFLOP, 17.4 us at the 989 TFLOP/s of
// the bf16 tensor cores, against 42 MB of q, k, v and o (12.5 us at
// 3.35 TB/s).  What this simple design leaves on the table: the products
// run on the CUDA cores in f32 (67 TFLOP/s peak, so 256 us at best), not on
// the tensor cores (mma.sync / wgmma); the loads are plain per-element loads
// with no cp.async or TMA pipeline, so each tile's load waits for the
// previous tile's arithmetic; the f32 tiles take 67 KB of shared memory at
// D = 64 (117 KB at D = 128), which limits a multiprocessor to 3 blocks (1),
// and 166 KB at DP 192 and 215,040 B at DP 256 (of the 232,448 B a block
// may opt into), so one block of 8 warps a multiprocessor there.
//
// Head dims 192 and 256 (nemotron-4-340b; recurrentgemma-9b's local MQA
// with a 2048-key window).  One recurrentgemma prefill wave (B 4, H 16,
// Hkv 1, S 3072, D 256, window 2048) keeps 4,195,328 (query, key) pairs a
// head: 4*16 * 4,195,328 * 4*256 = 275 GFLOP, 0.278 ms at the bf16
// tensor-core peak and at least 4.1 ms at the CUDA cores' f32 peak; the
// window's left edge skips the key tiles no row of a q-tile can see.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;  // query rows per warp
constexpr int PAD = 4;            // floats of padding per Q/K row
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // strides of b, h, s (elements)
  int H, Hkv, S, D, causal, window;      // window <= 0: no window
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int DP>
constexpr int smem_floats() {
  return BQ * (DP + PAD) + BK * (DP + PAD) + BK * DP + BQ * BK;
}

// rows x DP tile of a (S, D) slice starting at row r0, upcast to f32 and
// scaled; rows >= S and dims >= D are zero.
template <typename T, int DP, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long s_stride, int r0, int S,
                                          int D, float scale) {
  for (int i = threadIdx.x; i < 64 * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;
    float val = 0.0f;
    if (r0 + r < S && c < D) val = load_f32(src + (r0 + r) * s_stride + c) * scale;
    dst[r * STRIDE + c] = val;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(Args a) {
  constexpr int U = DP / 32;  // output dims per lane
  constexpr int QK = DP + PAD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QK;
  float* Vs = Ks + BK * QK;
  float* Ps = Vs + BK * DP;

  const int S = a.S, D = a.D;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * ROWS;

  load_tile<T, DP, QK>(Qs, q, a.qs[2], q0, S, D, a.scale);

  // the key tiles some row of this q-tile can see
  const int n_tiles = (S + BK - 1) / BK;
  const int last_row = min(q0 + BQ, S) - 1;
  const int kt_hi = a.causal ? min(n_tiles, last_row / BK + 1) : n_tiles;
  int kt_lo = 0;
  if (a.window > 0) {
    const int first_key = q0 - a.window + 1;  // row q0's oldest key
    kt_lo = first_key > 0 ? first_key / BK : 0;
  }

  float m[ROWS], l[ROWS], acc[ROWS][U];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) acc[r][u] = 0.0f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K, V, P
    load_tile<T, DP, QK>(Ks, k, a.ks[2], k0, S, D, 1.0f);
    load_tile<T, DP, DP>(Vs, v, a.vs[2], k0, S, D, 1.0f);
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * QK + d);
      const float4 kb =
          *reinterpret_cast<const float4*>(Ks + (lane + 32) * QK + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (row0 + r) * QK + d);
        s[r][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
        s[r][1] += qv.x * kb.x + qv.y * kb.y + qv.z * kb.z + qv.w * kb.w;
      }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + row0 + r;
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kpos = k0 + lane + 32 * t;
        ok[t] = kpos < S && (!a.causal || kpos <= qpos) &&
                (a.window <= 0 || kpos > qpos - a.window);
        if (!ok[t]) s[r][t] = NEG_INF;
      }
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.0f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.0f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int u = 0; u < U; ++u) acc[r][u] *= alpha;
      Ps[(row0 + r) * BK + lane] = p0;
      Ps[(row0 + r) * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc[r][u] += sum_j P[r][j] * V[j][lane + 32u]
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][U];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int u = 0; u < U; ++u) vv[t][u] = Vs[(j + t) * DP + lane + 32 * u];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p =
            *reinterpret_cast<const float4*>(Ps + (row0 + r) * BK + j);
#pragma unroll
        for (int u = 0; u < U; ++u)
          acc[r][u] += p.x * vv[0][u] + p.y * vv[1][u] + p.z * vv[2][u] +
                       p.w * vv[3][u];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= S) continue;
    const float denom = l[r] == 0.0f ? 1.0f : l[r];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = lane + 32 * u;
      if (d < D) store_f32(o + qpos * a.os[2] + d, acc[r][u] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int bytes = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
  flash_attention_kernel<T, DP><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, B, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  if (a.D <= 192) return launch<T, 192>(a, B, stream);
  return launch<T, 256>(a, B, stream);
}

}  // namespace

// C interface.  dtype: 0 = float32, 1 = bfloat16.  strides: 12 element
// strides, (b, h, s) of q, k, v and o in that order.  Returns 0, a
// cudaError_t, or -1 for a dtype, head dim or head count the kernel does
// not take.
extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int B, int H,
                           int Hkv, int S, int D, int causal, int window,
                           float scale, int dtype, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || dtype < 0 || dtype > 1)
    return -1;
  if (B == 0 || H == 0 || S == 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.H = H; a.Hkv = Hkv; a.S = S; a.D = D;
  a.causal = causal; a.window = window; a.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(a, B, st);
  return dispatch_d<__nv_bfloat16>(a, B, st);
}

const char* flash_error_string(int code) {
  if (code == -1) return "unsupported dtype, head dim or head count";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
