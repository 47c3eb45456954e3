// The gradient of the RWKV-6 WKV recurrence in its chunked form, on
// Hopper's tensor cores (sm_90a), for bf16 r, k, v, w, dy at head size 64.
//
// Replaces no Pallas kernel: the JAX package trains through XLA's
// autodiff of its `lax.scan` (`_wkv_scan`, src/repro/models/rwkv.py).  It
// differentiates the chunked forward (csrc/wkv6_chunked.cu) in that
// kernel's blocking; kernels/wkv6.py (`wkv6_train`) launches it for every
// backward whose forward took the chunked route (bf16, hs 64, T >= 128)
// and csrc/wkv6_backward.cu for the rest.  Its plain version is
// ref.wkv6_chunked_heads_backward_ref.
//
// The algebra.  Per sub-chunk of 16 steps (the last padded with r = k =
// v = dy = 0, w = 1), with S the state at its start, E, F, G the products
// of w before, after and over each step, A the diagonal block (all as the
// forward defines them), dY the sub-chunk's dy and Gend = ∂L/∂S at its end
// (ds_last for the last one):
//   ∂L/∂S = G ⊙_rows Gend + (r E)ᵀ dY    (carried back; ds0 at step 0)
//   dV    = Aᵀ dY + (k F) Gend,   dA = tril(dY Vᵀ),
//   d(rE) = dY Sᵀ,   d(kF) = V Gendᵀ,   dG = Σ_j Gend ⊙ S,
//   dr = d(rE) E + the block's,  dk = d(kF) F + the block's,
//   du = Σ_{b,t} dA_tt r_t ⊙ k_t.
// dw: w enters E, F, G and the block's pairwise decays P(s, t) = Π_{s<m<t}
// w_m.  The derivative of a product of w by one factor is the product of
// the others, which prefix and suffix products give with no division:
//   dw_t = E_t (R_t + F_t dG) + F_t L_t + Σ_{q>t} r_q P(t, q) X_{q,t},
//   R_t = Σ_{q>t} d(rE)_q r_q P(t, q),  L_t = Σ_{s<t} d(kF)_s k_s P(s, t),
//   X_{q,t} = Σ_{s<t} dA_qs k_s P(s, t),
// R carried down the sub-chunk, L and X up it (X_{q,t+1} = w_t X_{q,t} +
// dA_qt k_t, and the block's dr_t = X_{t,t} + dA_tt u k_t).  No logarithm
// and no exponential (they overflow f32 on real decays: wkv6_chunked.cu's
// header), no division by w: w = 0 gives exact, finite gradients.
//
// Precision.  As the forward: every product runs as mma.sync m16n8k16,
// bf16 operands, f32 accumulators; an f32 operand (r E, k F, A, S, Gend)
// is split into a bf16 high part and a bf16 remainder and the product
// taken as hi·hi + lo·hi + hi·lo (dy, v and k are bf16 already; dY Vᵀ is
// exact).  The state and ∂L/∂S are carried in f32.  The element-by-element
// parts (the diagonal block, its gradient, the prefix and suffix sums) run
// on the CUDA cores in f32.  No atomics: the same inputs give the same
// bits.  Against the plain version only the order of the sums differs.
//
// Work split.  Two passes and du's batch sum, one stream:
//   1. wkv6_backward_chunked_states_kernel, one block of 4 warps per (b,
//      h): the forward's state recurrence (the forward saves no states),
//      writing S at the start of every sub-chunk to the scratch `ckpt`
//      (T/16 states of hs² f32 a (b, h): 268 MB at B 8, T 1024, H 32, less
//      than the recurrent backward's 335.5 MB).  k, w, v arrive by TMA.
//   2. wkv6_backward_chunked_kernel, one block of 8 warps per (b, h),
//      blockIdx.x = b·H + h, 217 KB of shared memory, walking 64-step
//      chunks from the last to the first, r, k, w, v and dy of the next
//      one arriving by TMA into a ring of two while this one computes:
//      a. E and r E, F and k F, split (warps 0-3 | 4-7), G;
//      b. A (the forward's diagonal blocks, CUDA cores) and dA = dY Vᵀ;
//      c. for each sub-chunk from the last: warps 0-3 own ∂L/∂S as mma
//         accumulators (16 v columns each), read S from `ckpt` (loaded one
//         sub-chunk ahead), take their part of dG, store S and Gend split
//         and step ∂L/∂S back; then every warp takes 8 columns of d(rE),
//         d(kF) and dV (dV written out);
//      d. thread (d, sub-chunk): the diagonal block's gradient, R, L and
//         the outputs dr, dk, dw, and its part of du.
//   3. wkv6_du_reduce_kernel: du = Σ_b of the (b, h) partials in ascending
//      b, as csrc/wkv6_backward.cu's.
//
// Bound on the H100.  At rwkv6-1.6b's training shape (B 8, T 1024, H 32,
// hs 64) the function moves 314 MB (r, k, v, w, dy read and dr, dk, dv, dw
// written in bf16, u, s0, ds_last, ds0 and du in f32): 0.094 ms at 3.35
// TB/s.  Its matrix products, one each (2·16·hs² for (r E)ᵀ dY, d(rE),
// d(kF), (k F) Gend and the state pass's (k F)ᵀ V; 2·hs for dA and
// Aᵀ dY over A's 136 entries, a sub-chunk and head, with the diagonal
// block and its gradient) are 12.3 GFLOP, 0.012 ms at the 989 TFLOP/s of
// the bf16 tensor cores; so bytes bound it.  What this design leaves on
// the table: the states round-trip through device memory (268 MB written,
// read back: more than the function's own bytes); the sub-chunks' steps
// (c) follow one another behind two block barriers each, half the warps
// idle in the first; the staged rows are 128 bytes apart, so ldmatrix
// reads them with bank conflicts (no TMA swizzle); the split products
// triple the tensor-core work; mma.sync, not wgmma; 256 blocks of one per
// SM leave a second wave of 124 on 132 SMs (the v columns are not split
// over two blocks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int HS = 64;      // head size
constexpr int L = 64;       // steps per staged chunk
constexpr int SUB = 16;     // steps per sub-chunk
constexpr int NSUB = L / SUB;
constexpr int NT = 2;       // n-tiles of 8 v columns per ∂L/∂S warp
constexpr int MMA_WARPS = HS / (8 * NT);
constexpr int LD = 72;      // bf16 row strides of ldmatrix tiles (144 B,
constexpr int LDA = 24;     // 48 B): 8 rows hit 8 distinct 16-byte bank
                            // groups
constexpr int LDF = 72;     // f32 row stride of d(rE), d(kF)
// pass 1
constexpr int S_THREADS = 128;
constexpr int S_NBUF = 3;
// pass 2
constexpr int THREADS = 256;
constexpr int NBUF = 2;

typedef __nv_bfloat16 bf16;

struct SmemStates {
  bf16 k[S_NBUF][L][HS];           // staged chunks, one TMA box each
  bf16 w[S_NBUF][L][HS];
  bf16 v[S_NBUF][L][HS];
  bf16 kf[2][L][LD];               // k F, [hi/lo][step][d]
  float g[NSUB][HS];               // G of each sub-chunk
  unsigned long long full[S_NBUF]; // mbarriers: a staged chunk landed
};

struct __align__(128) Smem {
  bf16 r[NBUF][L][HS];             // staged chunks, one TMA box each
  bf16 k[NBUF][L][HS];
  bf16 w[NBUF][L][HS];
  bf16 v[NBUF][L][HS];
  bf16 dy[NBUF][L][HS];
  bf16 re[2][L][LD];               // r E, [hi/lo][step][d]
  bf16 kf[2][L][LD];               // k F
  bf16 sb[2][HS][LD];              // S of one sub-chunk, [hi/lo][d][v]
  bf16 gb[2][HS][LD];              // Gend of one sub-chunk
  float ap[2][L][SUB];             // diagonal blocks, one half of d each
  bf16 ab[2][L][LDA];              // the diagonal blocks summed, split
  float da[L][SUB];                // dA, 0 above the diagonal
  float dre[L][LDF];               // d(rE)
  float dkf[L][LDF];               // d(kF)
  float g[NSUB][HS];               // G of each sub-chunk
  float cpart[NSUB][MMA_WARPS][HS];// dG, by ∂L/∂S warp
  float dupart[NSUB][HS];          // du, by sub-chunk slot
  unsigned long long full[NBUF];
};

struct Args {
  const float* u;
  const float* s0;
  const float* ds_last;
  bf16* dr;
  bf16* dk;
  bf16* dv;
  bf16* dw;
  float* du_part;
  float* ds0;
  float* ckpt;  // (B·H, ceil(T / 16), hs, hs), [sub-chunk][d][v]
  int steps, H;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box of a 4-D map (d, t, h, b) at (0, t0, h, b) into
// shared memory at dst, counted in bytes on `bar`; rows past T read 0
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int t0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(t0),
      "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* d, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* d, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* d, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(d[0]), "=r"(d[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* d, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(d[0]), "=r"(d[1])
      : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16; c 16x8 f32
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) → the bf16 pairs hi = bf16(x), lo = bf16(x − hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ void store_split2(bf16* hi, bf16* lo, float x0,
                                             float x1) {
  uint32_t h, l;
  split2(x0, x1, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// lane's 8 values of d of a staged bf16 row: d = dbase + {0, 1, 2, 3} and
// dbase + 16 + {0, 1, 2, 3}
__device__ __forceinline__ void load8(const bf16* row, int dbase, float* x) {
  const uint2 a = *reinterpret_cast<const uint2*>(row + dbase);
  const uint2 c = *reinterpret_cast<const uint2*>(row + dbase + 16);
  const uint32_t u[4] = {a.x, a.y, c.x, c.y};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[2 * q] = __uint_as_float(u[q] << 16);
    x[2 * q + 1] = __uint_as_float(u[q] & 0xFFFF0000u);
  }
}

// Lane's part of Σ_d (r_jd u_d) k_jd, the diagonal entry (j, j)
__device__ __forceinline__ float u_term(const float* rj, const float* ur,
                                        const float* kj) {
  float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x0 = fmaf(rj[e] * ur[e], kj[e], x0);
    x1 = fmaf(rj[4 + e] * ur[4 + e], kj[4 + e], x1);
  }
  return x0 + x1;
}

// The forward's diagonal block entries (i, j) for j = jj and j = jj + 8
// over this lane's 8 values of d, every row i (csrc/wkv6_chunked.cu's
// diag_block, reading the staged bf16 rows of r and w): k_j carried down
// the sub-chunk and scaled by w_i once row i has read it; the 4 lanes of
// a row-quarter summed by shuffles, the two halves of d when the block is
// read.
__device__ __forceinline__ void diag_block(const bf16 (*r)[HS],
                                           const bf16 (*k)[HS],
                                           const bf16 (*w)[HS], int t0,
                                           int jj, int qd, int dbase,
                                           const float* ur, float* apart) {
  float k1[8], k2[8], rj[8];  // k_j carried down, for j = jj and jj + 8
  load8(&k[t0 + jj][0], dbase, k1);
  load8(&k[t0 + jj + 8][0], dbase, k2);
  load8(&r[t0 + jj][0], dbase, rj);
  const float u1 = u_term(rj, ur, k1);
  load8(&r[t0 + jj + 8][0], dbase, rj);
  const float u2 = u_term(rj, ur, k2);
  if (qd == 0) {  // rows 0-7 lie above the diagonal for j >= 8
#pragma unroll
    for (int i = 0; i < 8; ++i) apart[(t0 + i) * SUB + jj + 8] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    float rv[8], wv[8];
    load8(&r[t0 + i][0], dbase, rv);
    load8(&w[t0 + i][0], dbase, wv);
    {  // key j = jj
      float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x0 = fmaf(rv[e], k1[e], x0);
        x1 = fmaf(rv[4 + e], k1[4 + e], x1);
      }
      float acc = i > jj ? x0 + x1 : (i == jj ? u1 : 0.0f);
      if (i > jj) {  // row i has read k_j: carry it past w_i
#pragma unroll
        for (int e = 0; e < 8; ++e) k1[e] *= wv[e];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (qd == 0) apart[(t0 + i) * SUB + jj] = acc;
    }
    if (i >= 8) {  // key j = jj + 8
      const int j2 = jj + 8;
      float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x0 = fmaf(rv[e], k2[e], x0);
        x1 = fmaf(rv[4 + e], k2[4 + e], x1);
      }
      float acc = i > j2 ? x0 + x1 : (i == j2 ? u2 : 0.0f);
      if (i > j2) {
#pragma unroll
        for (int e = 0; e < 8; ++e) k2[e] *= wv[e];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (qd == 0) apart[(t0 + i) * SUB + j2] = acc;
    }
  }
}

// Staged rows past T arrive as zeros; their w are set to 1, so they add
// nothing and decay nothing.
__device__ __forceinline__ void pad_w(bf16 (*w)[HS], int n, int tid,
                                      int threads) {
  for (int idx = tid; idx < (L - n) * HS / 2; idx += threads)
    reinterpret_cast<uint32_t*>(&w[n][0])[idx] = 0x3F803F80u;
}

struct StateMaps {
  CUtensorMap k, w, v;
};

struct Maps {
  CUtensorMap r, k, w, v, dy;
};

// ---- pass 1: the state at the start of every sub-chunk ---------------------

__device__ __forceinline__ void stage_states(SmemStates& s, const StateMaps& m,
                                             int b, int h, int c, int bb) {
  const uint32_t bar = smem_addr(&s.full[bb]);
  mbar_expect_tx(bar, 3u * L * HS * 2);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  tma_load(&s.k[bb][0][0], &m.k, bar, c * L, h, b);
  tma_load(&s.w[bb][0][0], &m.w, bar, c * L, h, b);
  tma_load(&s.v[bb][0][0], &m.v, bar, c * L, h, b);
}

// Per chunk: warp p forms F and k F (split) of sub-chunk p and its G,
// thread pair of d; then warp w, owning v columns 16w..16w+15 of S as mma
// accumulators, writes S at each sub-chunk's start to ckpt and steps it,
// S ← G ⊙ S + (k F)ᵀ V, as the forward does.
__global__ void __launch_bounds__(S_THREADS, 2)
    wkv6_backward_chunked_states_kernel(const __grid_constant__ StateMaps maps,
                                        Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemStates& s = *reinterpret_cast<SmemStates*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const long long slice = (long long)blockIdx.x * HS * HS;
  const int nchunks = (a.steps + L - 1) / L;
  const int nsub = (a.steps + SUB - 1) / SUB;
  float* ckpt = a.ckpt + (long long)blockIdx.x * nsub * HS * HS;
  const int pd = 2 * lane, v0 = 16 * warp;

  float sacc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = v0 + 8 * nt + 2 * tq;
      const float2 lo = *reinterpret_cast<const float2*>(
          &a.s0[slice + (16 * mt + g) * HS + col]);
      const float2 hi = *reinterpret_cast<const float2*>(
          &a.s0[slice + (16 * mt + g + 8) * HS + col]);
      sacc[mt][nt][0] = lo.x; sacc[mt][nt][1] = lo.y;
      sacc[mt][nt][2] = hi.x; sacc[mt][nt][3] = hi.y;
    }

  if (tid == 0) {
    for (int i = 0; i < S_NBUF; ++i) mbar_init(smem_addr(&s.full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < S_NBUF - 1 && c < nchunks; ++c)
      stage_states(s, maps, b, h, c, c);
  }

  for (int c = 0; c < nchunks; ++c) {
    const int bb = c % S_NBUF;
    mbar_wait(smem_addr(&s.full[bb]), (c / S_NBUF) & 1);
    const int n = min(L, a.steps - c * L);
    if (n < L) pad_w(s.w[bb], n, tid, S_THREADS);
    __syncthreads();  // chunk c staged; chunk c − 1 fully done
    if (tid == 0 && c + S_NBUF - 1 < nchunks)
      stage_states(s, maps, b, h, c + S_NBUF - 1, (c + S_NBUF - 1) % S_NBUF);

    {  // F and k F of sub-chunk `warp`, G
      const int t0 = SUB * warp;
      float2 f = make_float2(1.0f, 1.0f);
#pragma unroll
      for (int t = SUB - 1; t >= 0; --t) {  // F_t: the w after t
        const float2 kv = bf2(&s.k[bb][t0 + t][pd]);
        const float2 wv = bf2(&s.w[bb][t0 + t][pd]);
        store_split2(&s.kf[0][t0 + t][pd], &s.kf[1][t0 + t][pd],
                     kv.x * f.x, kv.y * f.y);
        f.x = f.x * wv.x;
        f.y = f.y * wv.y;
      }
      *reinterpret_cast<float2*>(&s.g[warp][pd]) = f;
    }
    __syncthreads();

#pragma unroll 1
    for (int p = 0; p < NSUB; ++p) {
      const int sc = c * NSUB + p;
      if (sc >= nsub) break;
      float* dst = ckpt + (long long)sc * HS * HS;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = v0 + 8 * nt + 2 * tq;
          *reinterpret_cast<float2*>(&dst[(16 * mt + g) * HS + col]) =
              make_float2(sacc[mt][nt][0], sacc[mt][nt][1]);
          *reinterpret_cast<float2*>(&dst[(16 * mt + g + 8) * HS + col]) =
              make_float2(sacc[mt][nt][2], sacc[mt][nt][3]);
        }
      if (sc + 1 == nsub) break;  // the final state is not needed
      const int t0 = SUB * p;
      uint32_t vb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ldsm_x2_trans(vb[nt], &s.v[bb][t0 + (lane & 15)][v0 + 8 * nt]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t kh[4], kl[4];  // (k F)ᵀ, m-tile mt of d, as A operand
        const int kr = t0 + (lane & 7) + 8 * (lane >> 4);
        const int kc = 16 * mt + 8 * ((lane >> 3) & 1);
        ldsm_x4_trans(kh, &s.kf[0][kr][kc]);
        ldsm_x4_trans(kl, &s.kf[1][kr][kc]);
        const float g0 = s.g[p][16 * mt + g], g1 = s.g[p][16 * mt + g + 8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          sacc[mt][nt][0] *= g0;
          sacc[mt][nt][1] *= g0;
          sacc[mt][nt][2] *= g1;
          sacc[mt][nt][3] *= g1;
          mma(sacc[mt][nt], kh, vb[nt]);
          mma(sacc[mt][nt], kl, vb[nt]);
        }
      }
    }
  }
}

// ---- pass 2: the gradient, chunk by chunk from the last ---------------------

__device__ __forceinline__ void stage(Smem& s, const Maps& m, int b, int h,
                                      int c, int bb) {
  const uint32_t bar = smem_addr(&s.full[bb]);
  mbar_expect_tx(bar, 5u * L * HS * 2);
  // this buffer's earlier generic reads before the async-proxy writes
  // (ordered by the block barrier before the call)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  tma_load(&s.r[bb][0][0], &m.r, bar, c * L, h, b);
  tma_load(&s.k[bb][0][0], &m.k, bar, c * L, h, b);
  tma_load(&s.w[bb][0][0], &m.w, bar, c * L, h, b);
  tma_load(&s.v[bb][0][0], &m.v, bar, c * L, h, b);
  tma_load(&s.dy[bb][0][0], &m.dy, bar, c * L, h, b);
}

// S of sub-chunk `sc` from the checkpoint, in the accumulators' layout
__device__ __forceinline__ void load_state(float (*sp)[NT][4],
                                           const float* ckpt, int sc, int v0,
                                           int g, int tq) {
  const float* src = ckpt + (long long)sc * HS * HS;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = v0 + 8 * nt + 2 * tq;
      const float2 lo =
          *reinterpret_cast<const float2*>(&src[(16 * mt + g) * HS + col]);
      const float2 hi =
          *reinterpret_cast<const float2*>(&src[(16 * mt + g + 8) * HS + col]);
      sp[mt][nt][0] = lo.x; sp[mt][nt][1] = lo.y;
      sp[mt][nt][2] = hi.x; sp[mt][nt][3] = hi.y;
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    wkv6_backward_chunked_kernel(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the TMA boxes want 128-byte aligned destinations
  Smem& s = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row, column pair
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const long long slice = (long long)blockIdx.x * HS * HS;
  const int nchunks = (a.steps + L - 1) / L;
  const int nsub = (a.steps + SUB - 1) / SUB;
  const float* ckpt = a.ckpt + (long long)blockIdx.x * nsub * HS * HS;
  // element (b, t, h, 0) of the outputs is at ob + t·orow
  const long long orow = (long long)a.H * HS;
  const long long ob = (long long)b * a.steps * orow + (long long)h * HS;

  // a: thread (pair of d, sub-chunk); warps 0-3 take E, 4-7 take F
  const int pd = 2 * lane, pp = warp & 3;
  // b: warp (sub-chunk, half of d) for the diagonal blocks; lane (j,
  // quarter of the half), as the forward
  const int dp = warp & 3, dhalf = warp >> 2, jj = lane >> 2, qd = lane & 3;
  const int dbase = 32 * dhalf + 4 * qd;
  float ur[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ur[e] = a.u[h * HS + dbase + e];
    ur[4 + e] = a.u[h * HS + dbase + 16 + e];
  }
  // c: warps below MMA_WARPS own ∂L/∂S, rows d = 16 mt + (g, g + 8),
  // columns v = v0 + 8 nt + 2 tq (+1); every warp 8 columns n0.. of the
  // sub-chunk's products
  const int v0 = 16 * warp, n0 = 8 * warp;
  const bool owner = warp < MMA_WARPS;
  float gacc[4][NT][4];
  if (owner) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = v0 + 8 * nt + 2 * tq;
        const float2 lo = *reinterpret_cast<const float2*>(
            &a.ds_last[slice + (16 * mt + g) * HS + col]);
        const float2 hi = *reinterpret_cast<const float2*>(
            &a.ds_last[slice + (16 * mt + g + 8) * HS + col]);
        gacc[mt][nt][0] = lo.x; gacc[mt][nt][1] = lo.y;
        gacc[mt][nt][2] = hi.x; gacc[mt][nt][3] = hi.y;
      }
  }
  // d: thread (d, sub-chunk slot)
  const int cd_ = tid & (HS - 1), cp_ = tid >> 6;
  const float ud = a.u[h * HS + cd_];
  float du_acc = 0.0f;

  if (tid == 0) {
    for (int i = 0; i < NBUF; ++i) mbar_init(smem_addr(&s.full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && nchunks > 0) stage(s, maps, b, h, nchunks - 1, 0);

  for (int i = 0; i < nchunks; ++i) {
    const int c = nchunks - 1 - i, bb = i % NBUF;
    const int last_p = min(NSUB, nsub - c * NSUB) - 1;  // real sub-chunks
    float snext[4][NT][4];  // S of the next sub-chunk to take, loaded early
    if (owner) load_state(snext, ckpt, c * NSUB + last_p, v0, g, tq);
    mbar_wait(smem_addr(&s.full[bb]), (i / NBUF) & 1);
    const int n = min(L, a.steps - c * L);
    if (n < L) pad_w(s.w[bb], n, tid, THREADS);
    __syncthreads();  // chunk c staged; chunk c + 1 fully done
    if (tid == 0 && c > 0) stage(s, maps, b, h, c - 1, (i + 1) % NBUF);

    // ---- a. E and r E, G | F and k F --------------------------------------
    {
      const int t0 = SUB * pp;
      float2 wv[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) wv[t] = bf2(&s.w[bb][t0 + t][pd]);
      if (warp < 4) {
        float2 e = make_float2(1.0f, 1.0f);
#pragma unroll
        for (int t = 0; t < SUB; ++t) {  // E_t: the w before t
          const float2 rv = bf2(&s.r[bb][t0 + t][pd]);
          store_split2(&s.re[0][t0 + t][pd], &s.re[1][t0 + t][pd],
                       rv.x * e.x, rv.y * e.y);
          e.x = e.x * wv[t].x;
          e.y = e.y * wv[t].y;
        }
        *reinterpret_cast<float2*>(&s.g[pp][pd]) = e;
      } else {
        float2 f = make_float2(1.0f, 1.0f);
#pragma unroll
        for (int t = SUB - 1; t >= 0; --t) {  // F_t: the w after t
          const float2 kv = bf2(&s.k[bb][t0 + t][pd]);
          store_split2(&s.kf[0][t0 + t][pd], &s.kf[1][t0 + t][pd],
                       kv.x * f.x, kv.y * f.y);
          f.x = f.x * wv[t].x;
          f.y = f.y * wv[t].y;
        }
      }
    }

    // ---- b. dA = tril(dY Vᵀ), warp (sub-chunk, 8 columns); A -------------
    {
      const int t0 = SUB * (warp >> 1), c0 = 8 * (warp & 1);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4], bfr[2];
        ldsm_x4(af, &s.dy[bb][t0 + (lane & 15)][16 * kk + (lane >> 4) * 8]);
        ldsm_x2(bfr, &s.v[bb][t0 + c0 + (lane & 7)]
                          [16 * kk + 8 * ((lane >> 3) & 1)]);
        mma(acc, af, bfr);
      }
      const int col = c0 + 2 * tq;
      s.da[t0 + g][col] = col <= g ? acc[0] : 0.0f;
      s.da[t0 + g][col + 1] = col + 1 <= g ? acc[1] : 0.0f;
      s.da[t0 + g + 8][col] = col <= g + 8 ? acc[2] : 0.0f;
      s.da[t0 + g + 8][col + 1] = col + 1 <= g + 8 ? acc[3] : 0.0f;
    }
    diag_block(s.r[bb], s.k[bb], s.w[bb], SUB * dp, jj, qd, dbase, ur,
               &s.ap[dhalf][0][0]);
    __syncthreads();
    {  // the two halves of d summed and split, once for every warp
      const int row = tid >> 2, col = 4 * (tid & 3);
      const float4 x = *reinterpret_cast<const float4*>(&s.ap[0][row][col]);
      const float4 z = *reinterpret_cast<const float4*>(&s.ap[1][row][col]);
      uint32_t h0, l0, h1, l1;
      split2(x.x + z.x, x.y + z.y, h0, l0);
      split2(x.z + z.z, x.w + z.w, h1, l1);
      *reinterpret_cast<uint2*>(&s.ab[0][row][col]) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(&s.ab[1][row][col]) = make_uint2(l0, l1);
    }
    __syncthreads();

    // ---- c. per sub-chunk from the last ------------------------------------
#pragma unroll 1
    for (int p = last_p; p >= 0; --p) {
      const int t0 = SUB * p;
      if (owner) {
        float sp[4][NT][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[mt][nt][e] = snext[mt][nt][e];
        if (p > 0) load_state(snext, ckpt, c * NSUB + p - 1, v0, g, tq);
        // dG's part over this warp's columns; S and Gend split
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            x0 += gacc[mt][nt][0] * sp[mt][nt][0] +
                  gacc[mt][nt][1] * sp[mt][nt][1];
            x1 += gacc[mt][nt][2] * sp[mt][nt][2] +
                  gacc[mt][nt][3] * sp[mt][nt][3];
            const int col = v0 + 8 * nt + 2 * tq, r0 = 16 * mt + g;
            store_split2(&s.sb[0][r0][col], &s.sb[1][r0][col],
                         sp[mt][nt][0], sp[mt][nt][1]);
            store_split2(&s.sb[0][r0 + 8][col], &s.sb[1][r0 + 8][col],
                         sp[mt][nt][2], sp[mt][nt][3]);
            store_split2(&s.gb[0][r0][col], &s.gb[1][r0][col],
                         gacc[mt][nt][0], gacc[mt][nt][1]);
            store_split2(&s.gb[0][r0 + 8][col], &s.gb[1][r0 + 8][col],
                         gacc[mt][nt][2], gacc[mt][nt][3]);
          }
          x0 += __shfl_xor_sync(0xffffffffu, x0, 1);
          x0 += __shfl_xor_sync(0xffffffffu, x0, 2);
          x1 += __shfl_xor_sync(0xffffffffu, x1, 1);
          x1 += __shfl_xor_sync(0xffffffffu, x1, 2);
          if (tq == 0) {
            s.cpart[p][warp][16 * mt + g] = x0;
            s.cpart[p][warp][16 * mt + g + 8] = x1;
          }
        }
        // ∂L/∂S back over the sub-chunk: G ⊙_rows Gend + (r E)ᵀ dY
        uint32_t dyb[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          ldsm_x2_trans(dyb[nt], &s.dy[bb][t0 + (lane & 15)][v0 + 8 * nt]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t rh[4], rl[4];  // (r E)ᵀ, m-tile mt of d, as A operand
          const int kr = t0 + (lane & 7) + 8 * (lane >> 4);
          const int kc = 16 * mt + 8 * ((lane >> 3) & 1);
          ldsm_x4_trans(rh, &s.re[0][kr][kc]);
          ldsm_x4_trans(rl, &s.re[1][kr][kc]);
          const float g0 = s.g[p][16 * mt + g], g1 = s.g[p][16 * mt + g + 8];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            gacc[mt][nt][0] *= g0;
            gacc[mt][nt][1] *= g0;
            gacc[mt][nt][2] *= g1;
            gacc[mt][nt][3] *= g1;
            mma(gacc[mt][nt], rh, dyb[nt]);
            mma(gacc[mt][nt], rl, dyb[nt]);
          }
        }
      }
      __syncthreads();  // S and Gend of sub-chunk p split for every warp

      // d(rE) = dY Sᵀ and d(kF) = V Gendᵀ, columns i = n0..n0 + 7
      {
        float xh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, xl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float yh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, yl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t dya[4], va[4], sh[2], sl[2], gh[2], gl[2];
          const int ar = t0 + (lane & 15), ac = 16 * kk + (lane >> 4) * 8;
          ldsm_x4(dya, &s.dy[bb][ar][ac]);
          ldsm_x4(va, &s.v[bb][ar][ac]);
          const int br = n0 + (lane & 7), bc = 16 * kk + 8 * ((lane >> 3) & 1);
          ldsm_x2(sh, &s.sb[0][br][bc]);
          ldsm_x2(sl, &s.sb[1][br][bc]);
          ldsm_x2(gh, &s.gb[0][br][bc]);
          ldsm_x2(gl, &s.gb[1][br][bc]);
          mma(xh, dya, sh);
          mma(xl, dya, sl);
          mma(yh, va, gh);
          mma(yl, va, gl);
        }
        const int col = n0 + 2 * tq;
        *reinterpret_cast<float2*>(&s.dre[t0 + g][col]) =
            make_float2(xh[0] + xl[0], xh[1] + xl[1]);
        *reinterpret_cast<float2*>(&s.dre[t0 + g + 8][col]) =
            make_float2(xh[2] + xl[2], xh[3] + xl[3]);
        *reinterpret_cast<float2*>(&s.dkf[t0 + g][col]) =
            make_float2(yh[0] + yl[0], yh[1] + yl[1]);
        *reinterpret_cast<float2*>(&s.dkf[t0 + g + 8][col]) =
            make_float2(yh[2] + yl[2], yh[3] + yl[3]);
      }
      // dV = Aᵀ dY + (k F) Gend, columns v = n0..n0 + 7, written out
      {
        float va_[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float vhh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, vlh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float vhl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint32_t dyb[2], ath[4], atl[4];
        ldsm_x2_trans(dyb, &s.dy[bb][t0 + (lane & 15)][n0]);
        const int kr = t0 + (lane & 7) + 8 * (lane >> 4);
        const int kc = 8 * ((lane >> 3) & 1);
        ldsm_x4_trans(ath, &s.ab[0][kr][kc]);  // Aᵀ as A operand
        ldsm_x4_trans(atl, &s.ab[1][kr][kc]);
        mma(va_, ath, dyb);
        mma(va_, atl, dyb);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t kh[4], kl[4], gh[2], gl[2];
          const int ar = t0 + (lane & 15), ac = 16 * kk + (lane >> 4) * 8;
          ldsm_x4(kh, &s.kf[0][ar][ac]);
          ldsm_x4(kl, &s.kf[1][ar][ac]);
          ldsm_x2_trans(gh, &s.gb[0][16 * kk + (lane & 15)][n0]);
          ldsm_x2_trans(gl, &s.gb[1][16 * kk + (lane & 15)][n0]);
          mma(vhh, kh, gh);
          mma(vlh, kl, gh);
          mma(vhl, kh, gl);
        }
        const int t = c * L + t0 + g;
        bf16* dst = a.dv + ob + n0 + 2 * tq;
        if (t < a.steps)
          *reinterpret_cast<__nv_bfloat162*>(dst + t * orow) =
              __floats2bfloat162_rn(va_[0] + ((vhh[0] + vlh[0]) + vhl[0]),
                                    va_[1] + ((vhh[1] + vlh[1]) + vhl[1]));
        if (t + 8 < a.steps)
          *reinterpret_cast<__nv_bfloat162*>(dst + (t + 8) * orow) =
              __floats2bfloat162_rn(va_[2] + ((vhh[2] + vlh[2]) + vhl[2]),
                                    va_[3] + ((vhh[3] + vlh[3]) + vhl[3]));
      }
      __syncthreads();  // sb and gb read before the next sub-chunk's
    }

    // ---- d. thread (d, sub-chunk): the block's gradient, dr, dk, dw --------
    if (cp_ <= last_p) {
      const int d = cd_, t0 = SUB * cp_;
      float rv[SUB], kv[SUB], wv[SUB], ff[SUB], rs[SUB], x[SUB];
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        rv[t] = __bfloat162float(s.r[bb][t0 + t][d]);
        kv[t] = __bfloat162float(s.k[bb][t0 + t][d]);
        wv[t] = __bfloat162float(s.w[bb][t0 + t][d]);
        x[t] = 0.0f;
      }
      ff[SUB - 1] = 1.0f;
      rs[SUB - 1] = 0.0f;
#pragma unroll
      for (int t = SUB - 2; t >= 0; --t) {  // F_t, R_t
        ff[t] = ff[t + 1] * wv[t + 1];
        rs[t] = s.dre[t0 + t + 1][d] * rv[t + 1] + wv[t + 1] * rs[t + 1];
      }
      const float dg = (s.cpart[cp_][0][d] + s.cpart[cp_][1][d]) +
                       (s.cpart[cp_][2][d] + s.cpart[cp_][3][d]);
      float e = 1.0f, ls = 0.0f;  // E_t, L_t
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        const float dre = s.dre[t0 + t][d], dkf = s.dkf[t0 + t][d];
        const float dat = s.da[t0 + t][t];
        const float dtt = dat * ud;
        const float drv = dre * e + (x[t] + dtt * kv[t]);
        float pq = 1.0f, hq = 0.0f, dkd = 0.0f;  // P(t, q) for q > t
#pragma unroll
        for (int q = t + 1; q < SUB; ++q) {
          const float rp = rv[q] * pq;
          hq += x[q] * rp;
          dkd += s.da[t0 + q][t] * rp;
          pq *= wv[q];
        }
        const float dkv = dkf * ff[t] + (dkd + dtt * rv[t]);
        const float dwv = e * (rs[t] + ff[t] * dg) + ff[t] * ls + hq;
        du_acc += dat * rv[t] * kv[t];
#pragma unroll
        for (int q = t + 1; q < SUB; ++q)
          x[q] = wv[t] * x[q] + s.da[t0 + q][t] * kv[t];
        ls = dkf * kv[t] + wv[t] * ls;
        e *= wv[t];
        const int tt = c * L + t0 + t;
        if (tt < a.steps) {
          const long long at = ob + tt * orow + d;
          a.dr[at] = __float2bfloat16(drv);
          a.dk[at] = __float2bfloat16(dkv);
          a.dw[at] = __float2bfloat16(dwv);
        }
      }
    }
  }

  s.dupart[cp_][cd_] = du_acc;
  if (owner) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = v0 + 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(&a.ds0[slice + (16 * mt + g) * HS + col]) =
            make_float2(gacc[mt][nt][0], gacc[mt][nt][1]);
        *reinterpret_cast<float2*>(&a.ds0[slice + (16 * mt + g + 8) * HS + col]) =
            make_float2(gacc[mt][nt][2], gacc[mt][nt][3]);
      }
  }
  __syncthreads();
  if (tid < HS)
    a.du_part[(long long)blockIdx.x * HS + tid] =
        (s.dupart[0][tid] + s.dupart[1][tid]) +
        (s.dupart[2][tid] + s.dupart[3][tid]);
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

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no -lcuda); nullptr if the driver lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (d, t, h, b) of a contiguous bf16 (B, T, H, 64) tensor,
// boxes of 64 x 64 (d, t), no swizzle; rows past T read as zeros.  A dim
// of size 1 gets a placeholder stride (its coordinate is always 0).
// Returns the driver's CUresult.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
             int T, int H) {
  const cuuint64_t dims[4] = {(cuuint64_t)HS, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const int sizes[3] = {T, H, B};
  const long long elems[3] = {(long long)H * HS, HS, (long long)T * H * HS};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = sizes[i] == 1 ? 16 : (cuuint64_t)elems[i] * 2;
  const cuuint32_t box[4] = {HS, L, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The input and the CUresult of the last map the driver refused
int refused_input = 0, refused_result = 0;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface.  r, k, v, w, dy: bf16 (B, T, H, 64), contiguous, 16-byte
// aligned; u (H, 64) f32; s0, ds_last, ds0 (B, H, 64, 64) f32, contiguous;
// dr, dk, dv, dw bf16 (B, T, H, 64), contiguous; du (H, 64) f32; du_part
// B·H·64 floats; ckpt B·H·ceil(T / 16)·64² floats; T >= 1.  Returns 0,
// a cudaError_t, -1 for a head size other than 64 or no steps, -2 for
// inputs that are
// not 16-byte aligned, -3 if the driver has no cuTensorMapEncodeTiled, or
// -4 if it refused a map.
extern "C" {

int wkv6_backward_chunked_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* dy, const float* u,
                                 const float* s0, const float* ds_last,
                                 void* dr, void* dk, void* dv, void* dw,
                                 float* du, float* du_part, float* ds0,
                                 float* ckpt, int B, int T, int H, int hs,
                                 void* stream) {
  if (hs != HS || T < 1) return -1;
  if (B == 0 || H == 0) return 0;
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) ||
      !aligned16(dy))
    return -2;
  // runtime calls first: they make the device's context current in this
  // thread (autograd runs a backward on a thread of its own, where this
  // may be the first CUDA call), which the map encoder needs
  const int sbytes = static_cast<int>(sizeof(SmemStates)) + 128;
  const int bytes = static_cast<int>(sizeof(Smem)) + 128;  // + alignment
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_backward_chunked_states_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sbytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_backward_chunked_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -3;
  StateMaps smaps;
  Maps maps;
  CUtensorMap* dst[5] = {&maps.r, &maps.k, &maps.w, &maps.v, &maps.dy};
  const void* src[5] = {r, k, w, v, dy};
  for (int i = 0; i < 5; ++i) {
    const int res = make_map(encode, dst[i], src[i], B, T, H);
    if (res != CUDA_SUCCESS) {
      refused_input = i;
      refused_result = res;
      return -4;
    }
  }
  smaps.k = maps.k;
  smaps.w = maps.w;
  smaps.v = maps.v;
  Args a;
  a.u = u; a.s0 = s0; a.ds_last = ds_last;
  a.dr = static_cast<bf16*>(dr);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dw = static_cast<bf16*>(dw);
  a.du_part = du_part; a.ds0 = ds0; a.ckpt = ckpt;
  a.steps = T; a.H = H;
  cudaStream_t st = (cudaStream_t)stream;
  wkv6_backward_chunked_states_kernel<<<B * H, S_THREADS, sbytes, st>>>(
      smaps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_backward_chunked_kernel<<<B * H, THREADS, bytes, st>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * HS;
  wkv6_du_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(du_part, du, B, n);
  return (int)cudaGetLastError();
}

int wkv6_backward_chunked_scratch_steps() { return SUB; }

const char* wkv6_backward_chunked_error_string(int code) {
  switch (code) {
    case -1: return "head size other than 64, or no steps";
    case -2: return "inputs not 16-byte aligned";
    case -3: return "the driver has no cuTensorMapEncodeTiled";
    case -4: {
      static char msg[96];
      const char* names[5] = {"r", "k", "w", "v", "dy"};
      snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused %s (CUresult %d)",
               names[refused_input], refused_result);
      return msg;
    }
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
