// The RWKV-6 WKV recurrence in its chunked form, on Hopper's tensor cores
// (sm_90a), for bf16 r, k, v, w at head size 64.
//
// Replaces, for bf16 prefill, the Pallas kernel `wkv6` (body
// `_wkv6_kernel`) in the JAX package's src/repro/kernels/wkv6.py:70, as
// csrc/wkv6.cu does for every other input.  Per (batch, head), per step
// t, with the f32 (hs, hs) state S keyed [k dim, v dim]:
//   y_t = r_t (S + u ⊙ k_tᵀ v_t),   S ← diag(w_t) S + k_tᵀ v_t.
// Bound to Python with ctypes by kernels/wkv6.py, which routes bf16 at
// hs 64 and T >= 128 here (`route`) and checks shapes and alignment.
//
// The algebra.  With c_t = Σ_{s<=t} log w_s, the state step i reads holds
// k_jᵀv_j (j < i) scaled by e^{c_{i-1} − c_j}.  Per sub-chunk of 16 steps,
// with S the state at its start:
//   y    = (r ⊙ e^{c_{i-1} − c_start}) S + A V,
//   A_ij = Σ_d r_id k_jd e^{c_{i-1,d} − c_{j,d}} (j < i),  Σ_d r_id u_d k_id (i = j),
//   S   ← e^{c_end − c_start} ⊙_rows S + (k ⊙ e^{c_end − c_j})ᵀ V.
// Every e^{c_a − c_b} here has a ≥ b and is taken as the product of the w
// between the two steps (E, F, G in ref.wkv6_chunked_heads_ref), each
// ≤ 1: no logarithm, no exponential, nothing overflows (a real
// checkpoint's decays overflow f32 in any form that splits e^{c_i − c_j}
// into e^{c_i} e^{−c_j} over many steps), and w = 0 gives exact zeros.
// A key j of an earlier sub-chunk reaches row i through S, its decay
// factored at each sub-chunk boundary b between them into factors
// e^{c_b' − c_b} ≤ 1; this regroups a 64-step chunk's off-diagonal 16x16
// blocks of A, (r E)(k F mid)ᵀ V, as (r E)((k F mid)ᵀ V), which the state
// already carries, so no decay-scaled copies of k are formed.  The
// diagonal 16x16 block is taken element by element in f32 with the exact
// pairwise decay.
//
// Precision.  Every product runs as mma.sync m16n8k16, bf16 operands and
// f32 accumulators.  An f32 operand (r E, k F, A, the state) is split into
// a bf16 high part and a bf16 remainder and the product taken as hi·hi +
// lo·hi + hi·lo; v is bf16 already.  So y and the state carry 16
// significant bits through the products, not 8: against the recurrence
// (f32 throughout) y differs by about a step of its own bf16 rounding;
// with single bf16 operands it went past the 1e-2 elementwise limit of
// chip_smoke.py's checks.  The carried state stays f32.  No atomics: the
// same inputs give the same bits.
//
// Work split.  One block of 8 warps per (b, h), blockIdx.x = b·H + h.
// Most of the work (the decay products, the diagonal blocks) does not
// depend on v, so splitting v over blocks would redo it in each; one
// block keeps all 64 v columns, with 197 KB of shared memory.  Per staged
// chunk of 64 steps:
//   1. thread (pair of d, sub-chunk), warps 0-3 forming E by a running
//      product and writing r E split, warps 4-7 F and k F; r and w are
//      copied to f32 for phase 2;
//   2. warp (sub-chunk, half of d) takes its diagonal block: lane (j, a
//      quarter of the half) for keys j and j + 8, so each row of r and w
//      read feeds two keys, k_j carried down the sub-chunk and scaled by
//      w_i once row i has read it, the quarters summed by shuffles; then
//      the block sums the two halves of d and splits A once for every
//      warp;
//   3. warps 0-3: warp w owns v columns 16w..16w+15 of S (64 d x 16 v)
//      as mma accumulators (4 warps of 16 columns, not 8 of 8, load the
//      fragments of (r E), (k F) and A that every warp shares half as
//      often), and for each of the 4 sub-chunks in turn loads every
//      operand, then issues S ← G ⊙ S + (k F)ᵀ V and y = (r E) S + A V
//      (four independent accumulators) back to back, and stores S split
//      again for the next sub-chunk (the B operand of y needs S
//      transposed, so it goes through shared memory).
// The chunks two ahead arrive by TMA, one 64 x 64 box of r, k, w and v
// each through 4-D tensor maps over the model's (B, T, H, hs) strides,
// into a ring of three buffers with an mbarrier each, while this one
// computes.  Rows past T arrive as zeros; w's are then set to 1, so they
// add nothing and decay nothing.
//
// In place.  The block reads its (b, h) slice of s0 before its first
// chunk and writes s_out after its last; s0 and s_out may be the same.
//
// Bound on the H100.  At rwkv6-1.6b's prefill shape (B 4, T 1024, H 32,
// hs 64) the function moves 88.1 MB (r, k, v, w read and y written in
// bf16, the f32 state read and written): 26.3 us at 3.35 TB/s.  Its
// chunked operations (per sub-chunk and head: (r E) S and (k F)ᵀ V, 2 ·
// 16 · hs² each; A V, 16 · 17 · hs; the diagonal block, 136 · 2 hs) come
// to 2.43 GFLOP: 2.5 us at the 989 TFLOP/s of the bf16 tensor cores.  So
// bytes bound it.  What this design leaves on the table: its phases are
// bound by latency, not by bytes or the tensor cores (phase 3's
// shared-memory loads and stores cost it more than its MMAs); every warp
// of phase 3 loads the same (r E) and (k F) fragments, and warps 4-7 wait
// through it; the diagonal blocks run on the CUDA cores with a third of
// the lane-steps idle; the split products triple the tensor-core work;
// mma.sync, not wgmma; and the phases of a chunk follow one another
// behind block barriers, one block per SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;      // head size
constexpr int L = 64;       // steps per staged chunk
constexpr int SUB = 16;     // steps per sub-chunk
constexpr int NSUB = L / SUB;
constexpr int NBUF = 3;     // staged chunks in flight
constexpr int THREADS = 256;
constexpr int NT = 2;       // n-tiles of 8 v columns per warp in phase 3
constexpr int MMA_WARPS = HS / (8 * NT);
constexpr int LD = 72;      // bf16 row strides of ldmatrix tiles (144 B,
constexpr int LDA = 24;     // 48 B): 8 rows hit 8 distinct 16-byte bank
                            // groups

struct Args {
  const float* u;
  const float* s0;
  __nv_bfloat16* y;
  float* s_out;
  long long ys[3];  // y's element strides of b, t, h
  int steps, H;
};

struct __align__(128) Smem {
  __nv_bfloat16 r[NBUF][L][HS];    // staged chunks, one TMA box each
  __nv_bfloat16 k[NBUF][L][HS];
  __nv_bfloat16 w[NBUF][L][HS];
  __nv_bfloat16 v[NBUF][L][HS];
  float r32[L][HS];                // r, w in f32 for the diagonal blocks
  float w32[L][HS];
  __nv_bfloat16 re[2][L][LD];      // r E, [hi/lo][step][d]
  __nv_bfloat16 kf[2][L][LD];      // k F
  __nv_bfloat16 sb[2][HS][LD];     // the state S, [hi/lo][d][v]
  float ap[2][L][SUB];             // diagonal blocks, one half of d each
  __nv_bfloat16 ab[2][L][LDA];     // the diagonal blocks summed, split
  float g[NSUB][HS];               // G of each sub-chunk
  unsigned long long full[NBUF];   // mbarriers: a staged chunk landed
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

__device__ __forceinline__ void store_split2(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float x0,
                                             float x1) {
  uint32_t h, l;
  split2(x0, x1, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

struct Maps {
  CUtensorMap r, k, w, v;
};

// Thread 0 stages chunk c into buffer bb: one box of r, k, w and v each
// by the TMA unit, counted on full[bb] (rows past T arrive as zeros; the
// block sets w's to 1 once they have landed)
__device__ __forceinline__ void stage(Smem& s, const Maps& m, int b, int h,
                                      int c, int bb) {
  const uint32_t bar = smem_addr(&s.full[bb]);
  mbar_expect_tx(bar, 4u * L * HS * 2);
  // this buffer's earlier generic reads and writes before the async-proxy
  // writes (ordered by the block barrier before the call)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  tma_load(&s.r[bb][0][0], &m.r, bar, c * L, h, b);
  tma_load(&s.k[bb][0][0], &m.k, bar, c * L, h, b);
  tma_load(&s.w[bb][0][0], &m.w, bar, c * L, h, b);
  tma_load(&s.v[bb][0][0], &m.v, bar, c * L, h, b);
}

// lane's 8 values of d of a row: d = dbase + {0, 1, 2, 3} and dbase + 16
// + {0, 1, 2, 3}; from f32, or from a staged bf16 row
__device__ __forceinline__ void load8(const float* row, int dbase, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(row + dbase);
  const float4 c = *reinterpret_cast<const float4*>(row + dbase + 16);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int dbase,
                                      float* x) {
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

// The diagonal block entries (i, j) for j = jj and j = jj + 8 over this
// lane's 8 values of d, every row i, so each row of r and w read feeds
// two keys: k_j carried down the sub-chunk and scaled by w_i once row i
// has read it (branch-free: rows i <= j compute and drop).  The 4 lanes
// of a row-quarter are summed by shuffles; the two halves of d when the
// block is read.
__device__ __forceinline__ void diag_block(Smem& s, int bb, int t0, int jj,
                                           int qd, int dbase,
                                           const float* ur, float* apart) {
  float k1[8], k2[8], rj[8];  // k_j carried down, for j = jj and jj + 8
  load8(&s.k[bb][t0 + jj][0], dbase, k1);
  load8(&s.k[bb][t0 + jj + 8][0], dbase, k2);
  load8(&s.r32[t0 + jj][0], dbase, rj);
  const float u1 = u_term(rj, ur, k1);
  load8(&s.r32[t0 + jj + 8][0], dbase, rj);
  const float u2 = u_term(rj, ur, k2);
  if (qd == 0) {  // rows 0-7 lie above the diagonal for j >= 8
#pragma unroll
    for (int i = 0; i < 8; ++i) apart[(t0 + i) * SUB + jj + 8] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < SUB; ++i) {
    float rv[8], wv[8];
    load8(&s.r32[t0 + i][0], dbase, rv);
    load8(&s.w32[t0 + i][0], dbase, wv);
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

__global__ void __launch_bounds__(THREADS, 1)
    wkv6_chunked_kernel(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the TMA boxes want 128-byte aligned destinations
  Smem& s = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row, column pair
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const long long slice = (long long)blockIdx.x * HS * HS;
  const int nchunks = (a.steps + L - 1) / L;
  __nv_bfloat16* y = a.y + b * a.ys[0] + h * a.ys[2];

  // phase 1: thread (pair of d, sub-chunk); warps 0-3 take E, 4-7 take F
  const int pd = 2 * lane, pp = warp & 3;
  // phase 2: warp (sub-chunk, half of d); lane (j, quarter), the quarter's
  // d = 32·half + 16m + 4·qd + e (m < 2, e < 4): four distinct 16-byte
  // bank groups across the quarters of a row
  const int dp = warp & 3, dhalf = warp >> 2, jj = lane >> 2, qd = lane & 3;
  const int dbase = 32 * dhalf + 4 * qd;
  float ur[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ur[e] = a.u[h * HS + dbase + e];
    ur[4 + e] = a.u[h * HS + dbase + 16 + e];
  }
  // phase 3: warps below MMA_WARPS, 8·NT columns of v each; S rows d =
  // 16 mt + (g, g + 8), columns v = v0 + 8 nt + 2 tq (+1), as mma
  // accumulators
  const int v0 = 8 * NT * warp;
  float sacc[4][NT][4];
  if (warp < MMA_WARPS) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = v0 + 8 * nt + 2 * tq;
        const float2 lo = *reinterpret_cast<const float2*>(
            &a.s0[slice + (long long)(16 * mt + g) * HS + col]);
        const float2 hi = *reinterpret_cast<const float2*>(
            &a.s0[slice + (long long)(16 * mt + g + 8) * HS + col]);
        sacc[mt][nt][0] = lo.x; sacc[mt][nt][1] = lo.y;
        sacc[mt][nt][2] = hi.x; sacc[mt][nt][3] = hi.y;
        store_split2(&s.sb[0][16 * mt + g][col], &s.sb[1][16 * mt + g][col],
                     lo.x, lo.y);
        store_split2(&s.sb[0][16 * mt + g + 8][col],
                     &s.sb[1][16 * mt + g + 8][col], hi.x, hi.y);
      }
  }

  if (tid == 0) {
    for (int i = 0; i < NBUF; ++i) mbar_init(smem_addr(&s.full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < NBUF - 1 && c < nchunks; ++c)
      stage(s, maps, b, h, c, c);
  }

  for (int c = 0; c < nchunks; ++c) {
    const int bb = c % NBUF;
    mbar_wait(smem_addr(&s.full[bb]), (c / NBUF) & 1);
    const int n = min(L, a.steps - c * L);
    if (n < L) {  // steps past T: w = 1, so they decay nothing
      for (int idx = tid; idx < (L - n) * HS / 2; idx += THREADS)
        reinterpret_cast<uint32_t*>(&s.w[bb][n][0])[idx] = 0x3F803F80u;
    }
    __syncthreads();  // chunk c staged; chunk c − 1 fully done
    if (tid == 0 && c + NBUF - 1 < nchunks)
      stage(s, maps, b, h, c + NBUF - 1, (c + NBUF - 1) % NBUF);

    // ---- 1. E and r E, G, r in f32 | F and k F, w in f32 ---------------
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
          *reinterpret_cast<float2*>(&s.r32[t0 + t][pd]) = rv;
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
          *reinterpret_cast<float2*>(&s.w32[t0 + t][pd]) = wv[t];
          store_split2(&s.kf[0][t0 + t][pd], &s.kf[1][t0 + t][pd],
                       kv.x * f.x, kv.y * f.y);
          f.x = f.x * wv[t].x;
          f.y = f.y * wv[t].y;
        }
      }
    }
    __syncthreads();

    // ---- 2. the diagonal blocks, warp (sub-chunk, half of d) -------------
    diag_block(s, bb, SUB * dp, jj, qd, dbase, ur, &s.ap[dhalf][0][0]);
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

    // ---- 3. per sub-chunk: S ← G ⊙ S + (k F)ᵀ V, y = (r E) S + A V ----
    if (warp >= MMA_WARPS) continue;
#pragma unroll 1
    for (int p = 0; p < NSUB; ++p) {
      const int t0 = SUB * p;
      // every operand of the sub-chunk first, so that no mma waits on the
      // load just before it
      uint32_t vb[NT][2];  // V (16 t x 8 v) as the B operand
      uint32_t sh[4][NT][2], sl[4][NT][2];  // S at the sub-chunk's start
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        ldsm_x2_trans(vb[nt], &s.v[bb][t0 + (lane & 15)][v0 + 8 * nt]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ldsm_x2_trans(sh[kk][nt], &s.sb[0][16 * kk + (lane & 15)][v0 + 8 * nt]);
          ldsm_x2_trans(sl[kk][nt], &s.sb[1][16 * kk + (lane & 15)][v0 + 8 * nt]);
        }
      }
      uint32_t kh[4][4], kl[4][4];  // (k F)ᵀ, m-tile mt of d, as A operand
      float gr[4][2];               // G for rows d = 16 mt + g, + 8
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int kr = t0 + (lane & 7) + 8 * (lane >> 4);
        const int kc = 16 * mt + 8 * ((lane >> 3) & 1);
        ldsm_x4_trans(kh[mt], &s.kf[0][kr][kc]);
        ldsm_x4_trans(kl[mt], &s.kf[1][kr][kc]);
        gr[mt][0] = s.g[p][16 * mt + g];
        gr[mt][1] = s.g[p][16 * mt + g + 8];
      }
      uint32_t ah[4][4], al[4][4];  // r E, k-step kk of d, as A operand
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ar = t0 + (lane & 15), ac = 16 * kk + (lane >> 4) * 8;
        ldsm_x4(ah[kk], &s.re[0][ar][ac]);
        ldsm_x4(al[kk], &s.re[1][ar][ac]);
      }
      uint32_t dh[4], dl[4];  // A (rows i, columns j) as A operand
      ldsm_x4(dh, &s.ab[0][t0 + (lane & 15)][(lane >> 4) * 8]);
      ldsm_x4(dl, &s.ab[1][t0 + (lane & 15)][(lane >> 4) * 8]);
      // the state: scale its rows by G, add (k F)ᵀ V
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          sacc[mt][nt][0] *= gr[mt][0];
          sacc[mt][nt][1] *= gr[mt][0];
          sacc[mt][nt][2] *= gr[mt][1];
          sacc[mt][nt][3] *= gr[mt][1];
          mma(sacc[mt][nt], kh[mt], vb[nt]);
          mma(sacc[mt][nt], kl[mt], vb[nt]);
        }
      // y = (r E) S + A V, four independent accumulators a tile
      float yhh[NT][4], ylh[NT][4], yhl[NT][4], yd[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          yhh[nt][e] = ylh[nt][e] = yhl[nt][e] = yd[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma(yhh[nt], ah[kk], sh[kk][nt]);
          mma(ylh[nt], al[kk], sh[kk][nt]);
          mma(yhl[nt], ah[kk], sl[kk][nt]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma(yd[nt], dh, vb[nt]);
        mma(yd[nt], dl, vb[nt]);
      }
      __syncwarp();  // this warp's reads of sb are done
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = v0 + 8 * nt + 2 * tq;
          store_split2(&s.sb[0][16 * mt + g][col], &s.sb[1][16 * mt + g][col],
                       sacc[mt][nt][0], sacc[mt][nt][1]);
          store_split2(&s.sb[0][16 * mt + g + 8][col],
                       &s.sb[1][16 * mt + g + 8][col], sacc[mt][nt][2],
                       sacc[mt][nt][3]);
        }
      const int t = c * L + t0 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        __nv_bfloat16* yc = y + v0 + 8 * nt + 2 * tq;
        const float* a0 = yhh[nt];
        const float* a1 = ylh[nt];
        const float* a2 = yhl[nt];
        const float* a3 = yd[nt];
        if (t < a.steps)
          *reinterpret_cast<__nv_bfloat162*>(yc + (long long)t * a.ys[1]) =
              __floats2bfloat162_rn((a0[0] + a1[0]) + (a2[0] + a3[0]),
                                    (a0[1] + a1[1]) + (a2[1] + a3[1]));
        if (t + 8 < a.steps)
          *reinterpret_cast<__nv_bfloat162*>(yc + (long long)(t + 8) * a.ys[1]) =
              __floats2bfloat162_rn((a0[2] + a1[2]) + (a2[2] + a3[2]),
                                    (a0[3] + a1[3]) + (a2[3] + a3[3]));
      }
      __syncwarp();  // the state's new split copy, for the next sub-chunk
    }
  }

  if (warp >= MMA_WARPS) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = v0 + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(&a.s_out[slice + (long long)(16 * mt + g) * HS + col]) =
          make_float2(sacc[mt][nt][0], sacc[mt][nt][1]);
      *reinterpret_cast<float2*>(&a.s_out[slice + (long long)(16 * mt + g + 8) * HS + col]) =
          make_float2(sacc[mt][nt][2], sacc[mt][nt][3]);
    }
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

// The 4-D map (d, t, h, b) of a bf16 (B, T, H, 64) tensor with element
// strides st = (b, t, h), boxes of 64 x 64 (d, t), no swizzle; rows past
// T read as zeros.  A dim of size 1 gets a placeholder stride (its
// coordinate is always 0).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int T, int H, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)HS, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const int sizes[3] = {T, H, B};
  const long long elems[3] = {st[1], st[2], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = sizes[i] == 1 ? 16 : (cuuint64_t)elems[i] * 2;
  const cuuint32_t box[4] = {HS, L, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface.  r, k, v, w: bf16 (B, T, H, 64) through element strides
// (15: (b, t, h) of r, k, v, w and y in that order), each row 16-byte
// aligned; u (H, 64) f32; s0, s_out (B, H, 64, 64) f32, contiguous, may
// alias; y bf16.  Returns 0, a cudaError_t, -1 for a head size other than
// 64, -2 for rows that are not 16-byte aligned, -3 if the driver has no
// cuTensorMapEncodeTiled, or -4 if it refused a map.
extern "C" {

int wkv6_chunked_launch(const void* r, const void* k, const void* v,
                        const void* w, const float* u, const float* s0,
                        void* y, float* s_out, const long long* strides,
                        int B, int T, int H, int hs, void* stream) {
  if (hs != HS) return -1;
  if (B == 0 || H == 0) return 0;
  for (int i = 0; i < 15; ++i)
    if (strides[i] % 8) return -2;
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) ||
      !aligned16(y))
    return -2;
  // a runtime call first: it makes the device's context current in this
  // thread (where this may be the first CUDA call), which the map encoder
  // needs
  const int bytes = static_cast<int>(sizeof(Smem)) + 128;  // + alignment
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -3;
  Maps maps;
  if (T > 0 && (!make_map(encode, &maps.r, r, B, T, H, strides) ||
                !make_map(encode, &maps.k, k, B, T, H, strides + 3) ||
                !make_map(encode, &maps.v, v, B, T, H, strides + 6) ||
                !make_map(encode, &maps.w, w, B, T, H, strides + 9)))
    return -4;
  Args a;
  a.u = u; a.s0 = s0;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.s_out = s_out;
  for (int i = 0; i < 3; ++i) a.ys[i] = strides[12 + i];
  a.steps = T; a.H = H;
  wkv6_chunked_kernel<<<B * H, THREADS, bytes, (cudaStream_t)stream>>>(maps,
                                                                       a);
  return (int)cudaGetLastError();
}

const char* wkv6_chunked_error_string(int code) {
  switch (code) {
    case -1: return "head size other than 64";
    case -2: return "rows not 16-byte aligned";
    case -3: return "the driver has no cuTensorMapEncodeTiled";
    case -4: return "cuTensorMapEncodeTiled refused r, k, v or w";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
