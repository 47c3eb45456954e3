// Flash attention for Hopper (sm_90a) on the tensor cores: wgmma + TMA, bf16
// at head dims 64, 128, 192 and 256.
//
// Replaces the Pallas kernel `flash_attention` (body `_flash_kernel`) in the
// JAX package's src/repro/kernels/flash_attention.py for bf16 q, k, v with
// D in {64, 128, 192, 256}: causal, sliding-window or full online-softmax
// attention with S == Skv, f32 accumulators, the output in bf16.  f32 and
// the other head dims take the CUDA-core kernel in flash_attention.cu.
// Bound to Python with ctypes by kernels/flash_attention.py, which picks
// the kernel by dtype and head dim (`route`) before any launch.
//
// Layout.  q (B, H, S, D), k and v (B, Hkv, S, D), o (B, H, S, D), all bf16,
// addressed through element strides for b, h and s; d is contiguous.  The
// TMA descriptors are 4-D (d, s, head, b) over those strides, so the model's
// (B, S, H, D) memory is read in place, and query head h reads kv head
// h / (H / Hkv) through the descriptor's head coordinate (GQA, no copy).
//
// Work split.  A work item is one q-tile of 128 rows of one (b, h); items
// run heaviest causal q-tile first.  The grid is persistent: one block per
// SM walks items blockIdx.x, + gridDim.x, ...  Two consumer warpgroups each
// own 64 query rows of the item; one producer thread issues every TMA load.
// Q tiles sit in QBUF buffers (item n in buffer n % QBUF); K and V tiles of
// 64 keys x D take the next place of a ring of STAGES buffers across items.
// Each buffer has a `full` mbarrier (TMA bytes landed) and an `empty` one
// (all 256 consumer threads done with it), so the producer loads the next
// tiles, and the next item's Q, while the consumers compute.  Shared memory
// holds bf16 in the 128-byte swizzle that TMA writes and wgmma reads: a
// 64-row x D tile is D/64 boxes of 64 rows x 128 bytes.
//
// Per head dim (`Cfg<D>`; a block may opt into 232,448 B of shared memory):
//   D 64, 128: 2 Q buffers, 3 stages, K and V of a tile on one barrier pair;
//              288 threads (the producer is one warp), at most 224 registers
//              a thread; 80 KB and 160 KB.
//   D 192:     2 Q buffers and 2 stages, 192 KB (1 Q buffer and 3 stages
//              fit too and measured the same: PERF.md);
//   D 256:     1 Q buffer and 2 stages, 192 KB: the next item's Q waits for
//              this item's last read of its own.
//   At D 192 and 256 K and V have barriers of their own, so K of tile j+1
//   loads once S of tile j-1 is done and V of tile j+1 once PV of tile j-1
//   is: with two stages each load still starts about a tile ahead.
//   Registers at D 192 and 256: O alone is D/2 f32 a thread (128 at D 256)
//   beside S (32) and P (16 pairs) of the tile in flight, more than the 224
//   a thread of 288 may have.  So the producer is a whole warpgroup (384
//   threads, 168 registers each at launch) that gives registers back with
//   setmaxnreg.dec to 24, and the consumers take them with setmaxnreg.inc to
//   240: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536.  The two roles
//   never reconverge (the producer returns), or ptxas would ignore it.
//
// Products.  S = Q Kᵀ is wgmma m64n64k16 with both operands K-major in
// shared memory, D/16 k-steps.  The online softmax runs on the accumulator
// fragment: each thread holds two rows (g and g+8 of its warp's 16), reduced
// across the four threads of a quad by shuffles, exp2 with scale·log2 e
// folded into one FMA.  P is rounded to bf16 in registers, where the
// accumulator layout of S is already wgmma's register layout for A, and
// O += P V is one wgmma m64nDk16 a k-step (N = D up to 256) with V from
// shared memory as the MN-major B operand.  S of tile j is issued beside PV
// of tile j-1, and the softmax of tile j runs while that PV does; each wgmma
// group is waited for before its registers are touched.  O / l is rounded
// to bf16 once and stored straight from registers.
//
// Masks.  The key-tile range of each warpgroup is the CUDA-core kernel's:
// up to the causal diagonal and from the left edge of the window; the
// other warpgroup's extra tiles are only released.  Element masks run only
// on tiles that straddle the diagonal, the window edge or S.  Keys >= S
// never attend, causal or not: TMA fills rows past S with zeros, which
// would score 0, so they are masked too.  A row that sees no key writes 0
// (denominator 1).
//
// Bound on the H100 (operations, 4·D per kept (query, key) pair, at the 989
// TFLOP/s of the bf16 tensor cores).  One granite-3-2b prefill wave (B 4, H
// 32, Hkv 8, S 1024, D 64, causal): 17.2 GFLOP, 17.4 us, against 42 MB of
// q, k, v and o (12.5 us at 3.35 TB/s).  One recurrentgemma-9b wave (B 4,
// H 16, Hkv 1, S 3072, D 256, window 2048): 275 GFLOP kept, 0.278 ms; the
// window's edge tiles compute about 3 % more.  What this design leaves on
// the table (PERF.md has the times): per 64-key tile a warpgroup's
// products, its 4096 exp2 and the rest of its softmax run largely one after
// another, and at D 192/256 only two stages of K and V fit beside Q.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per work item
constexpr int BK = 64;           // keys per tile
constexpr int CONSUMERS = 2;     // warpgroups, 64 query rows each
constexpr int BOX = 64 * 128;    // bytes of one TMA box: 64 rows x 128 bytes
constexpr int SMEM_OPT_IN = 232448;  // shared memory a block may opt into

struct Params {
  __nv_bfloat16* o;
  long long os[3];  // element strides of b, h, s of o
  int BH, H, Hkv, S, causal, window;  // BH = B * H; window <= 0: none
  float scale_log2;                   // scale * log2(e)
};

// What each head dim is built with; byte offsets from the block's
// 1024-aligned shared memory base.
template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128 || D == 192 || D == 256, "head dim");
  static constexpr bool WIDE = D > 128;  // producer warpgroup, setmaxnreg,
                                         // K and V on barriers of their own
  static constexpr int PRODUCER = WIDE ? 128 : 32;  // producer threads
  static constexpr int THREADS = CONSUMERS * 128 + PRODUCER;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // WIDE
  static constexpr int STAGES = D <= 128 ? 3 : 2;  // the K/V ring
  static constexpr int QBUF = D <= 192 ? 2 : 1;    // Q buffers
  static constexpr int TILE = D / 64 * BOX;  // 64 rows x D
  static constexpr int Q = 0;  // QBUF buffers of CONSUMERS tiles
  static constexpr int K = Q + QBUF * CONSUMERS * TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  // q_full, q_empty [QBUF]; full, empty [STAGES] (K and V, or K alone when
  // WIDE); v_full, v_empty [STAGES] when WIDE
  static constexpr int BYTES =
      BAR + 8 * (2 * QBUF + (WIDE ? 4 : 2) * STAGES) + 1024;  // + align
  static_assert(BYTES <= SMEM_OPT_IN, "shared memory over the opt-in");
  static_assert(!WIDE || PRODUCER * PRODUCER_REGS + CONSUMERS * 128 *
                             CONSUMER_REGS <= 65536, "registers");
};

// -- PTX wrappers ------------------------------------------------------------

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// One box of the 4-D map at (c0, c1, c2, c3) into shared memory at dst;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins a register across an asm boundary, so that no read of an
// accumulator moves above the wgmma wait that completes it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F8(d, i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F32(d) F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
#define F64(d) F32(d), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
#define F32_AT(d, i) F8(d, i), F8(d, i + 8), F8(d, i + 16), F8(d, i + 24)
#define F96(d) F64(d), F32_AT(d, 64)
#define F128(d) F64(d), F32_AT(d, 64), F32_AT(d, 96)

// d (+)= a · b for a 64 x 16 slice of A and a 64 x 16 slice of B, both
// K-major in shared memory; m64n64k16, bf16 in, f32 out; acc = 0 overwrites.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d += a · b with a (64 x 16 bf16, in pairs) from registers and b from
// shared memory, MN-major; m64nNk16 for N = D in 64, 128, 192, 256.  One
// instruction covers the whole width of O, so at D 192 and 256 P's
// registers are read once a k-step, not once per 64 or 128 columns; ptxas
// compiles both wide shapes without serializing them.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : F96(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F128
#undef F96
#undef F32_AT
#undef F64
#undef F32
#undef F8

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The key tiles [lo, hi) that some row of rows [r0, r0 + 64) can see;
// empty when r0 >= S.
__device__ __forceinline__ void tile_range(const Params& a, int r0,
                                           int n_tiles, int& lo, int& hi) {
  lo = hi = 0;
  if (r0 >= a.S) return;
  const int last_row = min(r0 + 64, a.S) - 1;
  hi = a.causal ? min(n_tiles, last_row / BK + 1) : n_tiles;
  if (a.window > 0) {
    const int first_key = r0 - a.window + 1;  // row r0's oldest key
    lo = first_key > 0 ? first_key / BK : 0;
  }
}

// -- the kernel --------------------------------------------------------------

// One work item: a q-tile of BQ rows of one (b, h).  Item w is q-tile
// n_q - 1 - w / (B H), so the heaviest causal q-tiles come first.
struct Item {
  int b, h, q0;
  int lo0, hi0, lo1, hi1;  // key tiles of warpgroups 0 and 1
  int lo, hi;              // the block's: their union
};

__device__ __forceinline__ Item item_at(const Params& a, int w, int n_q,
                                        int n_tiles) {
  Item x;
  const int bh = w % a.BH;
  x.b = bh / a.H;
  x.h = bh % a.H;
  x.q0 = (n_q - 1 - w / a.BH) * BQ;
  tile_range(a, x.q0, n_tiles, x.lo0, x.hi0);
  tile_range(a, x.q0 + 64, n_tiles, x.lo1, x.hi1);
  x.lo = x.lo0;  // warpgroup 0 always has rows and the earliest keys
  x.hi = max(x.hi0, x.hi1);
  return x;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params a) {
  using L = Cfg<D>;
  constexpr int HALVES = D / 64, STAGES = L::STAGES, QBUF = L::QBUF;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  // barriers: q_full[QBUF], q_empty[QBUF], full[STAGES], empty[STAGES]
  // (K and V; K alone when WIDE), v_full[STAGES], v_empty[STAGES] (WIDE)
  const uint32_t q_full0 = base + L::BAR, q_empty0 = q_full0 + 8 * QBUF;
  const uint32_t full0 = q_empty0 + 8 * QBUF, empty0 = full0 + 8 * STAGES;
  const uint32_t v_full0 = empty0 + 8 * STAGES,
                 v_empty0 = v_full0 + 8 * STAGES;

  const int S = a.S;
  const int n_q = (S + BQ - 1) / BQ, n_tiles = (S + BK - 1) / BK;
  const int n_items = a.BH * n_q;
  const int wg = threadIdx.x / 128;
  // the n-th item's Q buffer, n % QBUF, and its phase parity, (n / QBUF) % 2
  // (QBUF is 1 or 2; shifts, as n is a signed int)
  static_assert(QBUF == 1 || QBUF == 2, "Q buffers");
  auto q_buf = [](int n) { return n & (QBUF - 1); };
  auto q_parity = [](int n) { return (n >> (QBUF - 1)) & 1; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, CONSUMERS * 128);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 128);
      if constexpr (L::WIDE) {
        mbar_init(v_full0 + 8 * s, 1);
        mbar_init(v_empty0 + 8 * s, CONSUMERS * 128);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks items blockIdx.x, + gridDim.x, ...; the n-th of them
  // keeps its Q in buffer n % QBUF, and every key tile of every item takes
  // the next place `it` in the K/V ring, so the producer loads the next
  // item's Q and first tiles while the consumers finish this one.
  if (wg == CONSUMERS) {  // the producer warp (warpgroup when WIDE)
    if constexpr (L::WIDE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          L::PRODUCER_REGS));
    if (threadIdx.x % L::PRODUCER != 0) return;
    int it = 0;
    for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
      const Item x = item_at(a, w, n_q, n_tiles);
      const int hk = x.h / (a.H / a.Hkv);
      const uint32_t q_full = q_full0 + 8 * q_buf(n);
      mbar_wait(q_empty0 + 8 * q_buf(n), q_parity(n) ^ 1);
      const int nq = x.q0 + 64 < S ? 2 : 1;  // row blocks with rows < S
      mbar_expect_tx(q_full, nq * L::TILE);
      for (int r = 0; r < nq; ++r)
        for (int c = 0; c < HALVES; ++c)
          tma_load(base + L::Q + (q_buf(n) * CONSUMERS + r) * L::TILE +
                       c * BOX,
                   &tq, q_full, 64 * c, x.q0 + 64 * r, x.h, x.b);
      for (int kt = x.lo; kt < x.hi; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        if constexpr (L::WIDE) {  // K, then V on its own barriers
          mbar_expect_tx(full, L::TILE);
          for (int c = 0; c < HALVES; ++c)
            tma_load(base + L::K + s * L::TILE + c * BOX, &tk, full, 64 * c,
                     kt * BK, hk, x.b);
          const uint32_t v_full = v_full0 + 8 * s;
          mbar_wait(v_empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(v_full, L::TILE);
          for (int c = 0; c < HALVES; ++c)
            tma_load(base + L::V + s * L::TILE + c * BOX, &tv, v_full,
                     64 * c, kt * BK, hk, x.b);
        } else {
          mbar_expect_tx(full, 2 * L::TILE);
          for (int c = 0; c < HALVES; ++c) {
            tma_load(base + L::K + s * L::TILE + c * BOX, &tk, full, 64 * c,
                     kt * BK, hk, x.b);
            tma_load(base + L::V + s * L::TILE + c * BOX, &tv, full, 64 * c,
                     kt * BK, hk, x.b);
          }
        }
      }
    }
    return;
  }
  if constexpr (L::WIDE)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        L::CONSUMER_REGS));

  // a consumer warpgroup: this thread holds rows row_a and row_b = row_a
  // + 8 of the accumulator fragments.  wait_full and release take a tile's
  // K and V, or K alone when WIDE; then wait_v and release_v take V.
  const int t = threadIdx.x % 128;
  const int lane = t % 32, quad_col = 2 * (lane % 4);
  auto wait_full = [&](int it) {
    mbar_wait(full0 + 8 * (it % STAGES), (it / STAGES) & 1);
  };
  auto release = [&](int it) { mbar_arrive(empty0 + 8 * (it % STAGES)); };
  auto wait_v = [&](int it) {
    mbar_wait(v_full0 + 8 * (it % STAGES), (it / STAGES) & 1);
  };
  auto release_v = [&](int it) {
    mbar_arrive(v_empty0 + 8 * (it % STAGES));
  };

  float o[D / 2], sc[32];
  uint32_t p[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[2 * j] = sc[2 * j + 1] = p[j] = 0;
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    const Item x = item_at(a, w, n_q, n_tiles);
    const int r0 = x.q0 + 64 * wg;
    const int row_a = r0 + 16 * (t / 32) + lane / 4, row_b = row_a + 8;
    const int my_lo = wg ? x.lo1 : x.lo0, my_hi = wg ? x.hi1 : x.hi0;
    const uint32_t q_smem =
        base + L::Q + (q_buf(n) * CONSUMERS + wg) * L::TILE;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max, scaled by log2 e
    float l_a = 0.0f, l_b = 0.0f;
    float alpha_a = 1.0f, alpha_b = 1.0f;  // O's rescale for the tile in sc

    // S = Q Kᵀ into sc: D / 16 k-steps, 32 bytes apart inside each
    // 128-byte box; committed as one group
    auto issue_s = [&](int it) {
      const uint32_t k_smem = base + L::K + (it % STAGES) * L::TILE;
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        wgmma_ss_n64(sc, smem_desc(q_smem + off, 16, 1024),
                     smem_desc(k_smem + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: 4 k-steps of 16 keys, 16 rows of 128 bytes apart; V's
    // columns past 64 lie a box further each (the leading offset)
    auto issue_pv = [&](int it) {
      const uint32_t v_smem = base + L::V + (it % STAGES) * L::TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                p[4 * kk + 3]};
        wgmma_rs(o, pa, smem_desc(v_smem + kk * 16 * 128, BOX, 1024));
      }
      wgmma_commit();
    };
    // sc (the raw scores of key tile kt) becomes p = exp2(sc·scale·log2 e
    // − m) in f32, masked; m and l move on, alpha is O's rescale.
    // Register j holds row (j % 4 < 2 ? row_a : row_b), key k0 + 8(j / 4)
    // + quad_col + j % 2.
    auto softmax = [&](int kt) {
      const int k0 = kt * BK;
      if (k0 + BK > S || (a.causal && k0 + BK - 1 > r0) ||
          (a.window > 0 && k0 <= r0 + 63 - a.window)) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int kpos = k0 + 8 * (j / 4) + quad_col + j % 2;
          const int qpos = j % 4 < 2 ? row_a : row_b;
          if (kpos >= S || (a.causal && kpos > qpos) ||
              (a.window > 0 && kpos <= qpos - a.window))
            sc[j] = -INFINITY;
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        mx_a = fmaxf(mx_a, fmaxf(sc[j], sc[j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[j + 2], sc[j + 3]));
      }
      const float new_a = fmaxf(m_a, quad_max(mx_a) * a.scale_log2);
      const float new_b = fmaxf(m_b, quad_max(mx_b) * a.scale_log2);
      // a row that has seen no key yet keeps p = 0 and alpha = 0
      const float use_a = new_a == -INFINITY ? 0.0f : new_a;
      const float use_b = new_b == -INFINITY ? 0.0f : new_b;
      alpha_a = exp2_approx(m_a - use_a);
      alpha_b = exp2_approx(m_b - use_b);
      m_a = new_a;
      m_b = new_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        sc[j] = exp2_approx(fmaf(sc[j], a.scale_log2, -use_a));
        sc[j + 1] = exp2_approx(fmaf(sc[j + 1], a.scale_log2, -use_a));
        sc[j + 2] = exp2_approx(fmaf(sc[j + 2], a.scale_log2, -use_b));
        sc[j + 3] = exp2_approx(fmaf(sc[j + 3], a.scale_log2, -use_b));
        sum_a += sc[j] + sc[j + 1];
        sum_b += sc[j + 2] + sc[j + 3];
      }
      l_a = l_a * alpha_a + quad_sum(sum_a);
      l_b = l_b * alpha_b + quad_sum(sum_b);
    };
    // P in bf16 pairs: the accumulator layout of sc is wgmma's A layout
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < 32; j += 2) p[j / 2] = pack_bf16(sc[j], sc[j + 1]);
    };

    // Outside [my_lo, my_hi) a tile is only released.  Inside, S of tile
    // kt runs on the tensor cores beside PV of tile kt - 1, and the
    // softmax of tile kt beside that PV.
    // When WIDE, K of a tile is released once S has read it and V once PV
    // has.
    mbar_wait(q_full0 + 8 * q_buf(n), q_parity(n));
    int kt = x.lo;
    for (; kt < my_lo; ++kt, ++it) {
      wait_full(it);
      if constexpr (L::WIDE) {
        wait_v(it);
        release_v(it);
      }
      release(it);
    }
    if (my_lo < my_hi) {
      wait_full(it);
      issue_s(it);
      wgmma_wait<0>();
      reg_fence(sc);
      if constexpr (L::WIDE) release(it);
      softmax(kt);
      pack_p();
      for (++kt, ++it; kt < my_hi; ++kt, ++it) {
        wait_full(it);
        if constexpr (L::WIDE) wait_v(it - 1);
        issue_s(it);
        issue_pv(it - 1);
        wgmma_wait<1>();  // S of tile kt
        reg_fence(sc);
        if constexpr (L::WIDE) release(it);
        softmax(kt);
        wgmma_wait<0>();  // PV of tile kt - 1
        reg_fence(o);
        if constexpr (L::WIDE)
          release_v(it - 1);
        else
          release(it - 1);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[j] *= j % 4 < 2 ? alpha_a : alpha_b;
        pack_p();
      }
      if constexpr (L::WIDE) wait_v(it - 1);
      wgmma_fence();
      issue_pv(it - 1);
      wgmma_wait<0>();
      reg_fence(o);
      if constexpr (L::WIDE)
        release_v(it - 1);
      else
        release(it - 1);
    }
    for (; kt < x.hi; ++kt, ++it) {
      wait_full(it);
      if constexpr (L::WIDE) {
        wait_v(it);
        release_v(it);
      }
      release(it);
    }
    mbar_arrive(q_empty0 + 8 * q_buf(n));  // every read of this Q is done

    // O / l, rounded once; register j holds column 8 * (j / 4) + quad_col
    // + j % 2 of row (j % 4 < 2 ? row_a : row_b)
    const float inv_a = 1.0f / (l_a == 0.0f ? 1.0f : l_a);
    const float inv_b = 1.0f / (l_b == 0.0f ? 1.0f : l_b);
    __nv_bfloat16* out = a.o + x.b * a.os[0] + x.h * a.os[1];
#pragma unroll
    for (int j = 0; j < D / 2; j += 4) {
      const int col = 8 * (j / 4) + quad_col;
      if (row_a < S)
        *reinterpret_cast<uint32_t*>(out + row_a * a.os[2] + col) =
            pack_bf16(o[j] * inv_a, o[j + 1] * inv_a);
      if (row_b < S)
        *reinterpret_cast<uint32_t*>(out + row_b * a.os[2] + col) =
            pack_bf16(o[j + 2] * inv_b, o[j + 3] * inv_b);
    }
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

// The 4-D map (d, s, head, b) of a bf16 (B, heads, S, D) tensor with
// element strides st = (b, h, s), boxes of 64 x 64 (d, s) in the 128-byte
// swizzle; rows past S read as zeros.  A dim of size 1 gets a placeholder
// stride (its coordinate is always 0).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int heads, int S, int D, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const int sizes[3] = {S, heads, B};
  const long long elems[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = sizes[i] == 1 ? 16 : (cuuint64_t)elems[i] * 2;
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One block per SM (persistent: each walks many items), at most one per
// item.  The SM count is read once.  A WIDE instance must hold the launch
// bound's registers for setmaxnreg to balance (the consumers' increase
// takes exactly what the producer gives back), else it would wait
// forever: refused instead (-4).
template <int D>
int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
           const Params& a, int n_items, cudaStream_t stream) {
  using L = Cfg<D>;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  if constexpr (L::WIDE) {
    static const int regs = [] {
      cudaFuncAttributes attr;
      return cudaFuncGetAttributes(&attr, flash_attention_sm90_kernel<D>) ==
                     cudaSuccess
                 ? attr.numRegs
                 : 0;
    }();
    if (regs * L::THREADS < L::PRODUCER * L::PRODUCER_REGS +
                                CONSUMERS * 128 * L::CONSUMER_REGS)
      return -4;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = n_items < sms ? n_items : sms;
  flash_attention_sm90_kernel<D>
      <<<grid, L::THREADS, L::BYTES, stream>>>(q, k, v, a);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface.  bf16 only.  strides: 12 element strides, (b, h, s) of q, k,
// v and o in that order.  Returns 0, a cudaError_t, or a negative code that
// flash_sm90_error_string explains.
extern "C" {

int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, const long long* strides, int B,
                                int H, int Hkv, int S, int D, int causal,
                                int window, float scale, void* stream) {
  if ((D != 64 && D != 128 && D != 192 && D != 256) || Hkv < 1 ||
      H % Hkv != 0 || (long long)B * H * ((S + BQ - 1) / BQ) > INT32_MAX)
    return -1;
  if (B == 0 || H == 0 || S == 0) return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, H, S, D, strides) ||
      !make_map(encode, &tk, k, B, Hkv, S, D, strides + 3) ||
      !make_map(encode, &tv, v, B, Hkv, S, D, strides + 6))
    return -3;
  Params a;
  a.o = static_cast<__nv_bfloat16*>(o);
  for (int i = 0; i < 3; ++i) a.os[i] = strides[9 + i];
  a.BH = B * H; a.H = H; a.Hkv = Hkv; a.S = S;
  a.causal = causal; a.window = window;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_items = B * H * ((S + BQ - 1) / BQ);
  switch (D) {
    case 64: return launch<64>(tq, tk, tv, a, n_items, st);
    case 128: return launch<128>(tq, tk, tv, a, n_items, st);
    case 192: return launch<192>(tq, tk, tv, a, n_items, st);
    default: return launch<256>(tq, tk, tv, a, n_items, st);
  }
}

const char* flash_sm90_error_string(int code) {
  switch (code) {
    case -1: return "unsupported head dim (64, 128, 192 or 256), head count "
                    "or length";
    case -2: return "the driver has no cuTensorMapEncodeTiled";
    case -3: return "cuTensorMapEncodeTiled refused q, k or v (TMA needs "
                    "16-byte aligned data and strides)";
    case -4: return "the D 192/256 kernel was built with fewer registers "
                    "than its setmaxnreg split needs";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
