// Block-sparse semiring SpMV for Hopper (sm_90a) over the filled tile
// entries only: the compacted route of the graph engine.
//
// Two kernels, bound to Python with ctypes by kernels/bsr_spmv.py:
//
//   bsr_spmv_compact_kernel        replaces the Pallas kernel `bsr_spmv`
//                                  (src/repro/kernels/bsr_spmv.py:136).
//   bsr_spmv_fused_compact_kernel  replaces the Pallas kernel
//                                  `bsr_spmv_fused` (same file, :324): one
//                                  frontier-masked sweep, SpMV + update rule
//                                  + changed bits + the any-changed flag.
//
// csrc/bsr_spmv.cu computes the same two functions over the ELL image of
// B x B tiles (the ELL route).  This file reads a compacted index of that
// image instead (kernels/bsr_spmv.py::build_compact_index), built on the
// card once per plan:
//   row_ptr (n_rows + 1) i32 over the R*B vertex rows (absolute offsets, so
//     a group's rows are a slice of it),
//   ent (E) pairs of i32 (src = cols[r,k]*B + j, the bits of vals[r,k,i,j]),
//     ordered by (row-block r, row i, tile k, column j); only entries at
//     k < nnz[r] whose value is not the ring's ⊕-identity, bit for bit,
//   x (Q, C, B) f32, y / x_new (Q, R, B) f32.
//
// Bound on the H100 (3.35 TB/s).  Bytes, not operations.  At the full-scale
// CA plan (b=16) one unfused sweep must read 5,196,992 entries x 8 B =
// 41.6 MB, the row pointer over 1,963,008 rows (7.9 MB) and x (7.9 MB), and
// write y (7.9 MB): about 65 MB, 0.020 ms.  The ELL route reads about
// 1.4 GB for the same sweep, almost all of it padding: its tiles are 1.59 %
// filled.
//
// Work split.  One thread per vertex row (the unfused kernel: rows_per_thread
// rows, grid-strided); 32 x warps threads a block (the launch's two knobs,
// kernels/spec.py block_size and rows_per_step; 8 warps and 1 row by
// default).  A warp's 32 rows are neighbours, so the B rows of a row-block
// sit in one warp (B = 8, 16, 32) and the fused kernel sets changed[q, r]
// from one ballot: it walks one row a thread whatever the knob says of the
// unfused one.  blockIdx.y is the query.  A thread walks
// its row's entries in order, each one 8-byte load, and gathers x[q, src]
// through the read-only cache; x (7.9 MB at the CA plan) stays in the 50 MB
// L2 while the entry stream passes once.  Neighbouring rows' entries are
// neighbours in memory, so a warp's loads fall on a few cache lines that
// the next iterations hit in L1.  A row of more than long_row entries (32
// from kernels/bsr_spmv.py; a hub of a power-law graph: up to 2,148 in the
// Facebook stand-in at b=32, against a mean of 2.6 and a most of 7 in the CA
// road graph) would hold a warp of short rows for thousands of serial
// steps: the index lists such rows, and the grid's first blocks walk them,
// one row a warp, 32 entries a step.  Rows of an inactive row-block only
// read their act bit, and a warp with none active exits.  No tensor cores:
// at 1.59 % fill a tile product on them would do about 60x the useful
// work, and three of the four rings are not (+, x).
//
// Knobs.  A row's value comes from row_value (a thread) or warp_row_value
// (a long row's warp) in the same k order whatever the launch shape, so
// every value of the knobs gives the same bits.  Each kernel is built for
// three launch bounds, 256, 512 and 1024 threads, and a launch takes the
// least bound that holds its block: a single bound of 1024 would cap every
// launch at 64 registers a thread, under the 32 partials a thread holds at
// B 32, and would change the default launch's register allocation.  The
// unfused kernel is also built twice, for one row a thread and for
// several (STRIDED): the loop over a thread's rows costs registers (40
// against 32 at B 16), which the default launch, one row a thread, does
// not pay.
//
// Arithmetic: bit-equal to the ELL kernel and to ref.bsr_spmv_ref.  The ELL
// kernel gives lane (i, j) of a row the ⊕ over ascending k of
// vals[r,k,i,j] ⊗ x[cols[r,k]*B + j], then folds the B lanes by a xor
// butterfly (offsets B/2 ... 1).  Here a thread keeps the B partials of its
// row in B named registers (struct Partials; each entry updates the
// partial of its column j by one compare and select per partial), in the
// same ascending k, and folds them by the same tree: at offset o,
// p[j] ⊕= p[j + o] for j < o is lane j's shuffle step.  A long row's warp
// gives lane j the partial of column j and folds by the shuffles
// themselves.  The
// entries the index leaves out are ⊕-identity products: ⊕ with the identity
// (or, under plus_times, + ±0 to a partial that starts at +0 and so never
// holds -0) changes no partial on the inputs the semiring contract admits
// (finite x under plus_times, x >= 0 under max_min, x > -inf under
// min_plus).  Every rounding is spelled out as in bsr_spmv.cu: __fmul_rn,
// __fadd_rn, the PageRank rules' one __fmaf_rn; the build passes
// -fmad=false and never --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

enum Ring { PLUS_TIMES = 0, MIN_PLUS = 1, MAX_MIN = 2, MIN_SELECT = 3 };
enum Rule { RELAX = 0, PAGERANK = 1, PAGERANK_DELTA = 2, KCORE = 3,
            IDENTITY = 4 };

// The ring and rule code below is bsr_spmv.cu's, copied: that file stays as
// it is, and each source builds into its own library.

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

// The B column partials of one row as B named registers.  A struct and
// not an array: an array indexed by each entry's column went to local
// memory (64 or 128 bytes a thread at B 16, 32), and so did an unrolled
// compare-and-select over one; no pass can index a struct's members at
// run time.
template <int RING, int N>
struct Partials {
  Partials<RING, N - 1> lo;  // partials 0 .. N-2
  float hi;                  // partial N-1
  __device__ __forceinline__ void init() {
    lo.init();
    hi = ring_zero<RING>();
  }
  // ⊕ prod into the partial of column col: one compare and select each
  __device__ __forceinline__ void add(int col, float prod) {
    lo.add(col, prod);
    hi = col == N - 1 ? ring_add<RING>(hi, prod) : hi;
  }
  template <int J>
  __device__ __forceinline__ float& at() {
    if constexpr (J == N - 1) return hi;
    else return lo.template at<J>();
  }
};

template <int RING>
struct Partials<RING, 0> {
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ void add(int, float) {}
};

// The ELL kernel's xor butterfly over the partials: at offset OFF (B/2 ...
// 1), partial J < OFF takes p[J] ⊕ p[J + OFF], as lane J's shuffle step.
template <int RING, int N, int OFF, int J = 0>
__device__ __forceinline__ void fold(Partials<RING, N>& p) {
  if constexpr (OFF > 0) {
    if constexpr (J < OFF) {
      p.template at<J>() =
          ring_add<RING>(p.template at<J>(), p.template at<J + OFF>());
      fold<RING, N, OFF, J + 1>(p);
    } else {
      fold<RING, N, OFF / 2>(p);
    }
  }
}

// y of one vertex row from its entries [e0, e1), by one thread: the B
// column partials in ascending k, then the butterfly.
template <int B, int RING>
__device__ __forceinline__ float row_value(int e0, int e1,
                                           const int2* __restrict__ ent,
                                           const float* __restrict__ xq) {
  Partials<RING, B> p;
  p.init();
  for (int e = e0; e < e1; ++e) {
    const int2 en = __ldg(ent + e);
    p.add(en.x & (B - 1),
          ring_mul<RING>(__int_as_float(en.y), __ldg(xq + en.x)));
  }
  fold<RING, B, B / 2>(p);
  return p.template at<0>();
}

// y of one long row (a hub of a power-law graph), by a whole warp: each
// chunk of 32 entries is loaded one entry a lane and its products formed
// in parallel, then handed in entry order to the lane that owns the
// entry's column (lane j < B, as in the ELL kernel); the B partials fold by
// the ELL kernel's shuffle butterfly.  Lane 0 gets y.
template <int B, int RING>
__device__ __forceinline__ float warp_row_value(
    int e0, int e1, const int2* __restrict__ ent,
    const float* __restrict__ xq, int lane) {
  float acc = ring_zero<RING>();
  for (int base = e0; base < e1; base += 32) {
    const int n = min(32, e1 - base);
    int col = -1;
    float prod = 0.0f;
    if (lane < n) {
      const int2 en = __ldg(ent + base + lane);
      col = en.x & (B - 1);
      prod = ring_mul<RING>(__int_as_float(en.y), __ldg(xq + en.x));
    }
    for (int t = 0; t < n; ++t) {
      const int c = __shfl_sync(FULL, col, t);
      const float pr = __shfl_sync(FULL, prod, t);
      if (c == lane) acc = ring_add<RING>(acc, pr);
    }
  }
#pragma unroll
  for (int off = B / 2; off > 0; off >>= 1)
    acc = ring_add<RING>(acc, __shfl_xor_sync(FULL, acc, off, B));
  return acc;
}

// The rows of one launch.  The grid's first long_blocks blocks take the
// long rows (more than long_row entries), one a warp, so a hub starts first
// and never holds a warp of short rows; the other short_blocks blocks take
// the short rows, rows_per_thread a thread (1 in the fused kernel), each
// short_stride rows after the last.  long_rows lists the long rows by their
// id in the index's full row range; row_base is this launch's first row
// there.
struct Rows {
  const int* row_ptr;
  const int2* ent;
  const int* long_rows;
  int n_long, long_blocks, row_base, long_row, n_rows;
  int short_blocks, short_stride, rows_per_thread;
};

// This warp's long row (a row of this launch), or -1 past the list's end.
__device__ __forceinline__ int long_row_of(const Rows& rows) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  return w < rows.n_long ? __ldg(rows.long_rows + w) - rows.row_base : -1;
}

template <int B, int RING, int MAXT, bool STRIDED>
__global__ void __launch_bounds__(MAXT)
bsr_spmv_compact_kernel(Rows rows, const float* __restrict__ x,
                        float* __restrict__ y, int C) {
  const int q = blockIdx.y;
  const float* xq = x + (size_t)q * C * B;
  float* yq = y + (size_t)q * rows.n_rows;
  if (blockIdx.x < rows.long_blocks) {
    const int v = long_row_of(rows);
    if (v < 0) return;  // the whole warp
    const float yv = warp_row_value<B, RING>(
        __ldg(rows.row_ptr + v), __ldg(rows.row_ptr + v + 1), rows.ent, xq,
        threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) yq[v] = yv;
    return;
  }
  const int first = (blockIdx.x - rows.long_blocks) * blockDim.x + threadIdx.x;
  // one row a thread unless STRIDED: the loop's count is then the
  // constant 1, and the kernel is the one-row kernel it was before the
  // knob, registers included
  const int per_thread = STRIDED ? rows.rows_per_thread : 1;
  for (int s = 0; s < per_thread; ++s) {
    const int v = first + s * rows.short_stride;
    if (v >= rows.n_rows) return;
    const int e0 = __ldg(rows.row_ptr + v), e1 = __ldg(rows.row_ptr + v + 1);
    if (e1 - e0 > rows.long_row) continue;  // a warp of the long blocks has it
    yq[v] = row_value<B, RING>(e0, e1, rows.ent, xq);
  }
}

// changed[qr] and the conv word of query q (whose atomic is skipped once
// the word is set)
__device__ __forceinline__ void mark_changed(bool* changed, int* conv,
                                             size_t qr, int q) {
  changed[qr] = true;
  if (*(volatile int*)(conv + q) == 0) atomicOr(conv + q, 1);
}

// x_new must hold a copy of xg and changed/conv zeros before the launch:
// rows of inactive row-blocks pass through bitwise.
template <int B, int RING, int MAXT>
__global__ void __launch_bounds__(MAXT)
bsr_spmv_fused_compact_kernel(Rows rows, const float* __restrict__ x,
                              const float* __restrict__ xg,
                              const bool* __restrict__ valid,
                              const bool* __restrict__ act, float damping,
                              float tol, float inv_n, int rule,
                              float* __restrict__ x_new,
                              bool* __restrict__ changed,
                              int* __restrict__ conv, int C) {
  const int q = blockIdx.y;
  const int R = rows.n_rows / B;
  const float* xq = x + (size_t)q * C * B;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x < rows.long_blocks) {
    const int v = long_row_of(rows);
    if (v < 0) return;
    const size_t qr = (size_t)q * R + v / B;
    if (!act[qr]) return;  // the whole warp: its row-block is inactive
    const float y = warp_row_value<B, RING>(
        __ldg(rows.row_ptr + v), __ldg(rows.row_ptr + v + 1), rows.ent, xq,
        lane);
    if (lane == 0) {
      const size_t e = (size_t)q * rows.n_rows + v;
      float xn;
      bool imp;
      apply_rule<RING>(rule, y, xg[e], valid[v], damping, tol, inv_n, &xn,
                       &imp);
      x_new[e] = xn;
      if (imp) mark_changed(changed, conv, qr, q);
    }
    return;
  }
  const int v = (blockIdx.x - rows.long_blocks) * blockDim.x + threadIdx.x;
  const size_t qr = (size_t)q * R + v / B;
  // the B rows of a row-block share one act bit, and B | 32
  const bool on = v < rows.n_rows && act[qr];
  if (!__any_sync(FULL, on)) return;  // the whole warp is idle
  bool imp = false;
  if (on) {
    const int e0 = __ldg(rows.row_ptr + v);
    const int e1 = __ldg(rows.row_ptr + v + 1);
    if (e1 - e0 <= rows.long_row) {  // else a warp of the long blocks
      const float y = row_value<B, RING>(e0, e1, rows.ent, xq);
      const size_t e = (size_t)q * rows.n_rows + v;
      float xn;
      apply_rule<RING>(rule, y, xg[e], valid[v], damping, tol, inv_n, &xn,
                       &imp);
      x_new[e] = xn;
    }
  }
  // one write per improved row-block, by its first lane
  const unsigned ballot = __ballot_sync(FULL, imp);
  if (on && (lane & (B - 1)) == 0) {
    const unsigned group =
        B == 32 ? ballot : (ballot >> lane) & ((1u << (B & 31)) - 1u);
    if (group) mark_changed(changed, conv, qr, q);
  }
}

dim3 grid_of(const Rows& rows, int Q) {
  return dim3(rows.long_blocks + rows.short_blocks, Q);
}

template <int B, int RING, bool STRIDED>
void launch_spmv_strided(const Rows& rows, const float* x, float* y, int C,
                         int Q, int threads, cudaStream_t stream) {
  const dim3 grid = grid_of(rows, Q);
  if (threads <= 256)
    bsr_spmv_compact_kernel<B, RING, 256, STRIDED>
        <<<grid, threads, 0, stream>>>(rows, x, y, C);
  else if (threads <= 512)
    bsr_spmv_compact_kernel<B, RING, 512, STRIDED>
        <<<grid, threads, 0, stream>>>(rows, x, y, C);
  else
    bsr_spmv_compact_kernel<B, RING, 1024, STRIDED>
        <<<grid, threads, 0, stream>>>(rows, x, y, C);
}

template <int B, int RING>
int launch_spmv(Rows rows, const float* x, float* y, int C, int Q,
                int threads, cudaStream_t stream) {
  if (rows.rows_per_thread > 1)
    launch_spmv_strided<B, RING, true>(rows, x, y, C, Q, threads, stream);
  else
    launch_spmv_strided<B, RING, false>(rows, x, y, C, Q, threads, stream);
  return (int)cudaGetLastError();
}

template <int B, int RING>
int launch_fused(Rows rows, const float* x, const float* xg,
                 const bool* valid, const bool* act, float damping,
                 float tol, float inv_n, int rule, float* x_new,
                 bool* changed, int* conv, int C, int Q, int threads,
                 cudaStream_t stream) {
  const dim3 grid = grid_of(rows, Q);
  if (threads <= 256)
    bsr_spmv_fused_compact_kernel<B, RING, 256><<<grid, threads, 0, stream>>>(
        rows, x, xg, valid, act, damping, tol, inv_n, rule, x_new, changed,
        conv, C);
  else if (threads <= 512)
    bsr_spmv_fused_compact_kernel<B, RING, 512><<<grid, threads, 0, stream>>>(
        rows, x, xg, valid, act, damping, tol, inv_n, rule, x_new, changed,
        conv, C);
  else
    bsr_spmv_fused_compact_kernel<B, RING, 1024>
        <<<grid, threads, 0, stream>>>(rows, x, xg, valid, act, damping, tol,
                                       inv_n, rule, x_new, changed, conv, C);
  return (int)cudaGetLastError();
}

// one instantiation per (B, ring); the rule is a uniform runtime branch
#define COMPACT_DISPATCH(FN, ...)                                          \
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

bool bad_shape(int warps, int rows_per_thread) {
  return warps < 1 || warps > 32 || rows_per_thread < 1;
}

Rows rows_of(const int* row_ptr, const void* ent, const int* long_rows,
             int n_long, int row_base, int long_row, int n_rows, int warps,
             int rows_per_thread) {
  const int threads = 32 * warps;
  const long long per_block = (long long)threads * rows_per_thread;
  const int short_blocks = (int)((n_rows + per_block - 1) / per_block);
  return Rows{row_ptr, (const int2*)ent, long_rows, n_long,
              (n_long + warps - 1) / warps, row_base, long_row, n_rows,
              short_blocks, short_blocks * threads, rows_per_thread};
}

}  // namespace

// C interface.  Each returns 0, a cudaError_t from the launch, or -1 for a
// block size / ring / rule the kernels do not implement or a launch shape
// out of range.  n_rows = R * B; long_rows (n_long) lists the rows of more
// than long_row entries, by their id in the index's full row range, of
// which row_ptr's first row is row_base.  warps (1..32) is a thread block's
// warps; rows_per_thread (>= 1) the rows a thread of the unfused kernel
// walks.
extern "C" {

int bsr_spmv_compact_launch(const int* row_ptr, const void* ent,
                            const int* long_rows, int n_long, int row_base,
                            int long_row, const float* x, float* y,
                            int n_rows, int C, int B, int Q, int ring,
                            int warps, int rows_per_thread, void* stream) {
  if (bad_ring(ring) || bad_shape(warps, rows_per_thread)) return -1;
  if (n_rows == 0 || Q == 0) return 0;
  const Rows rows = rows_of(row_ptr, ent, long_rows, n_long, row_base,
                            long_row, n_rows, warps, rows_per_thread);
  COMPACT_DISPATCH(launch_spmv, rows, x, y, C, Q, 32 * warps,
                   (cudaStream_t)stream)
}

int bsr_spmv_fused_compact_launch(const int* row_ptr, const void* ent,
                                  const int* long_rows, int n_long,
                                  int row_base, int long_row,
                                  const float* x, const float* xg,
                                  const bool* valid, const bool* act,
                                  float damping, float tol, float inv_n,
                                  float* x_new, bool* changed, int* conv,
                                  int n_rows, int C, int B, int Q, int ring,
                                  int rule, int warps, void* stream) {
  if (bad_ring(ring) || rule < RELAX || rule > IDENTITY ||
      bad_shape(warps, 1))
    return -1;
  if (n_rows == 0 || Q == 0) return 0;
  const Rows rows = rows_of(row_ptr, ent, long_rows, n_long, row_base,
                            long_row, n_rows, warps, 1);
  COMPACT_DISPATCH(launch_fused, rows, x, xg, valid, act, damping, tol,
                   inv_n, rule, x_new, changed, conv, C, Q, 32 * warps,
                   (cudaStream_t)stream)
}

const char* bsr_compact_error_string(int code) {
  if (code == -1)
    return "unsupported block size, semiring, update rule or launch shape";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
