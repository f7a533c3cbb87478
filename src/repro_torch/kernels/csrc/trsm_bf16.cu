// TRSM for Hopper (sm_90a) in bfloat16: X with tril(A) @ X = alpha * B
// (left, lower, non-unit), A (m, m), B and X (m, n), all bfloat16.  Two
// kernels, so two launches a call whatever m and the batch; trsm.cu is
// their float32 twin, with the same grids and walk over the block rows.
//
// Replaces the bf16 mode of the reference package's
// src/repro/kernels/trsm.py::trsm_pallas, whose every intermediate is in
// A's dtype: the inverses D_i^-1 of the bm x bm diagonal blocks (XLA's
// triangular_solve against I, in bf16), then, block row after block row,
//   r   = bf16(alpha * B_i)
//   upd = bf16(A[i, :lo] @ X[:lo])          (a Pallas GEMM, float32 sums)
//   R_i = bf16(float(r) - float(upd))
//   X_i = bf16(D_i^-1 @ R_i)                (a Pallas GEMM, float32 sums)
// so X is bf16 between block rows and a block row is rounded four times.
// These kernels round at the same four points.
//
// trsm_inv_bf16_kernel: trsm.cu's trsm_inv_kernel on bf16 D, each inverse
// entry stored rounded once to bf16.  The grid, the threads, the groups of
// 8 rows, the fmaf order and the quotient are the float32 kernel's, with x
// kept in float32 in shared memory, so its entries are those of the float32
// kernel on A.float() rounded to bf16, bit for bit (XLA's bf16 solve, which
// rounds as it goes, differs from that by one ulp in some entries).
// cp.async moves 4, 8 or 16 bytes, so a group's rows of D are staged with
// 2-byte loads, converted to float32, into the float32 kernel's
// [k][kInvRows] layout; the stores land before the next group's barrier.
// Workspace [batch][ceil(m / bm)][bm][bm] bf16, zeros above each diagonal
// and past the ragged size.
//
// trsm_bf16_kernel: the substitution on the wgmma mainloop
// (bf16_wgmma_mainloop.cuh: wgmma.mma_async with float32 accumulators, both
// operands from shared memory, TMA into a ring of mbarrier-guarded stages).
// Grid (ceil(n / bn), 1, batch): a block owns the column strip X[:, c0 :
// c0 + bn] of one item and walks the block rows i in order.  Per block row,
// two steps, each the GEMM's step (A K-major, B (k, n) as it lies, read
// with wgmma's transpose flag), each in passes of rows top-down:
//   0. acc = A[i, :lo] @ X[:lo, strip] over lo / 64 contraction steps (none
//      at block row 0: acc stays 0), R_i = bf16(float(bf16(alpha B_i)) -
//      float(bf16(acc))); at block row 0 that is bf16(alpha B_0), the
//      reference's r;
//   1. X_i = bf16(D_i^-1 @ R_i), D_i^-1 from the bf16 workspace, each pass
//      of rows stopping at its last row (D_i^-1 is zero past its diagonal).
//      alpha is already in R.
//
// Sequence.  Every step of every block row of the strip runs through one
// ring, in the order above (TrsmSteps, mirrored by kernels/trsm.py::
// step_plan): A's block-row steps and the inverses' steps, which are
// read-only, are copied STAGES steps ahead of the products, across the
// ends of the block rows, so the next step's first copies overlap the last
// products and the epilogue of the one before.
//
// R_i on the SM.  Step 0's epilogue writes R_i into a shared region, BM x
// BN values laid out as B stages are (64-row blocks of 64-column slabs,
// rows of 128 bytes swizzled over 128 bytes), and step 1's wgmma read their
// B from there: no store and reload of R_i through global memory.  The same
// region first receives B_i, copied by TMA at the end of the block row
// before (B is read once, from HBM: its latency then lies under step 0's
// products), and each thread turns the B values at its accumulators'
// places into R_i's.  Rows of the region past the block row's last row hold
// zeros, which the zeros of D_i^-1 past its diagonal multiply.  Step 0
// reads X by TMA, rows stored one block row earlier or more (a second
// region that kept X_{i-1} for the next block row's step 0 measured no
// faster, PERF.md).
//
// The producer's dependency.  A step that reads X's rows may not be copied
// before the epilogue that stores them has ended and fenced: the threads'
// st.global, then fence.proxy.async.global and __syncthreads, and only
// then the copy, which runs on the async proxy.  Each step of a block row
// ends with such a fence (publish) and advances an epoch (2 i + 1 after
// step 0 of block row i, 2 i + 2 after step 1); a step needs the epoch
// after which the rows it reads are stored (TrsmProducer::need).  The last
// warp to release a stage refills it with the step STAGES ahead when that
// step's epoch has come, else leaves the step pending in its slot; at each
// epoch, after the fence and the barrier, lanes of warp 0 issue the pending
// steps whose epoch has come (deferred refills: no warp waits for rows its
// own block has yet to store).  The region is written by the threads and
// read by wgmma, so the same fence covers the shared memory.  A step is
// consumed only after the epoch it needs, so no wait can outlast the
// protocol; a fault still traps after wgemm::kWaitTrap cycles rather than
// hanging the card.
//
// Tile.  wgemm::Tile<BM, BN, 64> for the eight (bm, bn): one or two
// warpgroups, passes of at most 128 rows and every column.  The blocks an
// SM is meant to hold: the grid is one block a strip and item (224, 112
// or 56 strips at the preconditioner's (4096, 4096) x (4096, 14336) call
// for bn 64, 128, 256, on 132 SMs), so at most 2, and 1 when 2 would leave
// the ring fewer than 3 stages beside the region.  The ring takes as many
// stages (2 to 16) as fit 1 / BLOCKS of the SM's shared memory beside the
// region.  __launch_bounds__(THREADS, BLOCKS).
//
// Odd strides.  An operand TMA cannot take (the wrapper's `vec` false) has
// every stage written by the threads in the same layout: A and the
// inverses through the read-only cache, X (written by this block) through
// L2 (__ldcg), zero past the edges as TMA fills them, so odd strides ==
// aligned copies bit for bit.  Step 0 reads only A[i, :lo], strictly below
// the diagonal, so nothing above A's diagonal reaches X.
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 989 TFLOP/s
// of dense bf16 against 2 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so the
// (4096, 4096) x (4096, 14336) call is bound by its operations (0.24 ms).
// What holds it far above that on the card (PERF.md, §6): a strip is
// one block, so an SM holds two blocks at most, and a block's step costs
// the consume loop's scalar chain (the wait, the release's atomics and
// fences, the refill) several times its products; and each strip re-reads
// its own X[:lo] every block row (3.7 GB at 64x64 at that call, from HBM:
// the strips' X, 117 MB, cycles through the 50 MB L2), which a bm of 128
// halves.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_wgmma_mainloop.cuh"
#include "launch_grid.cuh"

namespace {

using wgemm::bf16;
using wgemm::cmax;
using wgemm::cmin;
using wgemm::kAlign;
using wgemm::kSlab;

// the contraction step (core/knobs.py HOPPER_CONTRACTION_STEP)
constexpr int BK = 64;

// the inverse kernel's columns per block (its threads) and rows per group
// (kernels/trsm.py INV_COLS, INV_ROWS), as trsm.cu's
constexpr int kInvCols = 64;
constexpr int kInvRows = 8;

template <int BM>
struct Inv {
  static constexpr int CHUNKS = BM / kInvCols;
  // x of the block's columns [BM][kInvCols] and two groups' rows of D
  // [BM][kInvRows] each, all float32
  static constexpr int SMEM = 4 * BM * (kInvCols + 2 * kInvRows);
  static_assert(BM % kInvCols == 0, "whole column chunks");
};

template <int BM>
__global__ void __launch_bounds__(kInvCols)
trsm_inv_bf16_kernel(const bf16* __restrict__ A, bf16* __restrict__ inv,
                     int m, long long sAb, long long lda) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // x_(j0 + k) of column j0 + t at k, t
  const int lo = blockIdx.x * BM;
  const int r = min(BM, m - lo);
  const int j0 = blockIdx.y * kInvCols;
  const long long z = blockIdx.z;
  const bf16* D = A + z * sAb + lo * lda + lo;
  bf16* W = inv + (z * gridDim.x + blockIdx.x) * (long long)(BM * BM);
  const int t = threadIdx.x, j = j0 + t;
  const int w0 = j0 + (t / 32) * 32;  // this warp's first column
  const bool own = j < r;
  const bf16 zero = __float2bfloat16_rn(0.f);
  // zero in column j: the rows above this warp's first column, and every
  // row of a column or past a row the block does not have
  for (int i = 0; i < BM; ++i)
    if (!own || i < w0 || i >= r) W[i * BM + j] = zero;
  if (j0 >= r) return;  // uniform in the block
  // Stores D[i0 + q][j0 + k] of the group at i0, as float32, to buf at k, q
  // (zero past r and above the diagonal, which no product reads): a
  // thread's 8 rows of a column loaded together.
  auto stage = [&](float* buf, int i0) {
    for (int k = t; k < i0 + kInvRows - j0; k += kInvCols) {
      float v[kInvRows];
#pragma unroll
      for (int q = 0; q < kInvRows; ++q) {
        const int i = i0 + q;
        v[q] = i < r && j0 + k <= i ? __bfloat162float(D[i * lda + j0 + k])
                                    : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kInvRows; ++q) buf[k * kInvRows + q] = v[q];
    }
  };
  float* const bufs[2] = {smem + BM * kInvCols,
                          smem + BM * (kInvCols + kInvRows)};
  stage(bufs[0], j0);
  int cur = 0;
#pragma unroll 1
  for (int i0 = j0; i0 < r; i0 += kInvRows, cur ^= 1) {
    // this group's rows are stored, and every read of the other buffer
    // (the last group's) is done: stage the next group's rows there
    __syncthreads();
    if (i0 + kInvRows < r) stage(bufs[cur ^ 1], i0 + kInvRows);
    if (i0 < w0) continue;  // the group lies above this warp's columns
    const float* ds = bufs[cur];  // D[i0 + q][j0 + k] at k, q
    float acc[kInvRows];
#pragma unroll
    for (int q = 0; q < kInvRows; ++q) acc[q] = i0 + q == j ? 1.f : 0.f;
    // x_k of rows above the group (zero above row j, so they add nothing)
#pragma unroll 4
    for (int k = w0 - j0; k < i0 - j0; ++k) {
      const float xk = xs[k * kInvCols + t];
      const float4 d0 = *reinterpret_cast<const float4*>(ds + k * kInvRows);
      const float4 d1 =
          *reinterpret_cast<const float4*>(ds + k * kInvRows + 4);
      acc[0] = fmaf(-d0.x, xk, acc[0]);
      acc[1] = fmaf(-d0.y, xk, acc[1]);
      acc[2] = fmaf(-d0.z, xk, acc[2]);
      acc[3] = fmaf(-d0.w, xk, acc[3]);
      acc[4] = fmaf(-d1.x, xk, acc[4]);
      acc[5] = fmaf(-d1.y, xk, acc[5]);
      acc[6] = fmaf(-d1.z, xk, acc[6]);
      acc[7] = fmaf(-d1.w, xk, acc[7]);
    }
    // the group's own triangle; D[i0 + q][i0 + p] at dq[p * kInvRows]
    float x[kInvRows];
#pragma unroll
    for (int q = 0; q < kInvRows; ++q) {
      const float* dq = ds + (i0 - j0) * kInvRows + q;
#pragma unroll
      for (int p = 0; p < q; ++p)
        acc[q] = fmaf(-dq[p * kInvRows], x[p], acc[q]);
      const int i = i0 + q;
      x[q] = i < j ? 0.f : acc[q] / dq[q * kInvRows];
      if (own && i < r) {
        xs[(i - j0) * kInvCols + t] = x[q];
        W[i * BM + j] = __float2bfloat16_rn(x[q]);
      }
    }
  }
}

// -- the substitution's tile -------------------------------------------------

// wgemm::Tile<BM, BN, 64> with the substitution's own blocks an SM, ring
// and shared region (kernels/trsm.py::trsm_params mirrors them).  The
// region comes first in the dynamic shared memory, then the ring, its
// barriers, release counts and pending steps (28 bytes a stage).
template <int BM_, int BN_>
struct Tile : wgemm::Tile<BM_, BN_, BK> {
  using Base = wgemm::Tile<BM_, BN_, BK>;
  // the region: a block row's BM x PN values as B stages are laid out;
  // it stages B_i and then holds R_i
  static constexpr int REGION = BM_ * Base::PN * 2;
  // the ring's budget at 2 blocks an SM, the blocks, the budget at those
  static constexpr int BUDGET2 = wgemm::kSmemSM / 2 - 4 * kAlign - REGION;
  static constexpr int BLOCKS =
      cmin(Base::BLOCKS, 2) == 2 && BUDGET2 >= 3 * Base::STAGE_BYTES ? 2 : 1;
  static constexpr int RING_BUDGET =
      wgemm::kSmemSM / BLOCKS - 4 * kAlign - REGION;
  static constexpr int STAGES = cmax(
      2, cmin(wgemm::kMaxStages, RING_BUDGET / Base::STAGE_BYTES));
  static constexpr int SMEM =
      kAlign + REGION + STAGES * Base::STAGE_BYTES + 28 * STAGES;
  static_assert(Base::PASSES_N == 1 && Base::PN == BN_,
                "a pass holds every column of the strip");
  static_assert(Base::GROUP == 1, "a group of products a stage");
  static_assert(STAGES <= 32, "a lane a stage");
  static_assert(SMEM <= wgemm::kSmemMax, "227 KB of shared memory per block");
};

// -- the step sequence -------------------------------------------------------

// Where a step reads: block row i (-1: no step), step s (0: A's block row
// against X; 1: D_i^-1 against R_i), the first row of its pass in the
// block row and its first contraction index.
struct Step {
  int i, s, prow, k0;
};

// The steps of a strip: block rows in order; per block row, step 0's
// passes, each over lo / 64 steps, then step 1's, the pass at prow over
// min(prow + PM, r) / 64 steps (rounded up), passes top-down.
template <class T>
struct TrsmSteps {
  int m, nb;
  // 64-index steps of a block row and of a pass's rows; step 1's steps in
  // a whole block row
  static constexpr int Q = T::BM / BK, QP = T::PM / BK, P = T::PASSES_M;
  static constexpr int S1 = QP * P * (P + 1) / 2;
  __host__ __device__ int rows(int i) const {
    return cmin(T::BM, m - i * T::BM);
  }
  __host__ __device__ int passes(int i) const {
    return (rows(i) + T::PM - 1) / T::PM;
  }
  // the steps of each pass of step 0, and of step 1's pass pm
  __host__ __device__ int count0(int i) const { return i * Q; }
  __host__ __device__ int count1(int i, int pm) const {
    return (cmin((pm + 1) * T::PM, rows(i)) + BK - 1) / BK;
  }
  // the steps before block row i (every block row but the last is whole)
  __host__ __device__ int before(int i) const {
    return P * Q * (i * (i - 1) / 2) + S1 * i;
  }
  __host__ __device__ int total() const {
    const int l = nb - 1;
    int t = before(l) + passes(l) * count0(l);
    for (int pm = 0; pm < passes(l); ++pm) t += count1(l, pm);
    return t;
  }
  // the first step: block row 0's step 1 (its step 0 has no steps)
  static __host__ __device__ Step first() { return {0, 1, 0, 0}; }
  // the step after w: the next index of its pass, else the next pass, else
  // step 1's first pass, else the next block row's step 0 (which has steps:
  // i + 1 >= 1)
  __host__ __device__ Step next(Step w) const {
    w.k0 += BK;
    const int r = rows(w.i);
    if (w.k0 < (w.s ? cmin(w.prow + T::PM, r) : w.i * T::BM)) return w;
    if (w.prow + T::PM < r) return {w.i, w.s, w.prow + T::PM, 0};
    return w.s ? Step{w.i + 1, 0, 0, 0} : Step{w.i, 1, 0, 0};
  }
};

// -- the producer ------------------------------------------------------------

// Stages the R x C window at (i0, j0) of X (leading stride ld, rows x cols
// stored; zero past them) as TMA would: wgemm::stage_window's layout, its
// 2-byte loads through L2, since this block writes X while it runs.
template <int R, int C, int NT>
__device__ __forceinline__ void stage_x(unsigned char* dst, const bf16* p,
                                        long long ld, int rows, int cols,
                                        int i0, int j0) {
  constexpr int W = cmin(C, kSlab), CH = C / 8, N = R * CH;
#pragma unroll 1
  for (int t = threadIdx.x; t < N; t += NT) {
    const int i = t / CH, j = (t % CH) * 8;
    const int gi = i0 + i, gj = j0 + j;
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(p + gi * ld + gj);
    unsigned v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = gi < rows && gj + e < cols ? __ldcg(src + e) : 0u;
    wgemm::put8<2 * W>(dst + (j / W) * R * 2 * W, i, (j % W) / 8,
                       wgemm::pack8(v));
  }
}

// A step's stages: A's PM x 64 window (step 0: A's block row at (lo + prow,
// k0); step 1: D_i^-1's at (prow, k0), rows of the inverses' 2-D map) in
// TMA boxes of 64 x 64, K-major, and, for step 0, X's 64 x PN window at
// rows k0 in boxes of 64 columns, MN-major (step 1's B is R_i's region).
// Boxes of rows past the block row's last row or columns past n are not
// copied.  Without TMA the threads write both in the same layout.
template <class T>
struct TrsmProducer {
  const CUtensorMap* ma;
  const CUtensorMap* mi;
  const CUtensorMap* mx;
  int za, zx;     // A's and X's map batch coordinates (-1: a 2-D map)
  int inv_row0;   // this item's first row of the inverses: z nb BM
  const bf16* A;  // this item's
  const bf16* inv;
  const bf16* X;  // this item's
  long long lda, ldx;
  int m, n, col0;
  bool use_tma;
  // the epoch after which the step's copies may be issued: the rows of X
  // it reads stored and fenced, X_q's at the end of block row q's step 1
  __device__ int need(Step w) const {
    return use_tma && !w.s ? 2 * (w.k0 / T::BM) + 2 : 0;
  }
  __device__ int rows(Step w) const {
    return cmin(T::BM, m - w.i * T::BM);
  }
  __device__ int a_boxes(Step w) const {
    return wgemm::boxes_inside(rows(w), w.prow, kSlab, T::PM / kSlab);
  }
  __device__ int b_boxes() const {
    return wgemm::boxes_inside(n, col0, kSlab, T::PN / kSlab);
  }
  __device__ int tma_bytes(Step w) const {
    if (!use_tma) return 0;
    return a_boxes(w) * kSlab * BK * 2 + (w.s ? 0 : b_boxes() * T::SLAB_BYTES);
  }
  __device__ void issue(uint32_t a, uint32_t b, uint32_t bar,
                        Step w) const {
    const int lo = w.i * T::BM, na = a_boxes(w);
    for (int j = 0; j < na; ++j) {
      const int row = lo + w.prow + j * kSlab;
      if (w.s)
        wgemm::tma_load(a + j * kSlab * BK * 2, mi, bar, w.k0,
                        inv_row0 + row, -1);
      else
        wgemm::tma_load(a + j * kSlab * BK * 2, ma, bar, w.k0, row, za);
    }
    if (w.s) return;
    const int nb = b_boxes();
    for (int j = 0; j < nb; ++j)
      wgemm::tma_load(b + j * T::SLAB_BYTES, mx, bar, col0 + j * kSlab, w.k0,
                      zx);
  }
  __device__ void write(unsigned char* a, unsigned char* b, Step w) const {
    const int lo = w.i * T::BM, r = rows(w);
    if (w.s) {
      wgemm::stage_window<T::PM, BK, T::THREADS>(
          a, inv + (inv_row0 + lo) * (long long)T::BM, T::BM, r, r, w.prow,
          w.k0);
    } else {
      wgemm::stage_window<T::PM, BK, T::THREADS>(a, A + lo * lda, lda, r,
                                                 lo, w.prow, w.k0);
      stage_x<BK, T::PN, T::THREADS>(b, X, ldx, m, n, w.k0, col0);
    }
  }
};

// -- the ring ----------------------------------------------------------------

// Step w's copies into stage s, which no warp reads any more.
template <class T>
__device__ __forceinline__ void fill(const wgemm::Ring<T>& ring,
                                     const TrsmProducer<T>& prod, int s,
                                     Step w) {
  const int bytes = prod.tma_bytes(w);
  if (bytes) {
    wgemm::bar_arrive_tx(ring.full(s), bytes);
    const uint32_t a = ring.stage_s(s);
    prod.issue(a, a + T::A_BYTES, ring.full(s), w);
  } else {
    wgemm::bar_arrive(ring.full(s));
  }
}

// The ring's pending steps, a slot a stage after its release counts.
template <class T>
__device__ __forceinline__ Step* pending_of(const wgemm::Ring<T>& ring) {
  return reinterpret_cast<Step*>(ring.released + T::STAGES);
}

// Fills stage s with step w now if the epoch it needs has come, else
// leaves w pending in the stage's slot for the epilogue that brings that
// epoch.
template <class T>
__device__ __forceinline__ void refill(const wgemm::Ring<T>& ring,
                                       const TrsmProducer<T>& prod,
                                       int epoch, int s, Step w) {
  if (prod.need(w) <= epoch)
    fill(ring, prod, s, w);
  else
    pending_of(ring)[s] = w;
}

// Before the first pass: every thread walks the first STAGES steps, lane f
// of warp 0 clearing slot f and filling step f or leaving it pending.
// Returns step STAGES, the first release's refill.
template <class T>
__device__ __forceinline__ Step prime(const wgemm::Ring<T>& ring,
                                      const TrsmProducer<T>& prod,
                                      const TrsmSteps<T>& st, int total) {
  Step w = st.first();
#pragma unroll 1
  for (int f = 0; f < T::STAGES; ++f, w = st.next(w)) {
    if (int(threadIdx.x) != f) continue;
    pending_of(ring)[f].i = -1;
    if (f < total) refill(ring, prod, 0, f, w);
  }
  __syncwarp();
  return w;
}

// The end of a step's epilogues: the threads' stores of X and of the
// region before the async proxy's reads, the barrier, and the pending
// steps whose epoch has now come, issued by lanes of warp 0.
template <class T>
__device__ __forceinline__ void publish(const wgemm::Ring<T>& ring,
                                        const TrsmProducer<T>& prod,
                                        int epoch) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  wgemm::fence_proxy_async();
  __syncthreads();
  Step* pending = pending_of(ring);
  if (threadIdx.x < T::STAGES) {
    const Step w = pending[threadIdx.x];
    if (w.i >= 0 && prod.need(w) <= epoch) {
      pending[threadIdx.x].i = -1;
      fill(ring, prod, threadIdx.x, w);
    }
  }
  __syncwarp();
}

// A warpgroup's accumulators of the pass at o over steps g0 .. g0 + count
// - 1 (zero when there are none), after prime; every thread of the block
// calls it for every pass in turn.  wgemm::consume's protocol with groups
// of one stage: each stage's products issued as its `full` barrier
// completes, committed, and once the step before has retired its stage is
// released, the last warp refilling it (refill) with the step STAGES
// ahead.  Every thread keeps that step in `ahead` and moves it on by one
// step a release (TrsmSteps::next).  B comes from the stage (step 0) or
// from R_i's region at region_s (step 1: its 64-row block of the step).
// Leaves no wgmma in flight.
template <class T>
__device__ __forceinline__ void consume(const wgemm::Ring<T>& ring,
                                        const TrsmProducer<T>& prod,
                                        const TrsmSteps<T>& st, int epoch,
                                        int total, int g0, int count, Step o,
                                        uint32_t region_s, Step& ahead,
                                        float (&acc)[T::ACC]) {
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;
  wgemm::fence_acc(acc);
  // the release of step h, whose refill h + STAGES lies at `ahead`
  auto release = [&](int h) {
    if (lane == 0) {
      const int s = h % T::STAGES;
      __threadfence_block();
      if (atomicAdd(ring.released + s, 1) == 4 * T::WARPGROUPS - 1) {
        ring.released[s] = 0;
        __threadfence_block();
        if (h + T::STAGES < total) refill(ring, prod, epoch, s, ahead);
      }
    }
    __syncwarp();
    ahead = st.next(ahead);
  };
  int held = -1;
  for (int g = g0; g < g0 + count; ++g) {
    const int s = g % T::STAGES;
    const Step w{o.i, o.s, o.prow, o.k0 + (g - g0) * BK};
    wgemm::bar_wait(ring.full(s), (g / T::STAGES) & 1);
    if (!prod.use_tma) {
      prod.write(ring.stage(s), ring.stage(s) + T::A_BYTES, w);
      wgemm::fence_proxy_async();
      __syncthreads();
    }
    const uint32_t a = ring.stage_s(s);
    const uint32_t b =
        w.s ? region_s + w.k0 / BK * T::B_BYTES : a + T::A_BYTES;
    wgemm::wgmma_fence();
    wgemm::stage_mma<T, 0>(a, b, wg, acc);
    wgemm::wgmma_commit();
    wgemm::wgmma_wait<1>();
    if (held >= 0) release(held);
    held = g;
  }
  wgemm::wgmma_wait<0>();
  wgemm::fence_acc(acc);
  if (held >= 0) release(held);
}

// -- the epilogues -----------------------------------------------------------

// The byte offset of row r, columns c and c + 1 in the region: 64-row
// blocks of PN / 64 slabs, each 64 rows of 128 bytes swizzled over 128
// bytes, the layout of a stage's B (and of TMA's boxes)
template <class T>
__device__ __forceinline__ int region_at(int r, int c) {
  const int off = (r % kSlab) * 128 + (c % kSlab) * 2;
  return (r / kSlab) * T::B_BYTES + (c / kSlab) * T::SLAB_BYTES +
         (off ^ (((off >> 7) & 7) << 4));
}

struct Args {
  const bf16* A;
  const bf16* B;
  const bf16* inv;  // [batch][ceil(m / BM)][BM][BM], from trsm_inv_bf16
  bf16* X;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sXb, ldx;
  float alpha;
  int tma, za, zb, zx;  // TMA reads A, B, the inverses and X; A's, B's and
                        // X's maps' batch coordinates
};

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS, Tile<BM, BN>::BLOCKS)
trsm_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap mb,
                 const __grid_constant__ CUtensorMap mi,
                 const __grid_constant__ CUtensorMap mx, const Args p) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = wgemm::smem_u32(smem_raw);
  unsigned char* region =
      smem_raw + ((kAlign - (raw_s & (kAlign - 1))) & (kAlign - 1));
  // B_i's copy into the region, one block row ahead
  __shared__ __align__(8) unsigned long long b_full_bar;
  const uint32_t b_full = wgemm::smem_u32(&b_full_bar);
  if (threadIdx.x == 0) wgemm::bar_init(b_full, 1);
  const wgemm::Ring<T> ring = wgemm::make_ring<T>(region + T::REGION);
  const uint32_t region_s = wgemm::smem_u32(region);

  const int col0 = blockIdx.x * BN;
  const int nb = (p.m + BM - 1) / BM;
  const int z = blockIdx.z;
  const bf16* B = p.B + z * p.sBb;
  bf16* X = p.X + z * p.sXb;
  const TrsmProducer<T> prod{&ma, &mi, &mx, p.za < 0 ? -1 : z,
                             p.zx < 0 ? -1 : z, z * nb * BM,
                             p.A + z * p.sAb, p.inv, X, p.lda, p.ldx, p.m,
                             p.n, col0, bool(p.tma)};
  const TrsmSteps<T> st{p.m, nb};
  const int total = st.total();
  // B_i (rows lo .. lo + r - 1 of the strip) into the region, laid out as
  // R_i will be there, by thread 0 when TMA reads B: before the first
  // block row, then at the end of the block row before, once step 1 has
  // read R_{i-1}
  auto stage_b = [&](int i) {
    if (!p.tma || threadIdx.x != 0) return;
    const int nr = wgemm::boxes_inside(st.rows(i), 0, kSlab, BM / kSlab);
    const int nc = prod.b_boxes();
    wgemm::bar_arrive_tx(b_full, nr * nc * T::SLAB_BYTES);
    for (int q = 0; q < nr; ++q)
      for (int c = 0; c < nc; ++c)
        wgemm::tma_load(region_s + q * T::B_BYTES + c * T::SLAB_BYTES,
                        &mb, b_full, col0 + c * kSlab, i * BM + q * kSlab,
                        p.zb < 0 ? -1 : z);
  };
  stage_b(0);
  // the step the first release refills
  Step ahead = prime(ring, prod, st, total);
  int g = 0;
#pragma unroll 1
  for (int i = 0; i < nb; ++i) {
    const int lo = i * BM, r = st.rows(i), passes = st.passes(i);
    // step 0: R_i = bf16(alpha B_i) - bf16(A[i, :lo] @ X[:lo]), rounded,
    // into the region; zeros past r and n.  B_i from the region (its copy
    // waited for) or, without TMA, from B
#pragma unroll 1
    for (int pm = 0; pm < passes; ++pm) {
      const int prow = pm * T::PM, count = st.count0(i);
      float acc[T::ACC];
      consume(ring, prod, st, 2 * i, total, g, count, Step{i, 0, prow, 0},
              region_s, ahead, acc);
      g += count;
      if (p.tma) wgemm::bar_wait(b_full, i & 1);
      // every row and column of the pass, the region's zeros included
      wgemm::for_each_acc<T>(
          acc, prow, 0, BM, T::PN,
          [&](int row, int c, float v0, float v1, bool) {
        const int col = col0 + c;
        const bool in = row < r && col < p.n, in1 = in && col + 1 < p.n;
        __nv_bfloat162* at =
            reinterpret_cast<__nv_bfloat162*>(region + region_at<T>(row, c));
        float2 bv = make_float2(0.f, 0.f);
        if (p.tma) {
          bv = __bfloat1622float2(*at);
        } else {
          const bf16* b = B + (lo + row) * p.ldb + col;
          if (in) bv.x = __bfloat162float(__ldg(b));
          if (in1) bv.y = __bfloat162float(__ldg(b + 1));
        }
        auto value = [&](bool ok, float bval, float v) {
          if (!ok) return 0.f;
          const float s =
              __bfloat162float(__float2bfloat16_rn(__fmul_rn(p.alpha, bval)));
          return __fsub_rn(s, __bfloat162float(__float2bfloat16_rn(v)));
        };
        *at = __floats2bfloat162_rn(value(in, bv.x, v0), value(in1, bv.y, v1));
      });
    }
    publish(ring, prod, 2 * i + 1);
    // step 1: X_i = bf16(D_i^-1 @ R_i), each pass ending at its last row
#pragma unroll 1
    for (int pm = 0; pm < passes; ++pm) {
      const int prow = pm * T::PM, count = st.count1(i, pm);
      float acc[T::ACC];
      consume(ring, prod, st, 2 * i + 1, total, g, count,
              Step{i, 1, prow, 0}, region_s, ahead, acc);
      g += count;
      wgemm::for_each_acc<T>(
          acc, prow, 0, BM, T::PN,
          [&](int row, int c, float v0, float v1, bool) {
        const int col = col0 + c;
        if (row < r && col < p.n)
          wgemm::store2(X + (lo + row) * p.ldx + col, v0, v1, col + 1 < p.n);
      });
    }
    publish(ring, prod, 2 * i + 2);
    if (i + 1 < nb) stage_b(i + 1);
  }
}

// The launch parameters of a tile: the substitution's threads, stages,
// dynamic shared bytes, passes, warpgroups, blocks an SM and shared
// region bytes, the inverse kernel's threads and dynamic shared bytes, and
// the workspace bytes of one diagonal block (kernels/trsm.py::trsm_params
// with dtype=torch.bfloat16 mirrors them).
template <int BM, int BN>
void config(int* out) {
  using T = Tile<BM, BN>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES;
  out[4] = T::WARPGROUPS;
  out[5] = T::BLOCKS;
  out[6] = T::REGION;
  out[7] = kInvCols;
  out[8] = Inv<BM>::SMEM;
  out[9] = 2 * BM * BM;
}

template <int BM>
cudaError_t launch_inv(const bf16* a, bf16* inv, int m, int batch,
                       long long sAb, long long lda, cudaStream_t stream,
                       int* launched) {
  const cudaError_t e = cudaFuncSetAttribute(
      trsm_inv_bf16_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Inv<BM>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + BM - 1) / BM, Inv<BM>::CHUNKS, batch);
  set_grid(launched, grid);
  trsm_inv_bf16_kernel<BM>
      <<<grid, kInvCols, Inv<BM>::SMEM, stream>>>(a, inv, m, sAb, lda);
  return cudaGetLastError();
}

// Whether TMA reads A, B, the inverses and X, and their maps: A, B and X
// in boxes of 64 x 64, the inverses ([batch nb BM][BM], contiguous) as one
// 2-D map of them, all swizzled over 128 bytes.  Returns 0 or a launcher
// error code.
template <int BM>
int encode(Args& p, bool vec, CUtensorMap* ma, CUtensorMap* mb,
           CUtensorMap* mi, CUtensorMap* mx) {
  p.tma = wgemm::tma_layout(vec, p.m, p.m, p.batch, p.lda, p.sAb) &&
          wgemm::tma_layout(vec, p.m, p.n, p.batch, p.ldb, p.sBb) &&
          wgemm::tma_layout(vec, p.m, p.n, p.batch, p.ldx, p.sXb);
  p.za = p.zb = p.zx = -1;
  if (!p.tma) return 0;
  const int nb = (p.m + BM - 1) / BM;
  int zi, rc = wgemm::encode_map(ma, &p.za, p.A, p.m, p.m, p.batch, p.lda,
                                 p.sAb, kSlab, kSlab, 128);
  if (rc == 0)
    rc = wgemm::encode_map(mb, &p.zb, p.B, p.m, p.n, p.batch, p.ldb, p.sBb,
                           kSlab, kSlab, 128);
  if (rc == 0)
    rc = wgemm::encode_map(mi, &zi, p.inv, p.batch * nb * BM, BM, 1, BM, 0,
                           kSlab, kSlab, 128);
  if (rc == 0)
    rc = wgemm::encode_map(mx, &p.zx, p.X, p.m, p.n, p.batch, p.ldx, p.sXb,
                           kSlab, BK, 128);
  return rc;
}

template <int BM, int BN>
int launch(Args p, bool vec, cudaStream_t stream, int* launched) {
  using T = Tile<BM, BN>;
  CUtensorMap ma{}, mb{}, mi{}, mx{};
  const int rc = encode<BM>(p, vec, &ma, &mb, &mi, &mx);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      trsm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, 1, p.batch);
  set_grid(launched, grid);
  trsm_bf16_kernel<BM, BN>
      <<<grid, T::THREADS, T::SMEM, stream>>>(ma, mb, mi, mx, p);
  return cudaGetLastError();
}

}  // namespace

// the output tiles of the Hopper trsm knob space, and their diagonal
// blocks (trsm.cu's REPRO_TRSM_TILES and REPRO_TRSM_BLOCKS)
#define REPRO_TRSM_BF16_TILES(X)                                     \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)
#define REPRO_TRSM_BF16_BLOCKS(X) X(64) X(128) X(256)

// The bf16 inverses of the bm x bm diagonal blocks of tril(A) into inv
// ([batch][ceil(m / bm)][bm][bm] bf16, contiguous), with
// repro_trsm_inv_f32's arguments.  Returns the cudaError_t of the launch (0
// on success); cudaErrorInvalidValue for a bm with no instantiation.
// Writes the grid it launched to launched[0..2].  Does not synchronise.
extern "C" int repro_trsm_inv_bf16(int bm, const void* a, void* inv, int m,
                                   int batch, long long sAb, long long lda,
                                   void* stream, void* ev_start, void* ev_end,
                                   int* launched) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
  const bf16* pa = static_cast<const bf16*>(a);
  bf16* pi = static_cast<bf16*>(inv);
#define REPRO_TRSM_INV_BF16_LAUNCH(BM) \
  if (bm == BM)                        \
    return int(launch_inv<BM>(pa, pi, m, batch, sAb, lda, s, launched));
  REPRO_TRSM_BF16_BLOCKS(REPRO_TRSM_INV_BF16_LAUNCH)
#undef REPRO_TRSM_INV_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The substitution under the tile bm x bn, from the inverses of
// repro_trsm_inv_bf16 with the same bm, into x (which may not overlap A, B
// or inv), with repro_trsm_f32's arguments (A, B, inv and X bf16).
// Returns and reports as repro_trsm_inv_bf16, or wgemm::kEncodeFailed +
// the CUresult when a tensor map cannot be encoded.  vec says that A, B,
// X, their leading strides and batch strides are 16-byte aligned (TMA
// reads A, the inverses and X).
extern "C" int repro_trsm_bf16(int bm, int bn, const void* a, const void* b,
                               const void* inv, void* x, int m, int n,
                               int batch, long long sAb, long long lda,
                               long long sBb, long long ldb, long long sXb,
                               long long ldx, float alpha, int vec,
                               void* stream, void* ev_start, void* ev_end,
                               int* launched) {
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
               static_cast<const bf16*>(inv), static_cast<bf16*>(x),
               m, n, batch, sAb, lda, sBb, ldb, sXb, ldx, alpha, 0, -1, -1,
               -1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_TRSM_BF16_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return launch<BM, BN>(p, vec != 0, s, launched);
  REPRO_TRSM_BF16_TILES(REPRO_TRSM_BF16_LAUNCH)
#undef REPRO_TRSM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The step after in[0..3] (block row, step, first row of its pass, first
// contraction index) in a block's sequence under the tile bm x bn at m
// rows, as the kernel's refills move on (TrsmSteps::next), to out[0..3],
// and the first step (TrsmSteps::first) to out[4..7]; returns the
// sequence's length (TrsmSteps::total), or -1 for a tile with no
// instantiation.  kernels/trsm.py::step_plan mirrors them.
extern "C" int repro_trsm_bf16_step(int bm, int bn, int m, const int* in,
                                    int* out) {
#define REPRO_TRSM_BF16_STEP(BM, BN)                              \
  if (bm == BM && bn == BN) {                                     \
    using S = TrsmSteps<Tile<BM, BN>>;                            \
    const S st{m, (m + BM - 1) / BM};                             \
    const Step v = st.next(Step{in[0], in[1], in[2], in[3]});     \
    const Step f = S::first();                                    \
    out[0] = v.i, out[1] = v.s, out[2] = v.prow, out[3] = v.k0;   \
    out[4] = f.i, out[5] = f.s, out[6] = f.prow, out[7] = f.k0;   \
    return st.total();                                            \
  }
  REPRO_TRSM_BF16_TILES(REPRO_TRSM_BF16_STEP)
#undef REPRO_TRSM_BF16_STEP
  return -1;
}

// The launch parameters the kernels of a tile were built with, to
// out[0..9] (config above).
extern "C" int repro_trsm_bf16_config(int bm, int bn, int* out) {
#define REPRO_TRSM_BF16_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return config<BM, BN>(out), 0;
  REPRO_TRSM_BF16_TILES(REPRO_TRSM_BF16_CONFIG)
#undef REPRO_TRSM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}
