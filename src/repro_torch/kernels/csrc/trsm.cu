// TRSM for Hopper (sm_90a): X with tril(A) @ X = alpha * B (left, lower,
// non-unit), A (m, m), B and X (m, n), float32 in and out, in IEEE
// arithmetic on the CUDA cores.  Two kernels, so two launches a call
// whatever m and the batch.
//
// Replaces the reference package's src/repro/kernels/trsm.py::trsm_pallas, a
// blocked forward substitution unrolled at trace time: the inverses D_i^-1
// of the bm x bm diagonal blocks (XLA's triangular_solve against I), then,
// block row after block row, two Pallas GEMMs
//   R_i = alpha B_i - A[i, :lo] @ X[:lo]   and   X_i = D_i^-1 @ R_i.
// Here both parts are kernels, and the loop over block rows runs inside a
// block: the place a sequential grid axis takes on Hopper.
//
// trsm_inv_kernel: D_i^-1 of every diagonal block of tril(A), the ragged
// last one at its true size r, for every item, into a workspace
// [batch][ceil(m / bm)][bm][bm] (zeros above the diagonal and past r, so a
// stack's workspace equals its items' bit for bit).  Grid (block, column
// chunk, batch) of 64 threads, thread t owning column j = j0 + t: column j
// solves D_i x = e_j by forward substitution,
//   x_i = (delta_ij - sum_{k < i} D_ik x_k) / D_ii,
// its products added in increasing k with fmaf and the quotient rounded
// once.  Rows go in groups of 8: the group's rows of D (on and below A's
// diagonal only) are staged transposed in shared memory by cp.async while
// the group before computes, so per k a thread reads D[i0 .. i0 + 7][k] as
// two 16-byte broadcast loads and its own x_k (from shared memory:
// registers cannot be indexed), 8 FMAs on 8 independent sums; then the
// group's own 8 x 8 triangle.  A warp starts at its first column, so it
// skips the groups above it.  O(m bm^2) operations; column 0's chain of
// about bm^2 / 16 steps of 8 FMAs sets its time.  No atomics, and no result
// depends on how many items or blocks share the launch.
//
// trsm_kernel: the substitution.  Grid (ceil(n / bn), 1, batch): a block
// owns the column strip X[:, c0 : c0 + bn] of one item and walks the block
// rows i = 0 .. ceil(m / bm) - 1 in order; columns of X are independent, so
// no block waits on another.  Per block row, two steps, each a contraction
// on the f32 mainloop (sgemm_mainloop.cuh, tiles above 128 x 128 as passes)
// fed by the GEMM's producer:
//   0. R_i = alpha B_i - A[i, :lo] @ X[:lo, strip] over lo / 64 contraction
//      steps, stored by the GEMM's beta C epilogue at alpha' = -1, beta =
//      alpha.  Block row 0 has none: R_0 = B_0, and alpha scales step 1;
//   1. X_i = D_i^-1 @ R_i, each pass of rows stopping at its last row (at
//      most bm contraction steps): D_i^-1 is zero past its diagonal.
// R_i is parked in X's own rows of block row i, not in a workspace.  The
// passes of rows run bottom-up: a pass of step 1 reads R only at or above
// its own last row, which no earlier pass (all below it) has overwritten
// with X_i.  A __syncthreads after each step's stores publishes R_i to step
// 1 and X_i to the next block row's copies of X[:lo], which this block
// wrote (the 4-byte cp.async.ca copies of an unaligned n read them through
// L1).
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 67 TFLOP/s
// against 4 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so past m of a few dozen
// the operations bound it, and the blocks run the mainloop that keeps the
// FMAs fed.  The grid is n / bn blocks per item (224, 112 or 56 at the
// (4096, 4096) x (4096, 14336) call, every block the same work); each
// reads its strip of X[:lo] back, about 1 ms of HBM at that call under some
// 7 ms of FMAs.  The tensor cores stay unused: IEEE f32 only.

#include "launch_grid.cuh"
#include "sgemm_mainloop.cuh"

namespace {

// the substitution's tile: output rows bm, columns bn, contraction step 64
// (core/knobs.py HOPPER_CONTRACTION_STEP)
template <int BM, int BN>
using Tile = sgemm::Tile<BM, BN, 64>;

// the inverse kernel's columns per block (its threads) and rows per group
// (kernels/trsm.py INV_COLS, INV_ROWS)
constexpr int kInvCols = 64;
constexpr int kInvRows = 8;

template <int BM>
struct Inv {
  static constexpr int CHUNKS = BM / kInvCols;
  // x of the block's columns [BM][kInvCols] and two groups' rows of D
  // [BM][kInvRows] each
  static constexpr int SMEM = 4 * BM * (kInvCols + 2 * kInvRows);
  static_assert(BM % kInvCols == 0, "whole column chunks");
};

template <int BM>
__global__ void __launch_bounds__(kInvCols)
trsm_inv_kernel(const float* __restrict__ A, float* __restrict__ inv, int m,
                long long sAb, long long lda) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // x_(j0 + k) of column j0 + t at k, t
  const int lo = blockIdx.x * BM;
  const int r = min(BM, m - lo);
  const int j0 = blockIdx.y * kInvCols;
  const long long z = blockIdx.z;
  const float* D = A + z * sAb + lo * lda + lo;
  float* W = inv + (z * gridDim.x + blockIdx.x) * (long long)(BM * BM);
  const int t = threadIdx.x, j = j0 + t;
  const int w0 = j0 + (t / 32) * 32;  // this warp's first column
  const bool own = j < r;
  // zero in column j: the rows above this warp's first column, and every
  // row of a column or past a row the block does not have
  for (int i = 0; i < BM; ++i)
    if (!own || i < w0 || i >= r) W[i * BM + j] = 0.f;
  if (j0 >= r) return;  // uniform in the block
  // Copies D[i0 + q][j0 + k] of the group at i0 to buf at k, q (zero past
  // r and above the diagonal, which no copy reads): one float a cp.async,
  // a thread's 8 rows of a column in flight together.
  auto stage = [&](float* buf, int i0) {
    for (int k = t; k < i0 + kInvRows - j0; k += kInvCols) {
#pragma unroll
      for (int q = 0; q < kInvRows; ++q) {
        const int i = i0 + q;
        const bool ok = i < r && j0 + k <= i;
        sgemm::cp_async4(buf + k * kInvRows + q,
                         ok ? D + i * lda + j0 + k : D, ok ? 4 : 0);
      }
    }
    sgemm::cp_async_commit();
  };
  float* const bufs[2] = {smem + BM * kInvCols,
                          smem + BM * (kInvCols + kInvRows)};
  stage(bufs[0], j0);
  int cur = 0;
#pragma unroll 1
  for (int i0 = j0; i0 < r; i0 += kInvRows, cur ^= 1) {
    // this group's rows have landed, and every read of the other buffer
    // (the last group's) is done: copy the next group's rows there while
    // this one computes
    sgemm::cp_async_wait<0>();
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
        W[i * BM + j] = x[q];
      }
    }
  }
}

struct Args {
  const float* A;
  const float* B;
  const float* inv;  // [batch][ceil(m / BM)][BM][BM], from trsm_inv_kernel
  float* X;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sXb, ldx;
  float alpha;
  int vec;
};

// One pass of a step: the PM x PN accumulators at (prow0, pcol0) of a @ b
// (a r x k, b k x n, both row-major) over the contraction [0, kend), stored
// into out (leading stride ldo) as fmaf(alpha, c, -acc) when c is given
// (step 0, the GEMM's epilogue at alpha' = -1, beta = alpha) and as
// scale * acc when not (step 1).  Not inlined: with the block-row loop
// around it, an inlined mainloop left ptxas no register to spare, and it
// spilled at five of the eight tiles.
template <class T>
__device__ __noinline__ void pass(float* smem, const float* a, const float* b,
                                  long long lda, long long ldb, int r, int n,
                                  int k, int kend, int prow0, int pcol0,
                                  bool vec, float* out, long long ldo,
                                  const float* c, long long ldc, float alpha,
                                  float scale) {
  const sgemm::GemmProducer<T> prod{a, b, lda, ldb, r, n, k,
                                    prow0, pcol0, vec};
  float acc[T::TM][T::TN];
  sgemm::mainloop<T>(smem, prod, 0, kend, sgemm::live_rows<T>(prow0, r),
                     acc);
  if (c)
    sgemm::for_each_acc<T>(acc, prow0, pcol0, r, n,
                           [&](int row, int col, float v) {
                             out[row * ldo + col] =
                                 fmaf(alpha, c[row * ldc + col], -v);
                           });
  else
    sgemm::for_each_acc<T>(acc, prow0, pcol0, r, n,
                           [&](int row, int col, float v) {
                             out[row * ldo + col] = __fmul_rn(scale, v);
                           });
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS)
trsm_kernel(const Args p) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int col0 = blockIdx.x * BN;
  const int nb = (p.m + BM - 1) / BM;
  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sAb;
  const float* B = p.B + z * p.sBb;
  const float* inv = p.inv + z * nb * (long long)(BM * BM);
  float* X = p.X + z * p.sXb;
#pragma unroll 1
  for (int i = 0; i < nb; ++i) {
    const int lo = i * BM, r = min(BM, p.m - lo);
    float* Xi = X + lo * p.ldx;
    // step 0: R_i = alpha B_i - A[i, :lo] @ X[:lo] into Xi (block row 0 has
    // none); step 1: X_i = scale * D_i^-1 @ R_i into Xi, where R_0 = B_0
#pragma unroll 1
    for (int step = i > 0 ? 0 : 1; step < 2; ++step) {
      const float* a = step ? inv + i * (long long)(BM * BM) : A + lo * p.lda;
      const float* b = step ? (i > 0 ? Xi : B) : X;
      const long long lda = step ? BM : p.lda;
      const long long ldb = step && i == 0 ? p.ldb : p.ldx;
      const float* c = step ? nullptr : B + lo * p.ldb;
#pragma unroll 1
      for (int pm = T::PASSES_M - 1; pm >= 0; --pm) {
#pragma unroll 1
        for (int pn = 0; pn < T::PASSES_N; ++pn) {
          const int prow0 = pm * T::PM, pcol0 = col0 + pn * T::PN;
          if (prow0 >= r || pcol0 >= p.n) continue;  // uniform in the block
          // D_i^-1 is zero past each row's diagonal: step 1's pass of rows
          // stops at its last row
          const int kend = step ? sgemm::cmin(prow0 + T::PM, r) : lo;
          pass<T>(smem, a, b, lda, ldb, r, p.n, step ? r : lo, kend, prow0,
                  pcol0, p.vec, Xi, p.ldx, c, p.ldb, p.alpha,
                  i > 0 ? 1.f : p.alpha);
        }
      }
      // R_i stored before step 1 copies it, X_i before the next block row
      // copies X[:lo]
      __syncthreads();
    }
  }
}

// The launch parameters of a tile: the substitution's threads, stages,
// dynamic shared bytes and passes, the inverse kernel's threads and dynamic
// shared bytes, and the workspace bytes of one diagonal block
// (kernels/trsm.py::trsm_params mirrors them).
template <int BM, int BN>
void config(int* out) {
  using T = Tile<BM, BN>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
  out[4] = kInvCols;
  out[5] = Inv<BM>::SMEM;
  out[6] = 4 * BM * BM;
}

template <int BM>
cudaError_t launch_inv(const float* a, float* inv, int m, int batch,
                       long long sAb, long long lda, cudaStream_t stream,
                       int* launched) {
  const cudaError_t e = cudaFuncSetAttribute(
      trsm_inv_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Inv<BM>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + BM - 1) / BM, Inv<BM>::CHUNKS, batch);
  set_grid(launched, grid);
  trsm_inv_kernel<BM>
      <<<grid, kInvCols, Inv<BM>::SMEM, stream>>>(a, inv, m, sAb, lda);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  using T = Tile<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      trsm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, 1, p.batch);
  set_grid(launched, grid);
  trsm_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// the output tiles of the Hopper trsm knob space, and their diagonal blocks
#define REPRO_TRSM_TILES(X)                                          \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)
#define REPRO_TRSM_BLOCKS(X) X(64) X(128) X(256)

// The inverses of the bm x bm diagonal blocks of tril(A) into inv
// ([batch][ceil(m / bm)][bm][bm], contiguous).  Returns the cudaError_t of
// the launch (0 on success); cudaErrorInvalidValue for a bm with no
// instantiation.  Writes the grid it launched to launched[0..2].  Does not
// synchronise.
extern "C" int repro_trsm_inv_f32(int bm, const void* a, void* inv, int m,
                                  int batch, long long sAb, long long lda,
                                  void* stream, void* ev_start, void* ev_end,
                                  int* launched) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
  const float* pa = static_cast<const float*>(a);
  float* pi = static_cast<float*>(inv);
#define REPRO_TRSM_INV_LAUNCH(BM) \
  if (bm == BM)                   \
    return int(launch_inv<BM>(pa, pi, m, batch, sAb, lda, s, launched));
  REPRO_TRSM_BLOCKS(REPRO_TRSM_INV_LAUNCH)
#undef REPRO_TRSM_INV_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The substitution under the tile bm x bn, from the inverses of
// repro_trsm_inv_f32 with the same bm, into x (which may not overlap A, B
// or inv).  Returns and reports as repro_trsm_inv_f32.  vec says that A, B,
// X, their leading strides and batch strides are 16-byte aligned.
extern "C" int repro_trsm_f32(int bm, int bn, const void* a, const void* b,
                              const void* inv, void* x, int m, int n,
                              int batch, long long sAb, long long lda,
                              long long sBb, long long ldb, long long sXb,
                              long long ldx, float alpha, int vec,
                              void* stream, void* ev_start, void* ev_end,
                              int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(inv), static_cast<float*>(x),
               m, n, batch, sAb, lda, sBb, ldb, sXb, ldx, alpha, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_TRSM_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, s, launched));
  REPRO_TRSM_TILES(REPRO_TRSM_LAUNCH)
#undef REPRO_TRSM_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernels of a tile were built with, to
// out[0..6] (config above).
extern "C" int repro_trsm_f32_config(int bm, int bn, int* out) {
#define REPRO_TRSM_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return config<BM, BN>(out), 0;
  REPRO_TRSM_TILES(REPRO_TRSM_CONFIG)
#undef REPRO_TRSM_CONFIG
  return int(cudaErrorInvalidValue);
}
