// TRSM for Hopper (sm_90a) in bfloat16: X with tril(A) @ X = alpha * B
// (left, lower, non-unit), A (m, m), B and X (m, n), all bfloat16.  Two
// kernels, so two launches a call whatever m and the batch; trsm.cu is
// their float32 twin, with the same grids, passes and walk over the block
// rows.
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
// trsm_bf16_kernel: the substitution on the bf16 mainloop
// (bf16_mainloop.cuh: cp.async ring, ldmatrix, mma.sync m16n8k16, float32
// accumulators).  Grid (ceil(n / bn), 1, batch): a block owns the column
// strip X[:, c0 : c0 + bn] of one item and walks the block rows in order.
// Per block row, two steps, passes of rows bottom-up, a __syncthreads
// after each:
//   0. acc = A[i, :lo] @ X[:lo, strip] over lo / 64 contraction steps (none
//      at block row 0: the mainloop leaves acc at 0), stored into X's rows
//      of block row i as R_i = bf16(float(bf16(alpha B)) - float(bf16(acc)));
//      at block row 0 that is bf16(alpha B_0), the reference's r;
//   1. X_i = bf16(D_i^-1 @ R_i) from the bf16 workspace, each pass of rows
//      stopping at its last row.  alpha is already in R.
// Both products are row-major A @ row-major B, the GEMM's step.  X is
// written by this block while it runs, so its tiles are read through L2
// only: cp.async.cg when every pointer and stride is 16-byte aligned, else
// 2-byte __ldcg loads (the mainloop's own 2-byte path reads through the
// non-coherent read-only cache, fit for A and the inverses only).  The
// same values land in the same places either way, so the bits are equal.
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 989 TFLOP/s
// of dense bf16 against 2 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so the
// (4096, 4096) x (4096, 14336) call is bound by its operations (0.24 ms).
// The block rows of a strip run one after the other, so the grid is n / bn
// blocks an item (224, 112 or 56 at that call) whatever m.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mainloop.cuh"
#include "launch_grid.cuh"

namespace {

using bgemm::bf16;

// the substitution's tile: output rows bm, columns bn, contraction step 64
// (core/knobs.py HOPPER_CONTRACTION_STEP)
template <int BM, int BN>
using Tile = bgemm::Tile<BM, BN, 64>;

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

// Stages the BK x PN window of X at (k0, pcol0) (rows x cols stored,
// leading stride ld) into s, row-major with stride T::LDB, zero past the
// edges: bf16_mainloop.cuh's load_tile when vec (cp.async.cg reads L2),
// else 2-byte __ldcg loads into one 16-byte shared store a chunk of 8.
template <class T>
__device__ __forceinline__ void load_x(bf16* s, const bf16* p, long long ld,
                                       int rows, int cols, int k0, int pcol0,
                                       bool vec) {
  if (vec) {
    bgemm::load_tile<T::BK, T::PN, T::THREADS, T::LDB>(s, p, ld, rows, cols,
                                                       k0, pcol0, true);
    return;
  }
  constexpr int CH = T::PN / 8;
  constexpr int N = T::BK * CH;
#pragma unroll
  for (int it = 0; it < (N + T::THREADS - 1) / T::THREADS; ++it) {
    const int t = threadIdx.x + it * T::THREADS;
    if (N % T::THREADS != 0 && t >= N) break;
    const int i = t / CH, jc = (t % CH) * 8;
    const int gi = k0 + i, gj = pcol0 + jc;
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(p + gi * ld + gj);
    unsigned v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = gi < rows && gj + e < cols ? __ldcg(src + e) : 0u;
    *reinterpret_cast<uint4*>(s + i * T::LDB + jc) =
        make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                   v[6] | v[7] << 16);
  }
}

// The substitution's producer: the PM x BK window of a (A's block row or
// an inverse, read-only here) at (prow0, k0) through the mainloop's
// load_tile, and the BK x PN window of X at (k0, pcol0) through load_x.
template <class T>
struct XProducer {
  const bf16* A;
  const bf16* X;
  long long lda, ldx;
  int m, n, k, prow0, pcol0;
  bool vec;
  __device__ void load(bf16* As, bf16* Bs, int k0) const {
    bgemm::load_tile<T::PM, T::BK, T::THREADS, T::LDA>(As, A, lda, m, k,
                                                       prow0, k0, vec);
    load_x<T>(Bs, X, ldx, k, n, k0, pcol0, vec);
  }
  __device__ bool transposed(int) const { return false; }
};

struct Args {
  const bf16* A;
  const bf16* B;
  const bf16* inv;  // [batch][ceil(m / BM)][BM][BM], from trsm_inv_bf16
  bf16* X;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sXb, ldx;
  float alpha;
  int vec;
};

// One pass of a step: the PM x PN accumulators at (prow0, pcol0) of a @ x
// (a r x k, x k x n, both row-major) over the contraction [0, kend), stored
// into out (leading stride ldo) as R = bf16(float(bf16(alpha c)) -
// float(bf16(acc))) when c is given (step 0) and as bf16(acc) when not
// (step 1).  Not inlined, as trsm.cu's: the block-row loop stays small
// around one call.
template <class T>
__device__ __noinline__ void pass(bf16* smem, const bf16* a, const bf16* x,
                                  long long lda, long long ldx, int r, int n,
                                  int k, int kend, int prow0, int pcol0,
                                  bool vec, bf16* out, long long ldo,
                                  const bf16* c, long long ldc, float alpha) {
  const XProducer<T> prod{a, x, lda, ldx, r, n, k, prow0, pcol0, vec};
  float acc[T::MT][T::NT][4];
  bgemm::mainloop<T>(smem, prod, 0, kend, bgemm::live_tiles<T>(prow0, r),
                     acc);
  if (c)
    bgemm::for_each_acc<T>(acc, prow0, pcol0, r, n,
                           [&](int row, int col, float v) {
                             const float s = __bfloat162float(
                                 __float2bfloat16_rn(__fmul_rn(
                                     alpha,
                                     __bfloat162float(c[row * ldc + col]))));
                             const float u =
                                 __bfloat162float(__float2bfloat16_rn(v));
                             out[row * ldo + col] =
                                 __float2bfloat16_rn(__fsub_rn(s, u));
                           });
  else
    bgemm::for_each_acc<T>(acc, prow0, pcol0, r, n,
                           [&](int row, int col, float v) {
                             out[row * ldo + col] = __float2bfloat16_rn(v);
                           });
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS, 1)
trsm_bf16_kernel(const Args p) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* smem = reinterpret_cast<bf16*>(smem_bytes);
  const int col0 = blockIdx.x * BN;
  const int nb = (p.m + BM - 1) / BM;
  const long long z = blockIdx.z;
  const bf16* A = p.A + z * p.sAb;
  const bf16* B = p.B + z * p.sBb;
  const bf16* inv = p.inv + z * nb * (long long)(BM * BM);
  bf16* X = p.X + z * p.sXb;
#pragma unroll 1
  for (int i = 0; i < nb; ++i) {
    const int lo = i * BM, r = min(BM, p.m - lo);
    bf16* Xi = X + lo * p.ldx;
    // step 0: R_i = alpha B_i - A[i, :lo] @ X[:lo] into Xi (an empty
    // contraction at block row 0); step 1: X_i = D_i^-1 @ R_i into Xi
#pragma unroll 1
    for (int step = 0; step < 2; ++step) {
      const bf16* a = step ? inv + i * (long long)(BM * BM) : A + lo * p.lda;
      const bf16* x = step ? Xi : X;
      const long long lda = step ? BM : p.lda;
      const bf16* c = step ? nullptr : B + lo * p.ldb;
#pragma unroll 1
      for (int pm = T::PASSES_M - 1; pm >= 0; --pm) {
#pragma unroll 1
        for (int pn = 0; pn < T::PASSES_N; ++pn) {
          const int prow0 = pm * T::PM, pcol0 = col0 + pn * T::PN;
          if (prow0 >= r || pcol0 >= p.n) continue;  // uniform in the block
          // D_i^-1 is zero past each row's diagonal: step 1's pass of rows
          // stops at its last row
          const int kend = step ? sgemm::cmin(prow0 + T::PM, r) : lo;
          pass<T>(smem, a, x, lda, p.ldx, r, p.n, step ? r : lo, kend, prow0,
                  pcol0, p.vec, Xi, p.ldx, c, p.ldb, p.alpha);
        }
      }
      // R_i stored before step 1 copies it, X_i before the next block row
      // copies X[:lo]
      __syncthreads();
    }
  }
}

// The launch parameters of a tile: the substitution's threads, stages,
// dynamic shared bytes, passes and warp grid (m, n), the inverse kernel's
// threads and dynamic shared bytes, and the workspace bytes of one
// diagonal block (kernels/trsm.py::trsm_params with dtype=torch.bfloat16
// mirrors them).
template <int BM, int BN>
void config(int* out) {
  using T = Tile<BM, BN>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
  out[4] = T::WARPS_M;
  out[5] = T::WARPS_N;
  out[6] = kInvCols;
  out[7] = Inv<BM>::SMEM;
  out[8] = 2 * BM * BM;
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

template <int BM, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  using T = Tile<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      trsm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, 1, p.batch);
  set_grid(launched, grid);
  trsm_bf16_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p);
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
// Returns and reports as repro_trsm_inv_bf16.  vec says that A, B, X,
// their leading strides and batch strides are 16-byte aligned.
extern "C" int repro_trsm_bf16(int bm, int bn, const void* a, const void* b,
                               const void* inv, void* x, int m, int n,
                               int batch, long long sAb, long long lda,
                               long long sBb, long long ldb, long long sXb,
                               long long ldx, float alpha, int vec,
                               void* stream, void* ev_start, void* ev_end,
                               int* launched) {
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
               static_cast<const bf16*>(inv), static_cast<bf16*>(x),
               m, n, batch, sAb, lda, sBb, ldb, sXb, ldx, alpha, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_TRSM_BF16_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, s, launched));
  REPRO_TRSM_BF16_TILES(REPRO_TRSM_BF16_LAUNCH)
#undef REPRO_TRSM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernels of a tile were built with, to
// out[0..8] (config above).
extern "C" int repro_trsm_bf16_config(int bm, int bn, int* out) {
#define REPRO_TRSM_BF16_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return config<BM, BN>(out), 0;
  REPRO_TRSM_BF16_TILES(REPRO_TRSM_BF16_CONFIG)
#undef REPRO_TRSM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}
