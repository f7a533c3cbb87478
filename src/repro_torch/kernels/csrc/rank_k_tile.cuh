// What rank_k.cu (variants full and tri) and rank_k_packed.cu (variant
// tri_packed) share: the producer that feeds a rank-k tile to the f32
// mainloop (sgemm_mainloop.cuh), the tile that runs it and the one epilogue
// both kernels store with, so that tri_packed equals tri bit for bit.
//
// One block owns the BM x BM output tile whose rows are rows row0.. of A
// (the tile row i) and whose columns are rows col0.. of A (the tile column
// j):  acc[r][c] = sum over l of A[row0+r, l] * A[col0+c, l]  (syrk), or of
// A[row0+r, l] * B[col0+c, l] + B[row0+r, l] * A[col0+c, l]  (syr2k, under
// the runtime flag two).  The contraction runs inside the block in steps of
// BK, the knob's bn.
//
// Layout.  The tile is sgemm::Tile<BM, BM, BK> (128 threads of 4 x 8
// accumulators at BM = 64, 256 of 8 x 8 at BM = 128) with its B side
// staged as rows: both operands are rows of a row-major (n, k) matrix, so
// both have the contraction index innermost.  The A side (rows row0..) is
// staged [BM][BK] by the GEMM's cp.async copies; the B side (rows col0..)
// is staged [BM][BK + 4] by the same copies with a padded row stride, and
// fma_nt reads both as 16-byte loads along k, the A side broadcast within a
// quarter warp, the B side in 32 distinct banks.  16-byte copies when A, B
// and their strides are 16-byte aligned (the wrapper's vec flag), else
// 4-byte copies of the same values; loads past n or k zero-fill (the
// reference's mask_cols).
//
// syr2k runs as one contraction of length 2 kb, kb = ceil(k / BK) * BK:
// steps in [0, kb) stage (A rows i, B rows j), steps in [kb, 2 kb) stage
// (B rows i, A rows j), on the same stage buffers as syrk.  So each element
// adds, with fmaf from +0, all a_i[l] * b_j[l] in increasing l and then all
// b_i[l] * a_j[l] in increasing l; the half boundary sits on a step
// boundary, so a k padded with zeros adds only zero products at the end of
// each half and changes no bit (masked == padded).
//
// Epilogue (store).  The mainloop leaves its ring idle on return, so the
// tile's values, alpha * acc + beta * C (value()), are parked there,
// [BM][BM + 1], and stored row by row, coalesced; under tri and tri_packed
// the parked tile is then stored transposed to (j, i), neighbouring threads
// on neighbouring rows of the tile, coalesced too.  A diagonal tile takes
// its upper triangle from its own lower one, so the output is symmetric bit
// for bit.
//
// Bound on an H100 SXM: syrk's BLAS count is n^2 k operations (one
// triangle) at 67 TFLOP/s in float32, against 4 (n k + n^2) bytes at
// 3.35 TB/s, so it is bound by the operations once k passes a few dozen:
// the mainloop keeps the FMAs fed.  tri and tri_packed do the BLAS count
// plus the diagonal tiles' upper halves, full twice the BLAS count.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "sgemm_mainloop.cuh"

namespace rank_k {

// the row r of the lower triangle's row-major index t: r (r + 1) / 2 <= t
// < (r + 1) (r + 2) / 2 (a float sqrt seed, then an exact integer fix-up);
// both packed kernels, float32 and bf16, map their blocks by it
__host__ __device__ inline int tri_row(long long t) {
  int r = int((sqrtf(8.f * float(t) + 1.f) - 1.f) * 0.5f);
  while (static_cast<long long>(r) * (r + 1) / 2 > t) --r;
  while (static_cast<long long>(r + 1) * (r + 2) / 2 <= t) ++r;
  return r;
}

struct Args {
  const float* A;
  const float* B;
  const float* C;
  float* O;
  int n, k;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int two, has_c, vec;
};

// The mainloop's tile with the B side staged as rows [BM][BK + 4]: the
// launch parameters (kernels/syrk.py::rank_k_params mirrors them).
template <int BM_, int BK_>
struct Tile : sgemm::Tile<BM_, BM_, BK_> {
  static constexpr bool B_ROWS = true;
  static constexpr int LDB = BK_ + 4;
  static constexpr int STAGE_FLOATS = BM_ * BK_ + BM_ * LDB;
  static constexpr int STAGE_BYTES = 4 * STAGE_FLOATS;
  static constexpr int STAGES = sgemm::ring_stages(STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  // the parked output tile of the epilogue, in the idle ring
  static constexpr int PARK_LD = BM_ + 1;
  static_assert(sgemm::Tile<BM_, BM_, BK_>::kOnePass, "one pass a tile");
  static_assert(SMEM <= sgemm::kSmemMax, "227 KB of shared memory");
  static_assert(4 * BM_ * PARK_LD <= SMEM, "the parked tile fits the ring");
};

template <class T>
struct Producer {
  const float* A;
  const float* B;  // A itself for syrk
  long long lda, ldb;
  int n, k, kb, row0, col0;
  bool vec;
  __device__ void load(float* As, float* Bs, int k0) const {
    // syr2k's second half: B's rows i against A's rows j
    const bool second = k0 >= kb;
    const float* I = second ? B : A;
    const float* J = second ? A : B;
    const int kk = second ? k0 - kb : k0;
    sgemm::load_tile<T::PM, T::BK, T::THREADS>(
        As, I, second ? ldb : lda, n, k, row0, kk, vec);
    sgemm::load_tile<T::PN, T::BK, T::THREADS, false, T::LDB>(
        Bs, J, second ? lda : ldb, n, k, col0, kk, vec);
  }
};

// The output value at (gr, gc) inside the matrix: alpha * acc + beta * C.
// With lower_c (variants tri and tri_packed) C is read as lower-stored: its
// strict upper triangle counts as zero, as the reference's in-kernel tril.
// The variant full adds C as given, both triangles.
__device__ __forceinline__ float value(const Args& p,
                                       const float* __restrict__ C, float acc,
                                       int gr, int gc, bool lower_c) {
  float v = __fmul_rn(p.alpha, acc);
  if (p.has_c && (!lower_c || gr >= gc))
    v = __fmaf_rn(p.beta, C[gr * p.ldc + gc], v);
  return v;
}

// Parks the tile's values in the idle ring and stores them at (row0, col0)
// and, under MIRROR (tri, tri_packed), transposed at (col0, row0); C is
// then read as lower-stored.
template <class T, bool MIRROR>
__device__ __forceinline__ void store(const Args& p, const float* C,
                                      float* O,
                                      const float (&acc)[T::TM][T::TN],
                                      int row0, int col0, float* smem) {
  constexpr int BM = T::BM, LD = T::PARK_LD;
  const int ty = threadIdx.x / T::TX, tx = threadIdx.x % T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = ty * T::TM + i, gr = row0 + r;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int c = tx + j * T::TX, gc = col0 + c;
      if (gr < p.n && gc < p.n)
        smem[r * LD + c] = value(p, C, acc[i][j], gr, gc, MIRROR);
    }
  }
  __syncthreads();
  const bool diag = MIRROR && row0 == col0;
  for (int idx = threadIdx.x; idx < BM * BM; idx += T::THREADS) {
    const int r = idx / BM, c = idx % BM;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < p.n && gc < p.n)
      O[gr * p.ldo + gc] = (diag && r < c) ? smem[c * LD + r]
                                           : smem[r * LD + c];
  }
  if (MIRROR && !diag) {
    // O[col0 + c, row0 + r] = tile[r][c], neighbouring threads on
    // neighbouring r
    for (int idx = threadIdx.x; idx < BM * BM; idx += T::THREADS) {
      const int c = idx / BM, r = idx % BM;
      const int gr = row0 + r, gc = col0 + c;
      if (gr < p.n && gc < p.n) O[gc * p.ldo + gr] = smem[r * LD + c];
    }
  }
}

// The tile (i, j) of one batch item (A, B, C, O already offset; B and C
// unused unless two and has_c): the mainloop over syrk's kb or syr2k's
// 2 kb contraction steps, then the epilogue (MIRROR: tri, tri_packed).
template <class T, bool MIRROR>
__device__ __forceinline__ void tile(const Args& p, const float* A,
                                     const float* B, const float* C,
                                     float* O, int row0, int col0,
                                     float* smem) {
  const int kb = (p.k + T::BK - 1) / T::BK * T::BK;
  const Producer<T> prod{A, p.two ? B : A, p.lda, p.two ? p.ldb : p.lda,
                         p.n, p.k, kb, row0, col0, bool(p.vec)};
  float acc[T::TM][T::TN];
  sgemm::mainloop<T>(smem, prod, 0, p.two ? 2 * kb : kb,
                     sgemm::live_rows<T>(row0, p.n), acc);
  store<T, MIRROR>(p, C, O, acc, row0, col0, smem);
}

// The launch parameters of a tile: threads, stages, dynamic shared bytes
// and passes (kernels/syrk.py::rank_k_params(bm, bk) mirrors them).
template <int BM, int BK>
void config(int* out) {
  using T = Tile<BM, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
}

}  // namespace rank_k

// the (bm, bk) tiles of the Hopper syrk/syr2k knob space (bk is the knob's
// bn), instantiated by both kernels
#define REPRO_RANK_K_TILES(X) \
  X(64, 16) X(64, 32) X(64, 64) X(128, 16) X(128, 32) X(128, 64)
