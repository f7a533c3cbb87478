// What rank_k_bf16.cu (variants full and tri) and rank_k_packed_bf16.cu
// (variant tri_packed) share, the bfloat16 twin of rank_k_tile.cuh: the
// producer that feeds a rank-k tile to the bf16 mainloop (bf16_mainloop.cuh:
// a cp.async ring, ldmatrix, mma.sync m16n8k16 with float32 accumulators),
// the one tile function both kernels run and the epilogue it stores with,
// so that tri_packed equals tri bit for bit.
//
// One block owns the BM x BM output tile whose rows are rows row0.. of A
// (the tile row i) and whose columns are rows col0.. of A (the tile column
// j):  acc[r][c] = sum over l of A[row0+r, l] * A[col0+c, l]  (syrk), or of
// A[row0+r, l] * B[col0+c, l] + B[row0+r, l] * A[col0+c, l]  (syr2k, under
// the runtime flag two), every product and sum float32 in the tensor cores.
// The contraction runs inside the block in steps of BK, the knob's bn.
//
// Layout.  The tile is bgemm::Tile<BM, BM, BK> (4 warps of 32 x 32 at
// BM = 64, 8 warps of 64 x 32 at BM = 128, one pass) with its B side
// staged as rows (B_ROWS): both sides are rows of a row-major (n, k)
// matrix, so both have the contraction index innermost.  The A side (rows
// row0..) is staged [BM][BK + 8] as the GEMM stages A and read by
// ldmatrix.x4; the B side (rows col0..) is staged [BM][BK + 8] by the same
// copies and read by ldmatrix.x4 without .trans, which hands mma its
// k-major B fragments as they lie.  Rows of BK + 8 elements are 48, 80 or
// 144 bytes apart, so the eight rows of an ldmatrix phase fall in distinct
// banks.  16-byte cp.async copies when A, B and their strides are 16-byte
// aligned (the wrapper's vec flag), else 2-byte loads of the same values;
// loads past n or k zero-fill (the reference's mask_cols).
//
// syr2k runs as one contraction of length 2 kb, kb = ceil(k / BK) * BK:
// steps in [0, kb) stage (A rows i, B rows j), steps in [kb, 2 kb) stage
// (B rows i, A rows j), on the same stage buffers as syrk, as
// rank_k_tile.cuh does.  The half boundary sits on a step boundary, so a k
// padded with zeros adds only zero products at the end of each half and
// changes no bit (masked == padded).
//
// Epilogue.  value() computes alpha * acc + beta * C in float32 (C read
// only when has_c and, under tri and tri_packed, only on and below the
// diagonal: C is lower-stored there) and rounds it to bf16 once.  The
// mainloop leaves its ring idle on return, so the rounded tile is parked
// there, [BM][BM + 2] (an odd number of 4-byte words a row: the transposed
// reads of neighbouring rows hit distinct banks), and stored row by row,
// coalesced; under MIRROR (tri, tri_packed) the parked tile is then stored
// transposed to (j, i), neighbouring threads on neighbouring rows of the
// tile.  A diagonal tile takes its upper triangle from its own lower one.
// Rounding is elementwise, so "round once, then mirror the rounded lower
// triangle" is the reference's cast after tril(out) + tril(out, -1)^T, and
// the output is symmetric bit for bit.
//
// Bound on an H100 SXM: syrk's BLAS count is n^2 k operations (one
// triangle; syr2k twice) at 989 TFLOP/s of dense bf16, against
// 2 (n k + n^2) bytes at 3.35 TB/s, so a call past k of a few hundred is
// bound by the operations.  full does twice the BLAS count, tri and
// tri_packed the BLAS count plus the diagonal tiles' upper halves.
// mma.sync reaches only a part of the tensor cores' rate; wgmma and TMA are
// later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mainloop.cuh"
#include "rank_k_tile.cuh"  // REPRO_RANK_K_TILES, the tiles of both dtypes

namespace brank_k {

using bgemm::bf16;

struct Args {
  const bf16* A;
  const bf16* B;
  const bf16* C;
  bf16* O;
  int n, k;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int two, has_c, vec;
};

// The bf16 mainloop's BM x BM tile with the B side staged as rows
// [BM][BK + 8], and the parked output tile of the epilogue: the launch
// parameters (kernels/syrk.py::rank_k_params(bm, bk, torch.bfloat16)
// mirrors them).
template <int BM_, int BK_>
struct Tile : bgemm::Tile<BM_, BM_, BK_> {
  using Base = bgemm::Tile<BM_, BM_, BK_>;
  static constexpr bool B_ROWS = true;
  static constexpr int LDB = BK_ + bgemm::kPad;
  static constexpr int A_ELEMS = Base::PM * Base::LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + Base::PN * LDB;
  static constexpr int STAGE_BYTES = 2 * STAGE_ELEMS;
  static constexpr int STAGES = sgemm::ring_stages(STAGE_BYTES);
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int PARK_LD = BM_ + 2;
  static constexpr int PARK = 2 * BM_ * PARK_LD;
  static constexpr int SMEM = RING > PARK ? RING : PARK;
  static_assert(Base::kOnePass, "one pass a tile");
  static_assert(A_ELEMS % 8 == 0 && STAGE_BYTES % 16 == 0,
                "16-byte aligned B tiles and stages");
  static_assert(PARK <= SMEM && SMEM <= sgemm::kSmemMax,
                "the ring and the parked tile in 227 KB");
};

template <class T>
struct Producer {
  const bf16* A;
  const bf16* B;  // A itself for syrk
  long long lda, ldb;
  int n, k, kb, row0, col0;
  bool vec;
  __device__ bool transposed(int) const { return false; }
  __device__ void load(bf16* As, bf16* Bs, int k0) const {
    // syr2k's second half: B's rows i against A's rows j
    const bool second = k0 >= kb;
    const bf16* I = second ? B : A;
    const bf16* J = second ? A : B;
    const int kk = second ? k0 - kb : k0;
    bgemm::load_tile<T::PM, T::BK, T::THREADS, T::LDA>(
        As, I, second ? ldb : lda, n, k, row0, kk, vec);
    bgemm::load_tile<T::PN, T::BK, T::THREADS, T::LDB>(
        Bs, J, second ? lda : ldb, n, k, col0, kk, vec);
  }
};

// The output value at (gr, gc) inside the matrix, alpha * acc + beta * C in
// float32, rounded to bf16 once.  With lower_c (variants tri and
// tri_packed) C is read as lower-stored: its strict upper triangle counts
// as zero and is never read.  The variant full adds C as given.
__device__ __forceinline__ bf16 value(const Args& p,
                                      const bf16* __restrict__ C, float acc,
                                      int gr, int gc, bool lower_c) {
  float v = __fmul_rn(p.alpha, acc);
  if (p.has_c && (!lower_c || gr >= gc))
    v = __fmaf_rn(p.beta, __bfloat162float(C[gr * p.ldc + gc]), v);
  return __float2bfloat16_rn(v);
}

// Parks the tile's rounded values in the idle ring and stores them at
// (row0, col0) and, under MIRROR (tri, tri_packed), transposed at
// (col0, row0); C is then read as lower-stored.
template <class T, bool MIRROR>
__device__ __forceinline__ void store(const Args& p, const bf16* C, bf16* O,
                                      const float (&acc)[T::MT][T::NT][4],
                                      int row0, int col0, bf16* smem) {
  constexpr int BM = T::BM, LD = T::PARK_LD;
  bgemm::for_each_acc<T>(acc, row0, col0, p.n, p.n,
                         [&](int gr, int gc, float v) {
                           smem[(gr - row0) * LD + gc - col0] =
                               value(p, C, v, gr, gc, MIRROR);
                         });
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
__device__ __forceinline__ void tile(const Args& p, const bf16* A,
                                     const bf16* B, const bf16* C, bf16* O,
                                     int row0, int col0, bf16* smem) {
  const int kb = (p.k + T::BK - 1) / T::BK * T::BK;
  const Producer<T> prod{A, p.two ? B : A, p.lda, p.two ? p.ldb : p.lda,
                         p.n, p.k, kb, row0, col0, bool(p.vec)};
  float acc[T::MT][T::NT][4];
  bgemm::mainloop<T>(smem, prod, 0, p.two ? 2 * kb : kb,
                     bgemm::live_tiles<T>(row0, p.n), acc);
  store<T, MIRROR>(p, C, O, acc, row0, col0, smem);
}

// The launch parameters of a tile: threads, stages, dynamic shared bytes,
// passes and the warp grid (m, n) (kernels/syrk.py::rank_k_params(bm, bk,
// torch.bfloat16) mirrors them).
template <int BM, int BK>
void config(int* out) {
  using T = Tile<BM, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
  out[4] = T::WARPS_M;
  out[5] = T::WARPS_N;
}

}  // namespace brank_k
