// What trmm_bf16.cu (variants full and tri) and trmm_packed_bf16.cu
// (variant tri_packed) share, the bfloat16 twin of trmm_tile.cuh: the
// producer that feeds tril(A) and B to the bf16 mainloop
// (bf16_mainloop.cuh: a cp.async ring, ldmatrix, mma.sync m16n8k16 with
// float32 accumulators), and the one tile function that runs it.  Every
// variant computes and stores its output tiles with this code and the same
// contraction ends, so tri_packed equals tri bit for bit.
//
// Producer.  Row r of tril(A) is stored in its columns 0 .. r, a prefix of
// the row, so the A copy is the GEMM's row-major staging with a per-row
// column limit min(m, r + 1) (load_tile<..., LOWER>): a 16-byte copy of 8
// elements at (r, j) reads clamp(min(m, r + 1) - j, 0, 8) of them and
// zero-fills the rest, the 2-byte path reads an element only below the
// limit.  A step wholly below the diagonal is staged as the GEMM stages
// it, one across it by the same code under the limit, and one wholly above
// it (full only) is all zero-byte copies.  No element above the diagonal
// is ever read (the reference's _tril_block), so whatever A holds there
// changes no bit.  B is staged as in the GEMM, its rows past m and columns
// past n zero (the reference's mask_cols / mask_rows).
//
// Tile.  One call computes the BM x BN tile of O = alpha * tril(A) @ B at
// (row0, col0) as the mainloop's passes of at most 128 x 128.  The
// contraction of a pass of rows prow0 .. prow0 + PM - 1 ends at m under
// full (the reference's uniform pipeline, which multiplies the zero tiles
// past the diagonal) and at min(prow0 + PM, m) under tri, the end of its
// rows' stored columns.  Each output element is stored as
// bf16(__fmul_rn(alpha, acc)), rounded once to bf16 as the plain
// version's alpha * (tril(A) @ B) in float32 then cast; rows past m and
// columns past n are not stored.  The mainloop leaves its ring idle on
// return, so tiles and passes follow each other with no other barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mainloop.cuh"

namespace btrmm {

using bgemm::bf16;

// the contraction step (core/knobs.py HOPPER_CONTRACTION_STEP)
constexpr int BK = 64;

template <int BM, int BN>
using Tile = bgemm::Tile<BM, BN, BK>;

struct Args {
  const bf16* A;
  const bf16* B;
  bf16* O;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sOb, ldo;
  float alpha;
  int vec;
};

template <class T>
struct TrmmProducer {
  const bf16* A;
  const bf16* B;
  long long lda, ldb;
  int m, n, prow0, pcol0;
  bool vec;
  __device__ bool transposed(int) const { return false; }
  __device__ void load(bf16* As, bf16* Bs, int k0) const {
    bgemm::load_tile<T::PM, T::BK, T::THREADS, T::LDA, true>(
        As, A, lda, m, m, prow0, k0, vec);
    bgemm::load_tile<T::BK, T::PN, T::THREADS, T::LDB>(Bs, B, ldb, m, n, k0,
                                                       pcol0, vec);
  }
};

// The tile at (row0, col0) of one batch item (A, B, O already offset).
template <class T>
__device__ __forceinline__ void tile(const Args& p, const bf16* A,
                                     const bf16* B, bf16* O, int row0,
                                     int col0, bool tri, bf16* smem) {
#pragma unroll 1
  for (int pm = 0; pm < T::PASSES_M; ++pm) {
#pragma unroll 1
    for (int pn = 0; pn < T::PASSES_N; ++pn) {
      const int prow0 = row0 + pm * T::PM, pcol0 = col0 + pn * T::PN;
      if (prow0 >= p.m || pcol0 >= p.n) continue;  // uniform in the block
      const TrmmProducer<T> prod{A, B, p.lda, p.ldb, p.m, p.n,
                                 prow0, pcol0, bool(p.vec)};
      const int kend = tri ? bgemm::cmin(prow0 + T::PM, p.m) : p.m;
      float acc[T::MT][T::NT][4];
      bgemm::mainloop<T>(smem, prod, 0, kend,
                         bgemm::live_tiles<T>(prow0, p.m), acc);
      bgemm::for_each_acc<T>(acc, prow0, pcol0, p.m, p.n,
                             [&](int r, int c, float v) {
                               O[r * p.ldo + c] =
                                   __float2bfloat16_rn(__fmul_rn(p.alpha, v));
                             });
    }
  }
}

// The launch parameters of a tile: threads, stages, dynamic shared bytes,
// passes and the warp grid (m, n) (kernels/gemm.py::mainloop_params(bm,
// 64, bn, torch.bfloat16) mirrors them).
template <int BM, int BN>
void config(int* out) {
  using T = Tile<BM, BN>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
  out[4] = T::WARPS_M;
  out[5] = T::WARPS_N;
}

}  // namespace btrmm

// the output tiles of the Hopper trmm knob space (trmm_tile.cuh's
// REPRO_TRMM_TILES), instantiated by both bf16 kernels
#define REPRO_TRMM_BF16_TILES(X)                                     \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)
