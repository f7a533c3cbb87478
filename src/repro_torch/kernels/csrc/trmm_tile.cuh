// What trmm.cu (variants full and tri) and trmm_packed.cu (variant
// tri_packed) share: the producer that feeds tril(A) and B to the f32
// mainloop (sgemm_mainloop.cuh), and the tile that runs it.  Every variant
// computes and stores its output tiles with this code and the same
// contraction ends, so tri_packed equals tri bit for bit.
//
// Producer.  Row r of tril(A) is stored in its columns 0 .. r, a prefix of
// the row, so the A copy is the GEMM's row-major staging with a per-row
// column limit min(m, r + 1) (load_tile<..., LOWER>): a 16-byte copy of 4
// floats at (r, j) reads clamp(min(m, r + 1) - j, 0, 4) of them and
// zero-fills the rest, a 4-byte copy reads its float only if j < min(m,
// r + 1).  A step wholly below the diagonal is staged as the GEMM stages
// it, one across it (at most PM / 64 + 1 a pass) by the same code under the
// limit, and one wholly above it (full only) is all zero-byte copies.  No
// element above the diagonal is ever read (the reference's _tril_block), so
// whatever A holds there changes no bit.  B is staged as in the GEMM, its
// rows past m and columns past n zero (the reference's mask_cols /
// mask_rows).
//
// Tile.  One call computes the BM x BN tile of O = alpha * tril(A) @ B at
// (row0, col0) as the mainloop's passes of at most 128 x 128.  The
// contraction of a pass of rows prow0 .. prow0 + PM - 1 ends at m under
// full (the reference's uniform pipeline, which multiplies the zero tiles
// past the diagonal) and at min(prow0 + PM, m) under tri, the end of its
// rows' stored columns.  Each output element adds its products in
// increasing k with fmaf from +0 and is stored as __fmul_rn(alpha, acc),
// rounded once as the plain version's alpha * (A @ B); rows past m and
// columns past n are not stored.  The mainloop leaves its ring idle on
// return, so tiles and passes follow each other with no other barrier.

#pragma once

#include <cuda_runtime.h>

#include "sgemm_mainloop.cuh"

namespace trmm {

// the contraction step (core/knobs.py HOPPER_CONTRACTION_STEP)
constexpr int BK = 64;

template <int BM, int BN>
using Tile = sgemm::Tile<BM, BN, BK>;

struct Args {
  const float* A;
  const float* B;
  float* O;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sOb, ldo;
  float alpha;
  int vec;
};

template <class T>
struct TrmmProducer {
  const float* A;
  const float* B;
  long long lda, ldb;
  int m, n, prow0, pcol0;
  bool vec;
  __device__ bool transposed(int) const { return false; }
  __device__ void load(float* As, float* Bs, int k0) const {
    sgemm::load_tile<T::PM, T::BK, T::THREADS, true>(As, A, lda, m, m, prow0,
                                                     k0, vec);
    sgemm::load_tile<T::BK, T::PN, T::THREADS>(Bs, B, ldb, m, n, k0, pcol0,
                                               vec);
  }
};

// The tile at (row0, col0) of one batch item (A, B, O already offset).
template <class T>
__device__ __forceinline__ void tile(const Args& p, const float* A,
                                     const float* B, float* O, int row0,
                                     int col0, bool tri, float* smem) {
#pragma unroll 1
  for (int pm = 0; pm < T::PASSES_M; ++pm) {
#pragma unroll 1
    for (int pn = 0; pn < T::PASSES_N; ++pn) {
      const int prow0 = row0 + pm * T::PM, pcol0 = col0 + pn * T::PN;
      if (prow0 >= p.m || pcol0 >= p.n) continue;  // uniform in the block
      const TrmmProducer<T> prod{A, B, p.lda, p.ldb, p.m, p.n,
                                 prow0, pcol0, bool(p.vec)};
      const int kend = tri ? sgemm::cmin(prow0 + T::PM, p.m) : p.m;
      float acc[T::TM][T::TN];
      sgemm::mainloop<T>(smem, prod, 0, kend,
                         sgemm::live_rows<T>(prow0, p.m), acc);
      sgemm::for_each_acc<T>(acc, prow0, pcol0, p.m, p.n,
                             [&](int r, int c, float v) {
                               O[r * p.ldo + c] = __fmul_rn(p.alpha, v);
                             });
    }
  }
}

// The launch parameters of a tile: threads, stages, dynamic shared bytes
// and passes (kernels/gemm.py::mainloop_params(bm, 64, bn) mirrors them).
template <int BM, int BN>
void config(int* out) {
  using T = Tile<BM, BN>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
}

}  // namespace trmm

// the output tiles of the Hopper trmm knob space, instantiated by both
// kernels
#define REPRO_TRMM_TILES(X)                                          \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)
