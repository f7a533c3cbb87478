// The block of a TRMM shared by trmm.cu (variants full and tri) and
// trmm_packed.cu (variant tri_packed): every variant computes and stores an
// output tile with this code, so that tri_packed equals tri bit for bit.
//
// One call computes the BM x BN tile of O = alpha * tril(A) @ B whose rows
// start at row0 and whose columns start at col0, with the contraction over
// l < kend in steps of BK = 64 (core/knobs.py HOPPER_CONTRACTION_STEP, a
// launch parameter).  Each step stages one A tile (transposed, padded by one
// float) and one B tile in shared memory; each of the BM * BN / 64 threads
// keeps an 8 x 8 tile of accumulators in registers and adds the products in
// order of l with fmaf, so every output element is one fixed sequence of
// IEEE operations whatever kernel, grid position or batch item computes it.
//
// A is read only where it is stored: an element (r, c) with c > r counts as
// zero (the reference's _tril_block at element level), as does one past m;
// the loads of such elements are skipped, not only their values.  B's rows
// past m and columns past n read zero (the reference's mask_cols /
// mask_rows), and stores past m or n are dropped.  The epilogue is
// __fmul_rn(alpha, acc), rounded once, as the plain version's alpha * (A@B).

#pragma once

#include <cuda_runtime.h>

namespace trmm {

constexpr int BK = 64;

struct Args {
  const float* A;
  const float* B;
  float* O;
  int m, n;
  long long sAb, lda, sBb, ldb, sOb, ldo;
  float alpha;
};

// bytes of shared memory for the staged tiles
template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return int(sizeof(float)) * BK * (BM + 1 + BN);
}

template <int BM, int BN>
__device__ __forceinline__ void tile(const Args& p,
                                     const float* __restrict__ A,
                                     const float* __restrict__ B,
                                     float* __restrict__ O, int row0,
                                     int col0, int kend, float* smem) {
  constexpr int TX = BN / 8;
  constexpr int TY = BM / 8;
  constexpr int THREADS = TX * TY;
  constexpr int LDS_A = BM + 1;
  float* As = smem;               // [BK][BM + 1]: the tril(A) tile, transposed
  float* Bs = smem + BK * LDS_A;  // [BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    // neighbouring threads on neighbouring columns of a row of A
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk * LDS_A + r] = (gr < p.m && gk <= gr) ? A[gr * p.lda + gk] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk * BN + c] = (gk < p.m && gc < p.n) ? B[gk * p.ldb + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk * LDS_A + ty + i * TY];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk * BN + tx + j * TX];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the next step, or the next tile of a packed block, reuses smem
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < p.n) O[r * p.ldo + c] = __fmul_rn(p.alpha, acc[i][j]);
    }
  }
}

// the end of a row block's contraction: A's row block row0.. holds no
// stored element past column row0 + BM - 1
template <int BM>
__device__ __forceinline__ int tri_end(int row0, int m) {
  return row0 + BM < m ? row0 + BM : m;
}

}  // namespace trmm
