// The block of a rank-k update shared by rank_k.cu (variants full and tri)
// and rank_k_packed.cu (variant tri_packed): both kernels accumulate an
// output tile and form its values with this code, so that tri_packed equals
// tri bit for bit.
//
// One block owns the BM x BM output tile whose rows are rows row0.. of A
// (the tile row i) and whose columns are rows col0.. of A (the tile column
// j):  acc[r][c] = sum over l of A[row0+r, l] * A[col0+c, l]  (syrk), or of
// A[row0+r, l] * B[col0+c, l] + B[row0+r, l] * A[col0+c, l]  (syr2k, under
// the runtime flag two).  The contraction runs inside the block in steps of
// BK, the knob's bn.  Each step stages the BK columns of the row tiles,
// transposed and padded by one float, in shared memory; each of the
// BM * BM / 64 threads keeps an 8 x 8 tile of accumulators in registers and
// adds the products in order of l with fmaf, so every element is one fixed
// sequence of IEEE operations whatever kernel, grid or batch item runs it.
// Loads past n or k read zero (the reference's mask_cols).

#pragma once

#include <cuda_runtime.h>

namespace rank_k {

struct Args {
  const float* A;
  const float* B;
  const float* C;
  float* O;
  int n, k;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int two, has_c;
};

// floats of shared memory for the staged operand tiles
template <int BM, int BK>
__host__ __device__ constexpr int operand_floats(bool two) {
  return (two ? 4 : 2) * BK * (BM + 1);
}

template <int BM, int BK>
__device__ __forceinline__ void accumulate(float (&acc)[8][8], const Args& p,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           int row0, int col0, float* smem) {
  constexpr int T = BM / 8;
  constexpr int THREADS = T * T;
  constexpr int LDS = BM + 1;
  float* Ai = smem;             // [BK][BM + 1] each: rows of tile i, j
  float* Aj = smem + BK * LDS;
  float* Bi = smem + 2 * BK * LDS;
  float* Bj = smem + 3 * BK * LDS;
  const int tid = threadIdx.x;
  const int tx = tid % T;
  const int ty = tid / T;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int gk = k0 + kk, gi = row0 + r, gj = col0 + r;
      const bool in_i = gk < p.k && gi < p.n, in_j = gk < p.k && gj < p.n;
      Ai[kk * LDS + r] = in_i ? A[gi * p.lda + gk] : 0.f;
      Aj[kk * LDS + r] = in_j ? A[gj * p.lda + gk] : 0.f;
      if (p.two) {
        Bi[kk * LDS + r] = in_i ? B[gi * p.ldb + gk] : 0.f;
        Bj[kk * LDS + r] = in_j ? B[gj * p.ldb + gk] : 0.f;
      }
    }
    __syncthreads();
    if (p.two) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float ai[8], bi[8], aj[8], bj[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ai[i] = Ai[kk * LDS + ty + i * T];
          bi[i] = Bi[kk * LDS + ty + i * T];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          aj[j] = Aj[kk * LDS + tx + j * T];
          bj[j] = Bj[kk * LDS + tx + j * T];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
            acc[i][j] = fmaf(bi[i], aj[j], acc[i][j]);
          }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float ai[8], aj[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) ai[i] = Ai[kk * LDS + ty + i * T];
#pragma unroll
        for (int j = 0; j < 8; ++j) aj[j] = Aj[kk * LDS + tx + j * T];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(ai[i], aj[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

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

}  // namespace rank_k
