// SYRK / SYR2K for Hopper (sm_90a), variants full and tri:
//   syrk : O = alpha * A @ A^T + beta * C
//   syr2k: O = alpha * (A @ B^T + B @ A^T) + beta * C
// A and B (n, k), C and O (n, n), float32 in and out, float32 accumulator,
// in IEEE arithmetic on the CUDA cores.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/syrk.py::_rank_k_kernel (via _rank_k_call), which the
// TPU runs over a sequential (i, j, l) grid with the sum over l carried in
// VMEM scratch.  Here one block owns the output tile (i, j) and runs the l
// loop itself (rank_k_tile.cuh); grid x walks j, grid y walks i, grid z the
// batch.  syr2k is the runtime flag two, so one instantiation per tile
// serves both subroutines.
//
// Variants (runtime flag tri), as in the reference:
//   full: every tile is computed, both triangles, and C is added as given;
//   tri:  the whole nb x nb grid is launched, but the tiles above the
//         diagonal (j > i) return at once and write nothing; C is read as
//         lower-stored.  The caller then mirrors the lower triangle into the
//         upper one (kernels/syrk.py), as the reference's tril + tril^T
//         post-pass does.
// C is read only when the caller passes has_c (beta != 0 and a C given).
//
// Bound on an H100 SXM: syrk's BLAS count is n^2 k operations (one
// triangle) at 67 TFLOP/s in float32, against 4 (n k + n^2) bytes at
// 3.35 TB/s, so it is bound by the operations once k passes a few dozen.
// full does twice the BLAS count, tri the BLAS count plus the diagonal
// tiles' upper halves.  This first design does nothing yet about the bound
// beyond the register tile: one shared-memory stage, no asynchronous copies.

#include "launch_grid.cuh"
#include "rank_k_tile.cuh"

namespace {

using rank_k::Args;

template <int BM, int BK>
__global__ void __launch_bounds__(BM * BM / 64)
rank_k_kernel(Args p, int tri) {
  constexpr int T = BM / 8;
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (tri && tj > ti) return;  // tri: no arithmetic above the diagonal
  extern __shared__ float smem[];
  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sAb;
  const float* B = p.two ? p.B + z * p.sBb : nullptr;
  const float* C = p.has_c ? p.C + z * p.sCb : nullptr;
  float* O = p.O + z * p.sOb;
  const int row0 = ti * BM, col0 = tj * BM;

  float acc[8][8];
  rank_k::accumulate<BM, BK>(acc, p, A, B, row0, col0, smem);

  const int tx = threadIdx.x % T, ty = threadIdx.x / T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + ty + i * T;
    if (gr >= p.n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + tx + j * T;
      if (gc >= p.n) continue;
      O[gr * p.ldo + gc] = rank_k::value(p, C, acc[i][j], gr, gc, tri);
    }
  }
}

template <int BM, int BK>
cudaError_t launch(const Args& p, int batch, int tri, cudaStream_t stream,
                   int* launched) {
  constexpr int THREADS = BM * BM / 64;
  static_assert(THREADS < 1024, "tiles of 1024 threads spill");
  const int smem = int(sizeof(float)) * rank_k::operand_floats<BM, BK>(p.two);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_k_kernel<BM, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const int nb = (p.n + BM - 1) / BM;
  const dim3 grid(nb, nb, batch);
  set_grid(launched, grid);
  rank_k_kernel<BM, BK><<<grid, THREADS, smem, stream>>>(p, tri);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated (bm, bk) of the Hopper syrk/syr2k
// knob space (bk is the knob's bn).  Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a tile with no instantiation.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.
extern "C" int repro_rank_k_f32(int bm, int bk, const void* a, const void* b,
                                const void* c, void* o, int n, int k,
                                int batch, long long sAb, long long lda,
                                long long sBb, long long ldb, long long sCb,
                                long long ldc, long long sOb, long long ldo,
                                float alpha, float beta, int two, int tri,
                                int has_c, void* stream, int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               n, k, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, two, has_c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RANK_K_TILE(BM, BK) \
  if (bm == BM && bk == BK)                    \
    return int(launch<BM, BK>(p, batch, tri, s, launched));
  REPRO_RANK_K_TILE(64, 16) REPRO_RANK_K_TILE(64, 32) REPRO_RANK_K_TILE(64, 64)
  REPRO_RANK_K_TILE(128, 16) REPRO_RANK_K_TILE(128, 32)
  REPRO_RANK_K_TILE(128, 64)
#undef REPRO_RANK_K_TILE
  return int(cudaErrorInvalidValue);
}
