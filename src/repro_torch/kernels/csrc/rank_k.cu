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
// loop itself on the f32 mainloop the GEMM, symm and trmm run
// (sgemm_mainloop.cuh: a cp.async ring of 2-4 stages, 16-byte copies when
// the operands and their strides are 16-byte aligned, one barrier a step,
// 16-byte shared loads, 128-256 threads of 4 x 8 or 8 x 8 accumulators),
// fed by the rank-k producer of rank_k_tile.cuh, whose B side is staged as
// rows.  Grid x walks j, grid y walks i, grid z the batch.  syr2k is the
// runtime flag two (one contraction of twice the steps, rank_k_tile.cuh),
// so one instantiation per tile serves both subroutines.
//
// Variants (runtime flag tri), as in the reference:
//   full: every tile is computed, both triangles, and C is added as given;
//   tri:  the whole nb x nb grid is launched, but the tiles above the
//         diagonal (j > i) return at once; a tile (i, j <= i) is stored at
//         (i, j) and transposed at (j, i) in one epilogue, a diagonal tile
//         taking its upper triangle from its lower one, so the output is
//         the symmetric matrix with no pass after the launch; C is read as
//         lower-stored.  The same tile and epilogue as rank_k_packed.cu, so
//         the two variants give the same bits.
// C is read only when the caller passes has_c (beta != 0 and a C given).
//
// Bound on an H100 SXM (rank_k_tile.cuh): n^2 k operations (syrk, one
// triangle; syr2k twice) at 67 TFLOP/s, so the big calls are bound by the
// operations; full does twice the BLAS count, tri the BLAS count plus the
// diagonal tiles' upper halves and launches nb (nb - 1) / 2 idle blocks.

#include "launch_grid.cuh"
#include "rank_k_tile.cuh"

namespace {

using rank_k::Args;

template <int BM, int BK>
__global__ void __launch_bounds__(rank_k::Tile<BM, BK>::THREADS)
rank_k_kernel(const Args p, int tri) {
  using T = rank_k::Tile<BM, BK>;
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (tri && tj > ti) return;  // tri: no arithmetic above the diagonal
  extern __shared__ __align__(16) float smem[];
  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sAb;
  const float* B = p.two ? p.B + z * p.sBb : nullptr;
  const float* C = p.has_c ? p.C + z * p.sCb : nullptr;
  float* O = p.O + z * p.sOb;
  // the variant's epilogue compiled in: tri runs the code tri_packed runs
  if (tri)
    rank_k::tile<T, true>(p, A, B, C, O, ti * BM, tj * BM, smem);
  else
    rank_k::tile<T, false>(p, A, B, C, O, ti * BM, tj * BM, smem);
}

template <int BM, int BK>
cudaError_t launch(const Args& p, int batch, int tri, cudaStream_t stream,
                   int* launched) {
  using T = rank_k::Tile<BM, BK>;
  if (T::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_k_kernel<BM, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (e != cudaSuccess) return e;
  }
  const int nb = (p.n + BM - 1) / BM;
  const dim3 grid(nb, nb, batch);
  set_grid(launched, grid);
  rank_k_kernel<BM, BK><<<grid, T::THREADS, T::SMEM, stream>>>(p, tri);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated (bm, bk) of the Hopper syrk/syr2k
// knob space (bk is the knob's bn).  Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a tile with no instantiation.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned.
extern "C" int repro_rank_k_f32(int bm, int bk, const void* a, const void* b,
                                const void* c, void* o, int n, int k,
                                int batch, long long sAb, long long lda,
                                long long sBb, long long ldb, long long sCb,
                                long long ldc, long long sOb, long long ldo,
                                float alpha, float beta, int two, int tri,
                                int has_c, int vec, void* stream,
                                void* ev_start, void* ev_end,
                                int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               n, k, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, two, has_c, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_RANK_K_LAUNCH(BM, BK) \
  if (bm == BM && bk == BK)           \
    return int(launch<BM, BK>(p, batch, tri, s, launched));
  REPRO_RANK_K_TILES(REPRO_RANK_K_LAUNCH)
#undef REPRO_RANK_K_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes and passes, to out[0..3].
extern "C" int repro_rank_k_f32_config(int bm, int bk, int* out) {
#define REPRO_RANK_K_CONFIG(BM, BK) \
  if (bm == BM && bk == BK) return rank_k::config<BM, BK>(out), 0;
  REPRO_RANK_K_TILES(REPRO_RANK_K_CONFIG)
#undef REPRO_RANK_K_CONFIG
  return int(cudaErrorInvalidValue);
}
