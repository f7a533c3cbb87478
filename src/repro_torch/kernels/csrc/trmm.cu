// TRMM for Hopper (sm_90a), variants full and tri: O = alpha * tril(A) @ B
// (left, lower, non-unit), A (m, m), B and O (m, n), float32 in and out,
// float32 accumulator, in IEEE arithmetic on the CUDA cores.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/trmm.py::_trmm_kernel (via trmm_pallas), which walks a
// sequential (i, j, l) grid with the sum over l carried in VMEM scratch and
// the diagonal tile masked by _tril_block.  Here one block owns the output
// tile (i, j) and runs the l loop itself on the f32 mainloop the GEMM and
// symm run (sgemm_mainloop.cuh: a cp.async ring of 2-4 stages, 16-byte
// copies when A, B and their strides are 16-byte aligned, 16-byte shared
// loads, 128-256 threads of 4 x 8 or 8 x 8 accumulators, tiles above
// 128 x 128 as passes), fed by the lower-triangle producer of
// trmm_tile.cuh.  Grid x walks the n-tiles, grid y the m-tiles from the
// last up, grid z the batch.
//
// Variants (runtime flag tri), as in the reference:
//   full: every pass walks the whole contraction, l < m, and multiplies the
//         zero-filled A tiles past the diagonal (without reading A there):
//         the reference's uniform pipeline, about twice tri's FMAs;
//   tri:  the pass of rows prow0 .. prow0 + PM - 1 stops at min(prow0 + PM,
//         m), the end of its rows' stored columns, so it does no arithmetic
//         past the diagonal.  Block row i does i + 1 steps, so the grid
//         starts with the last block row and ends with the lightest (2-6 %
//         faster than top first at (4096, 4096) @ (4096, 14336) on an
//         H100, scripts/trmm_row_order.py; the same bits).
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 67 TFLOP/s
// against 4 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so a TRMM past m of a few
// dozen is bound by the operations: the mainloop keeps the FMAs fed.

#include "launch_grid.cuh"
#include "trmm_tile.cuh"

namespace {

using trmm::Args;

template <int BM, int BN>
__global__ void __launch_bounds__(trmm::Tile<BM, BN>::THREADS)
trmm_kernel(const Args p, int tri) {
  using T = trmm::Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  // the last row block first: under tri the longest blocks start first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  trmm::tile<T>(p, p.A + z * p.sAb, p.B + z * p.sBb, p.O + z * p.sOb, row0,
                col0, tri != 0, smem);
}

template <int BM, int BN>
cudaError_t launch(const Args& p, int tri, cudaStream_t stream,
                   int* launched) {
  using T = trmm::Tile<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      trmm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  trmm_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p, tri);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated output tile (the Hopper trmm knob
// space).  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a tile with no instantiation.  Writes the grid
// it launched (x, y, z) to launched[0..2].  Does not synchronise.  vec says
// that A, B, their leading strides and batch strides are 16-byte aligned.
extern "C" int repro_trmm_f32(int bm, int bn, const void* a, const void* b,
                              void* o, int m, int n, int batch, long long sAb,
                              long long lda, long long sBb, long long ldb,
                              long long sOb, long long ldo, float alpha,
                              int tri, int vec, void* stream, int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(o), m, n, batch, sAb, lda, sBb, ldb, sOb,
               ldo, alpha, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TRMM_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, tri, s, launched));
  REPRO_TRMM_TILES(REPRO_TRMM_LAUNCH)
#undef REPRO_TRMM_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes and passes, to out[0..3].
extern "C" int repro_trmm_f32_config(int bm, int bn, int* out) {
#define REPRO_TRMM_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return trmm::config<BM, BN>(out), 0;
  REPRO_TRMM_TILES(REPRO_TRMM_CONFIG)
#undef REPRO_TRMM_CONFIG
  return int(cudaErrorInvalidValue);
}
