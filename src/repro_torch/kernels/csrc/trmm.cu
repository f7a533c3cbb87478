// TRMM for Hopper (sm_90a), variants full and tri: O = alpha * tril(A) @ B
// (left, lower, non-unit), A (m, m), B and O (m, n), float32 in and out,
// float32 accumulator, in IEEE arithmetic on the CUDA cores.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/trmm.py::_trmm_kernel (via trmm_pallas), which walks a
// sequential (i, j, l) grid with the sum over l carried in VMEM scratch and
// the diagonal tile masked by _tril_block.  Here one block owns the output
// tile (i, j) and runs the l loop itself (trmm_tile.cuh); grid x walks the
// n-tiles, grid y the m-tiles, grid z the batch, as in symm.cu.
//
// Variants (runtime flag tri), as in the reference:
//   full: every block walks the whole contraction, l < m, and multiplies the
//         zero-filled A tiles past the diagonal (without reading A there):
//         the reference's uniform pipeline, about twice tri's FMAs;
//   tri:  block row i stops its loop at min((i + 1) * bm, m), the end of
//         A's stored part of its rows, so it does no arithmetic past the
//         diagonal; block rows near the top finish first.
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 67 TFLOP/s
// against 4 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so a TRMM past m of a few
// dozen is bound by the operations.  This first design does nothing yet
// about that bound beyond the register tile: one shared-memory stage, no
// asynchronous copies, no overlap of loads with the FMAs.

#include "launch_grid.cuh"
#include "trmm_tile.cuh"

namespace {

using trmm::Args;

template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 64)
trmm_kernel(Args p, int tri) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  const int kend = tri ? trmm::tri_end<BM>(row0, p.m) : p.m;
  trmm::tile<BM, BN>(p, p.A + z * p.sAb, p.B + z * p.sBb, p.O + z * p.sOb,
                     row0, col0, kend, smem);
}

template <int BM, int BN>
cudaError_t launch(const Args& p, int batch, int tri, cudaStream_t stream,
                   int* launched) {
  constexpr int THREADS = BM * BN / 64;
  constexpr int SMEM = trmm::smem_bytes<BM, BN>();
  static_assert(THREADS < 1024, "tiles of 1024 threads spill");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
  if (SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trmm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, batch);
  set_grid(launched, grid);
  trmm_kernel<BM, BN><<<grid, THREADS, SMEM, stream>>>(p, tri);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated output tile (the Hopper trmm knob
// space).  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a tile with no instantiation.  Writes the grid
// it launched (x, y, z) to launched[0..2].  Does not synchronise.
extern "C" int repro_trmm_f32(int bm, int bn, const void* a, const void* b,
                              void* o, int m, int n, int batch, long long sAb,
                              long long lda, long long sBb, long long ldb,
                              long long sOb, long long ldo, float alpha,
                              int tri, void* stream, int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(o), m, n, sAb, lda, sBb, ldb, sOb, ldo,
               alpha};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TRMM_TILE(BM, BN)                          \
  if (bm == BM && bn == BN)                              \
    return int(launch<BM, BN>(p, batch, tri, s, launched));
  REPRO_TRMM_TILE(64, 64) REPRO_TRMM_TILE(64, 128) REPRO_TRMM_TILE(64, 256)
  REPRO_TRMM_TILE(128, 64) REPRO_TRMM_TILE(128, 128) REPRO_TRMM_TILE(128, 256)
  REPRO_TRMM_TILE(256, 64) REPRO_TRMM_TILE(256, 128)
#undef REPRO_TRMM_TILE
  return int(cudaErrorInvalidValue);
}
