// TRMM for Hopper (sm_90a), variant tri_packed: O = alpha * tril(A) @ B with
// only live work launched and every block given about the same amount of it.
// Same function, operands and result as trmm.cu's tri, bit for bit.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/trmm.py::_trmm_packed_kernel, whose grid (n-tiles, T)
// enumerates only the T = nb (nb + 1) / 2 live (i, l <= i) tile pairs, so
// the TPU pays no grid step for a tile past the diagonal.  On Hopper the
// contraction loop runs inside the block, so trmm.cu's tri already does no
// dead arithmetic; what remains is the imbalance of its blocks: row block 0
// does one step block of work and row block nb - 1 does nb.
//
// Layout.  Grid x walks the n-tiles, grid y the ceil(nb / 2) row-block
// pairs, grid z the batch.  The block at y = p computes the output tile of
// row block p and then that of row block nb - 1 - p (once, when the two
// are the middle block of an odd nb), so every block does about nb + 1 step
// blocks of live work and the grid launches no idle block.  Both tiles run
// the code trmm.cu runs under tri (trmm_tile.cuh, on the f32 mainloop of
// sgemm_mainloop.cuh) with the same contraction ends, so tri_packed equals
// tri bit for bit.
//
// Bound on an H100 SXM: as trmm.cu, m^2 n operations at 67 TFLOP/s.  The
// launch has about half tri's blocks, each with twice the work: fewer
// blocks than the card's 132 SMs at small shapes, where tri wins.

#include "launch_grid.cuh"
#include "trmm_tile.cuh"

namespace {

using trmm::Args;

template <int BM, int BN>
__global__ void __launch_bounds__(trmm::Tile<BM, BN>::THREADS)
trmm_packed_kernel(const Args p) {
  using T = trmm::Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int nb = (p.m + BM - 1) / BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sAb;
  const float* B = p.B + z * p.sBb;
  float* O = p.O + z * p.sOb;
  const int lo = blockIdx.y, hi = nb - 1 - int(blockIdx.y);
  trmm::tile<T>(p, A, B, O, lo * BM, col0, true, smem);
  if (hi != lo) trmm::tile<T>(p, A, B, O, hi * BM, col0, true, smem);
}

template <int BM, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  using T = trmm::Tile<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      trmm_packed_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const int nb = (p.m + BM - 1) / BM;
  const dim3 grid((p.n + BN - 1) / BN, (nb + 1) / 2, p.batch);
  set_grid(launched, grid);
  trmm_packed_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated output tile (the Hopper trmm knob
// space).  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a tile with no instantiation.  Writes the grid
// it launched (x, y, z) to launched[0..2].  Does not synchronise.  vec says
// that A, B, their leading strides and batch strides are 16-byte aligned.
extern "C" int repro_trmm_packed_f32(int bm, int bn, const void* a,
                                     const void* b, void* o, int m, int n,
                                     int batch, long long sAb, long long lda,
                                     long long sBb, long long ldb,
                                     long long sOb, long long ldo,
                                     float alpha, int vec, void* stream,
                                     int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<float*>(o), m, n, batch, sAb, lda, sBb, ldb, sOb,
               ldo, alpha, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TRMM_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, s, launched));
  REPRO_TRMM_TILES(REPRO_TRMM_LAUNCH)
#undef REPRO_TRMM_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes and passes, to out[0..3].
extern "C" int repro_trmm_packed_f32_config(int bm, int bn, int* out) {
#define REPRO_TRMM_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return trmm::config<BM, BN>(out), 0;
  REPRO_TRMM_TILES(REPRO_TRMM_CONFIG)
#undef REPRO_TRMM_CONFIG
  return int(cudaErrorInvalidValue);
}
