// SYRK / SYR2K for Hopper (sm_90a), variant tri_packed: only the
// nb (nb + 1) / 2 tiles on and below the diagonal are launched, and each
// block writes its tile and the tile's mirror.  Same function, operands and
// C semantics as rank_k.cu's tri (C read as lower-stored).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/syrk.py::_rank_k_packed_kernel, with detri / tri_count
// (syrk.py:49-62).  The TPU kernel walks a packed (T, nk + 1) grid: nk steps
// accumulate the tile (i, j), the last of them stores it with a diagonal
// tile symmetrised, and one extra write-only step stores the transposed tile
// to (j, i) from VMEM scratch.  Here grid x is the packed tile index t and
// grid z the batch; a block de-triangularises t to (i, j), j <= i (a float
// sqrt seed, then an exact integer fix-up), and runs the tile rank_k.cu
// runs under tri (rank_k_tile.cuh: the rank-k producer on the f32 mainloop
// of sgemm_mainloop.cuh, then one epilogue that parks the values in the
// idle ring and stores the tile (i, j) and its transpose to (j, i), both
// coalesced; a diagonal tile takes its upper triangle from its own lower
// one).  Every stored value is computed by the same operations in the same
// order as under tri, so tri_packed equals tri bit for bit.
//
// Bound on an H100 SXM: as rank_k.cu, n^2 k operations (syrk) at
// 67 TFLOP/s; this variant does the BLAS count plus the diagonal tiles'
// upper halves and launches no idle block.

#include "launch_grid.cuh"
#include "rank_k_tile.cuh"

namespace {

using rank_k::Args;

// t -> (i, j) with j <= i, row-major over the lower triangle
__device__ __forceinline__ void detri(long long t, int& i, int& j) {
  i = rank_k::tri_row(t);
  j = int(t - static_cast<long long>(i) * (i + 1) / 2);
}

template <int BM, int BK>
__global__ void __launch_bounds__(rank_k::Tile<BM, BK>::THREADS)
rank_k_packed_kernel(const Args p) {
  using T = rank_k::Tile<BM, BK>;
  extern __shared__ __align__(16) float smem[];
  int ti, tj;
  detri(blockIdx.x, ti, tj);
  const long long z = blockIdx.z;
  rank_k::tile<T, true>(p, p.A + z * p.sAb,
                        p.two ? p.B + z * p.sBb : nullptr,
                        p.has_c ? p.C + z * p.sCb : nullptr, p.O + z * p.sOb,
                        ti * BM, tj * BM, smem);
}

template <int BM, int BK>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream,
                   int* launched) {
  using T = rank_k::Tile<BM, BK>;
  if (T::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_k_packed_kernel<BM, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
  }
  const long long nb = (p.n + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(nb * (nb + 1) / 2), 1, batch);
  set_grid(launched, grid);
  rank_k_packed_kernel<BM, BK><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated (bm, bk) of the Hopper syrk/syr2k
// knob space (bk is the knob's bn).  Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a tile with no instantiation.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned.
extern "C" int repro_rank_k_packed_f32(int bm, int bk, const void* a,
                                       const void* b, const void* c, void* o,
                                       int n, int k, int batch, long long sAb,
                                       long long lda, long long sBb,
                                       long long ldb, long long sCb,
                                       long long ldc, long long sOb,
                                       long long ldo, float alpha, float beta,
                                       int two, int has_c, int vec,
                                       void* stream, void* ev_start,
                                       void* ev_end, int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               n, k, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, two, has_c, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_RANK_K_LAUNCH(BM, BK) \
  if (bm == BM && bk == BK)           \
    return int(launch<BM, BK>(p, batch, s, launched));
  REPRO_RANK_K_TILES(REPRO_RANK_K_LAUNCH)
#undef REPRO_RANK_K_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes and passes, to out[0..3].
extern "C" int repro_rank_k_packed_f32_config(int bm, int bk, int* out) {
#define REPRO_RANK_K_CONFIG(BM, BK) \
  if (bm == BM && bk == BK) return rank_k::config<BM, BK>(out), 0;
  REPRO_RANK_K_TILES(REPRO_RANK_K_CONFIG)
#undef REPRO_RANK_K_CONFIG
  return int(cudaErrorInvalidValue);
}
