// TRMM for Hopper (sm_90a) in bfloat16, variants full and tri: O = alpha *
// tril(A) @ B (left, lower, non-unit), A (m, m), B and O (m, n), all
// bfloat16, every product and sum float32 on the tensor cores, O rounded
// to bfloat16 once, at the store.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/trmm.py::_trmm_kernel (via trmm_pallas: bf16 operands,
// a float32 VMEM accumulator, the output in A's dtype).  trmm.cu is its
// float32 twin: the same grid (x the n-tiles, y the m-tiles from the last
// up, z the batch), the same two variants under a runtime flag, fed by the
// lower-triangle producer of trmm_tile_bf16.cuh on the bf16 mainloop
// (bf16_mainloop.cuh) in place of the float32 one:
//   full: every pass walks the whole contraction, l < m, and multiplies the
//         zero-filled A tiles past the diagonal (without reading A there):
//         the reference's uniform pipeline, about twice tri's products;
//   tri:  the pass of rows prow0 .. prow0 + PM - 1 stops at min(prow0 + PM,
//         m), the end of its rows' stored columns; block row i does i + 1
//         steps, so the grid starts with the last block row.
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 989 TFLOP/s
// of dense bf16 against 2 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so a TRMM
// past m of a few hundred is bound by the operations.  mma.sync reaches
// only a part of the tensor cores' rate; wgmma and TMA are later work.

#include "launch_grid.cuh"
#include "trmm_tile_bf16.cuh"

namespace {

using btrmm::Args;

template <int BM, int BN>
__global__ void __launch_bounds__(btrmm::Tile<BM, BN>::THREADS, 1)
trmm_bf16_kernel(const Args p, int tri) {
  using T = btrmm::Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  btrmm::bf16* smem = reinterpret_cast<btrmm::bf16*>(smem_bytes);
  // the last row block first: under tri the longest blocks start first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  btrmm::tile<T>(p, p.A + z * p.sAb, p.B + z * p.sBb, p.O + z * p.sOb, row0,
                 col0, tri != 0, smem);
}

template <int BM, int BN>
cudaError_t launch(const Args& p, int tri, cudaStream_t stream,
                   int* launched) {
  using T = btrmm::Tile<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      trmm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  trmm_bf16_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p, tri);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated output tile, with repro_trmm_f32's
// arguments (A, B and O bf16).  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for a tile with no instantiation.  Writes
// the grid it launched (x, y, z) to launched[0..2].  Does not synchronise.
// vec says that A, B, their leading strides and batch strides are 16-byte
// aligned.
extern "C" int repro_trmm_bf16(int bm, int bn, const void* a, const void* b,
                               void* o, int m, int n, int batch,
                               long long sAb, long long lda, long long sBb,
                               long long ldb, long long sOb, long long ldo,
                               float alpha, int tri, int vec, void* stream,
                               void* ev_start, void* ev_end, int* launched) {
  const Args p{static_cast<const btrmm::bf16*>(a),
               static_cast<const btrmm::bf16*>(b),
               static_cast<btrmm::bf16*>(o), m, n, batch, sAb, lda, sBb, ldb,
               sOb, ldo, alpha, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_TRMM_BF16_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, tri, s, launched));
  REPRO_TRMM_BF16_TILES(REPRO_TRMM_BF16_LAUNCH)
#undef REPRO_TRMM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes and the warp grid (m, n), to
// out[0..5].
extern "C" int repro_trmm_bf16_config(int bm, int bn, int* out) {
#define REPRO_TRMM_BF16_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return btrmm::config<BM, BN>(out), 0;
  REPRO_TRMM_BF16_TILES(REPRO_TRMM_BF16_CONFIG)
#undef REPRO_TRMM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}
