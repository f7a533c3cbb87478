// TRMM for Hopper (sm_90a) in bfloat16, variants full and tri: O = alpha *
// tril(A) @ B (left, lower, non-unit), A (m, m), B and O (m, n), all
// bfloat16, every product and sum float32 on the tensor cores, O rounded
// to bfloat16 once, at the store.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/trmm.py::_trmm_kernel (via trmm_pallas: bf16 operands,
// a float32 VMEM accumulator, the output in A's dtype).  trmm.cu is its
// float32 twin: the same grid (x the n-tiles, y the m-tiles, z the batch)
// and the same two variants under a runtime flag, on the wgmma mainloop
// (bf16_wgmma_mainloop.cuh: TMA into an mbarrier ring, wgmma.mma_async)
// fed by trmm_tile_bf16.cuh's lower-triangle producer:
//   full: every pass walks the whole contraction, l < m, and multiplies the
//         zero A tiles past the diagonal (zeros TMA makes, A is not read
//         there): the reference's uniform pipeline, about twice tri's
//         products;
//   tri:  the pass of rows prow0 .. prow0 + PM - 1 stops at min(prow0 + PM,
//         m), the end of its rows' stored columns.
// A block's index is mapped to its tile by trmm_tile_bf16.cuh's grouped():
// groups of column tiles, each walked from the last row block up (under
// tri the longest blocks first).
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 989 TFLOP/s
// of dense bf16 against 2 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so a TRMM
// past m of a few hundred is bound by the operations.

#include "launch_grid.cuh"
#include "trmm_tile_bf16.cuh"

namespace {

using btrmm::Args;

// the tile (row block, column tile) of block L of the grid
__host__ __device__ inline void block_tile(long long L, int nx, int nb,
                                           int& row, int& col) {
  int rank;
  btrmm::grouped(L, nx, nb, rank, col);
  row = nb - 1 - rank;
}

template <int BM, int BN>
__global__ void __launch_bounds__(btrmm::Tile<BM, BN>::THREADS,
                                  btrmm::Tile<BM, BN>::BLOCKS)
trmm_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap mb, const Args p,
                 int tri) {
  using T = btrmm::Tile<BM, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  int row, col;
  block_tile(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x,
             gridDim.x, gridDim.y, row, col);
  btrmm::run<T>(&ma, &mb, p, blockIdx.z, row * BM, -1, col * BN, tri != 0,
                smem_raw);
}

template <int BM, int BN>
int launch(Args p, bool vec, int tri, cudaStream_t stream, int* launched) {
  using T = btrmm::Tile<BM, BN>;
  CUtensorMap ma{}, mb{};
  const int rc = btrmm::encode(p, vec, &ma, &mb);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      trmm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  trmm_bf16_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(ma, mb, p,
                                                                  tri);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated output tile, with repro_trmm_f32's
// arguments (A, B and O bf16).  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for a tile with no instantiation;
// wgemm::kEncodeFailed + the CUresult when a tensor map cannot be encoded.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned (TMA reads them).
extern "C" int repro_trmm_bf16(int bm, int bn, const void* a, const void* b,
                               void* o, int m, int n, int batch,
                               long long sAb, long long lda, long long sBb,
                               long long ldb, long long sOb, long long ldo,
                               float alpha, int tri, int vec, void* stream,
                               void* ev_start, void* ev_end, int* launched) {
  const Args p{static_cast<const btrmm::bf16*>(a),
               static_cast<const btrmm::bf16*>(b),
               static_cast<btrmm::bf16*>(o), m, n, batch, sAb, lda, sBb, ldb,
               sOb, ldo, alpha, 0, -1, -1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_TRMM_BF16_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN)            \
    return launch<BM, BN>(p, vec != 0, tri, s, launched);
  REPRO_TRMM_BF16_TILES(REPRO_TRMM_BF16_LAUNCH)
#undef REPRO_TRMM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes, warpgroups and A's swizzle bytes,
// to out[0..5].
extern "C" int repro_trmm_bf16_config(int bm, int bn, int* out) {
#define REPRO_TRMM_BF16_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return btrmm::config<BM, BN>(out), 0;
  REPRO_TRMM_BF16_TILES(REPRO_TRMM_BF16_CONFIG)
#undef REPRO_TRMM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}

// The tile of block L (y * nx + x) of a grid of nx column tiles by nb row
// blocks: its row block and column tile, to out[0..1]
// (kernels/trmm.py::tile_of_block mirrors it).
extern "C" void repro_trmm_bf16_block_tile(int nx, int nb, long long L,
                                           int* out) {
  block_tile(L, nx, nb, out[0], out[1]);
}
