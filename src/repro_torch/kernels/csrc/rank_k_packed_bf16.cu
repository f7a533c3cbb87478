// SYRK / SYR2K for Hopper (sm_90a) in bfloat16, variant tri_packed: only
// the nb (nb + 1) / 2 tiles on and below the diagonal are launched, and
// each block writes its tile and the tile's mirror.  Same function,
// operands and C semantics as rank_k_bf16.cu's tri (C read as
// lower-stored), bit for bit.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/syrk.py::_rank_k_packed_kernel (bf16 operands, a
// float32 accumulator, a diagonal block symmetrised in float32 and then
// cast to A's dtype).  rank_k_packed.cu is its float32 twin: grid x is the
// packed tile index t and grid z the batch; a block maps t to its tile
// (i, j), j <= i, by bands of tile rows (brank_k::packed, so that the
// blocks in flight share rows of A in L2), and runs the tile
// rank_k_bf16.cu runs under tri (rank_k_tile_bf16.cuh: TMA copies of rows
// of A or B into the wgmma mainloop, then one epilogue that parks the
// rounded values in the idle ring and stores the tile (i, j) and its
// transpose to (j, i); a diagonal tile takes its upper triangle from its
// own lower one).  Every stored value is computed by the same operations
// in the same order as under tri, so tri_packed equals tri bit for bit.
//
// Bound on an H100 SXM: as rank_k_bf16.cu, n^2 k operations (syrk) at
// 989 TFLOP/s; this variant does the BLAS count plus the diagonal tiles'
// upper halves and launches no idle block.

#include "launch_grid.cuh"
#include "rank_k_tile_bf16.cuh"

namespace {

using brank_k::Args;
using brank_k::bf16;

template <int BM, int BK>
__global__ void __launch_bounds__(brank_k::Tile<BM, BK>::THREADS,
                                  brank_k::Tile<BM, BK>::BLOCKS)
rank_k_packed_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                          const __grid_constant__ CUtensorMap mb,
                          const Args p) {
  using T = brank_k::Tile<BM, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  int ti, tj;
  brank_k::packed(blockIdx.x, (p.n + BM - 1) / BM, ti, tj);
  brank_k::tile<T>(&ma, &mb, p, blockIdx.z, ti * BM, tj * BM, true,
                   smem_raw);
}

template <int BM, int BK>
int launch(Args p, bool vec, int batch, cudaStream_t stream, int* launched) {
  using T = brank_k::Tile<BM, BK>;
  CUtensorMap ma{}, mb{};
  const int rc = brank_k::encode<T>(p, vec, batch, &ma, &mb);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      rank_k_packed_bf16_kernel<BM, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const long long nb = (p.n + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(nb * (nb + 1) / 2), 1, batch);
  set_grid(launched, grid);
  rank_k_packed_bf16_kernel<BM, BK><<<grid, T::THREADS, T::SMEM, stream>>>(
      ma, mb, p);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated (bm, bk) of the Hopper syrk/syr2k
// knob space (bk is the knob's bn), with repro_rank_k_packed_f32's
// arguments (A, B, C and O bf16).  Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a tile with no instantiation;
// wgemm::kEncodeFailed + the CUresult when a tensor map cannot be encoded.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned (TMA reads them).
extern "C" int repro_rank_k_packed_bf16(int bm, int bk, const void* a,
                                        const void* b, const void* c,
                                        void* o, int n, int k, int batch,
                                        long long sAb, long long lda,
                                        long long sBb, long long ldb,
                                        long long sCb, long long ldc,
                                        long long sOb, long long ldo,
                                        float alpha, float beta, int two,
                                        int has_c, int vec, void* stream,
                                        void* ev_start, void* ev_end,
                                        int* launched) {
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
               static_cast<const bf16*>(c), static_cast<bf16*>(o),
               n, k, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, two, has_c, 0, -1, -1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_RANK_K_BF16_LAUNCH(BM, BK) \
  if (bm == BM && bk == BK)                \
    return launch<BM, BK>(p, vec != 0, batch, s, launched);
  REPRO_RANK_K_TILES(REPRO_RANK_K_BF16_LAUNCH)
#undef REPRO_RANK_K_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes, warpgroups, the swizzle bytes, the
// blocks an SM and the park's bytes, to out[0..7].
extern "C" int repro_rank_k_packed_bf16_config(int bm, int bk, int* out) {
#define REPRO_RANK_K_BF16_CONFIG(BM, BK) \
  if (bm == BM && bk == BK) return brank_k::config<BM, BK>(out), 0;
  REPRO_RANK_K_TILES(REPRO_RANK_K_BF16_CONFIG)
#undef REPRO_RANK_K_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}

// The tile (i, j), j <= i, the block with index t of the packed grid of an
// nb x nb tile grid computes, to ij[0..1].
extern "C" int repro_rank_k_packed_bf16_block_tile(int nb, long long t,
                                                   int* ij) {
  brank_k::packed(t, nb, ij[0], ij[1]);
  return 0;
}
