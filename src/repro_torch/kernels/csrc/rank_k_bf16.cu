// SYRK / SYR2K for Hopper (sm_90a) in bfloat16, variants full and tri:
//   syrk : O = alpha * A @ A^T + beta * C
//   syr2k: O = alpha * (A @ B^T + B @ A^T) + beta * C
// A and B (n, k), C and O (n, n), all bfloat16, every product and sum
// float32 on the tensor cores, O rounded to bfloat16 once, at the store.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/syrk.py::_rank_k_kernel (via _rank_k_call: bf16
// operands, jnp.dot(..., preferred_element_type=jnp.float32) into a float32
// VMEM scratch, the output in A's dtype).  rank_k.cu is its float32 twin:
// the same grid (x and y the tile grid, z the batch), the same runtime
// flags (two: syr2k, tri, has_c, vec), the tile of rank_k_tile_bf16.cuh
// (both sides K-major rows of A or B, copied by TMA into the wgmma
// mainloop's ring of bf16_wgmma_mainloop.cuh) in place of the float32 one.
// A block's index y * nb + x is mapped to its tile by groups of tile rows
// (brank_k::grouped), so that the blocks in flight share rows of A in L2.
// Variants, as in the reference:
//   full: every tile is computed, both triangles, and C is added as given;
//   tri:  the whole nb x nb grid is launched, but the tiles above the
//         diagonal (j > i) return at once; a tile (i, j <= i) is stored at
//         (i, j) and transposed at (j, i) in one epilogue, a diagonal tile
//         taking its upper triangle from its lower one; C is read as
//         lower-stored.  The same tile and epilogue as
//         rank_k_packed_bf16.cu, so the two variants give the same bits.
//
// Bound on an H100 SXM (rank_k_tile_bf16.cuh): n^2 k operations (syrk; syr2k
// twice) at 989 TFLOP/s, so the big calls are bound by the operations; full
// does twice the BLAS count, tri the BLAS count plus the diagonal tiles'
// upper halves and launches nb (nb - 1) / 2 idle blocks.

#include "launch_grid.cuh"
#include "rank_k_tile_bf16.cuh"

namespace {

using brank_k::Args;
using brank_k::bf16;

template <int BM, int BK>
__global__ void __launch_bounds__(brank_k::Tile<BM, BK>::THREADS,
                                  brank_k::Tile<BM, BK>::BLOCKS)
rank_k_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb, const Args p,
                   int tri) {
  using T = brank_k::Tile<BM, BK>;
  int ti, tj;
  brank_k::grouped(static_cast<long long>(blockIdx.y) * gridDim.x +
                       blockIdx.x,
                   gridDim.x, ti, tj);
  if (tri && tj > ti) return;  // tri: no arithmetic above the diagonal
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  brank_k::tile<T>(&ma, &mb, p, blockIdx.z, ti * BM, tj * BM, tri != 0,
                   smem_raw);
}

template <int BM, int BK>
int launch(Args p, bool vec, int batch, int tri, cudaStream_t stream,
           int* launched) {
  using T = brank_k::Tile<BM, BK>;
  CUtensorMap ma{}, mb{};
  const int rc = brank_k::encode<T>(p, vec, batch, &ma, &mb);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      rank_k_bf16_kernel<BM, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const int nb = (p.n + BM - 1) / BM;
  const dim3 grid(nb, nb, batch);
  set_grid(launched, grid);
  rank_k_bf16_kernel<BM, BK><<<grid, T::THREADS, T::SMEM, stream>>>(ma, mb, p,
                                                                    tri);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated (bm, bk) of the Hopper syrk/syr2k
// knob space (bk is the knob's bn), with repro_rank_k_f32's arguments (A,
// B, C and O bf16).  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a tile with no instantiation;
// wgemm::kEncodeFailed + the CUresult when a tensor map cannot be encoded.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned (TMA reads them).
extern "C" int repro_rank_k_bf16(int bm, int bk, const void* a, const void* b,
                                 const void* c, void* o, int n, int k,
                                 int batch, long long sAb, long long lda,
                                 long long sBb, long long ldb, long long sCb,
                                 long long ldc, long long sOb, long long ldo,
                                 float alpha, float beta, int two, int tri,
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
    return launch<BM, BK>(p, vec != 0, batch, tri, s, launched);
  REPRO_RANK_K_TILES(REPRO_RANK_K_BF16_LAUNCH)
#undef REPRO_RANK_K_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes, warpgroups, the swizzle bytes, the
// blocks an SM and the park's bytes, to out[0..7].
extern "C" int repro_rank_k_bf16_config(int bm, int bk, int* out) {
#define REPRO_RANK_K_BF16_CONFIG(BM, BK) \
  if (bm == BM && bk == BK) return brank_k::config<BM, BK>(out), 0;
  REPRO_RANK_K_TILES(REPRO_RANK_K_BF16_CONFIG)
#undef REPRO_RANK_K_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}

// The tile (i, j) the block with index t = y * nb + x of an nb x nb grid
// computes, to ij[0..1].
extern "C" int repro_rank_k_bf16_block_tile(int nb, long long t, int* ij) {
  brank_k::grouped(t, nb, ij[0], ij[1]);
  return 0;
}
