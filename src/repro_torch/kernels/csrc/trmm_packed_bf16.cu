// TRMM for Hopper (sm_90a) in bfloat16, variant tri_packed: O = alpha *
// tril(A) @ B with only live work launched and every block given about the
// same amount of it.  Same function, operands and result as trmm_bf16.cu's
// tri, bit for bit.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/trmm.py::_trmm_packed_kernel (its grid enumerates only
// the nb (nb + 1) / 2 live tile pairs; bf16 operands, a float32
// accumulator, the output in A's dtype).  trmm_packed.cu is its float32
// twin: grid x walks the n-tiles, grid y the ceil(nb / 2) row-block pairs,
// grid z the batch, and the block of pair p computes the output tile of
// row block p and then that of row block nb - 1 - p (once, when the two
// are the middle block of an odd nb), so every block does about nb + 1
// step blocks of live work.  Both tiles run trmm_tile_bf16.cuh's passes
// with tri's contraction ends, as one sequence through one ring on the
// wgmma mainloop (the second tile's first copies overlap the first's
// products and epilogue), so tri_packed equals tri bit for bit.  A block's
// index is mapped to its pair and column tile by grouped(), as in
// trmm_bf16.cu.
//
// Bound on an H100 SXM: as trmm_bf16.cu, m^2 n operations at 989 TFLOP/s.
// The launch has about half tri's blocks, each with twice the work: fewer
// blocks than the card's 132 SMs at small shapes, where tri wins.

#include "launch_grid.cuh"
#include "trmm_tile_bf16.cuh"

namespace {

using btrmm::Args;

// the pair and column tile of block L of the grid of nx column tiles by
// ceil(nb / 2) pairs
__host__ __device__ inline void block_tile(long long L, int nx, int nb,
                                           int& pair, int& col) {
  btrmm::grouped(L, nx, (nb + 1) / 2, pair, col);
}

template <int BM, int BN>
__global__ void __launch_bounds__(btrmm::Tile<BM, BN>::THREADS,
                                  btrmm::Tile<BM, BN>::BLOCKS)
trmm_packed_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                        const __grid_constant__ CUtensorMap mb,
                        const Args p) {
  using T = btrmm::Tile<BM, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nb = (p.m + BM - 1) / BM;
  int lo, col;
  block_tile(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x,
             gridDim.x, nb, lo, col);
  const int hi = nb - 1 - lo;
  btrmm::run<T>(&ma, &mb, p, blockIdx.z, lo * BM, hi != lo ? hi * BM : -1,
                col * BN, true, smem_raw);
}

template <int BM, int BN>
int launch(Args p, bool vec, cudaStream_t stream, int* launched) {
  using T = btrmm::Tile<BM, BN>;
  CUtensorMap ma{}, mb{};
  const int rc = btrmm::encode(p, vec, &ma, &mb);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      trmm_packed_bf16_kernel<BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const int nb = (p.m + BM - 1) / BM;
  const dim3 grid((p.n + BN - 1) / BN, (nb + 1) / 2, p.batch);
  set_grid(launched, grid);
  trmm_packed_bf16_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(
      ma, mb, p);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated output tile, with
// repro_trmm_packed_f32's arguments (A, B and O bf16).  Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for a
// tile with no instantiation; wgemm::kEncodeFailed + the CUresult when a
// tensor map cannot be encoded.  Writes the grid it launched (x, y, z) to
// launched[0..2].  Does not synchronise.  vec says that A, B, their leading
// strides and batch strides are 16-byte aligned (TMA reads them).
extern "C" int repro_trmm_packed_bf16(int bm, int bn, const void* a,
                                      const void* b, void* o, int m, int n,
                                      int batch, long long sAb, long long lda,
                                      long long sBb, long long ldb,
                                      long long sOb, long long ldo,
                                      float alpha, int vec, void* stream,
                                      void* ev_start, void* ev_end,
                                      int* launched) {
  const Args p{static_cast<const btrmm::bf16*>(a),
               static_cast<const btrmm::bf16*>(b),
               static_cast<btrmm::bf16*>(o), m, n, batch, sAb, lda, sBb, ldb,
               sOb, ldo, alpha, 0, -1, -1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_TRMM_BF16_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return launch<BM, BN>(p, vec != 0, s, launched);
  REPRO_TRMM_BF16_TILES(REPRO_TRMM_BF16_LAUNCH)
#undef REPRO_TRMM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes, warpgroups and A's swizzle bytes,
// to out[0..5].
extern "C" int repro_trmm_packed_bf16_config(int bm, int bn, int* out) {
#define REPRO_TRMM_BF16_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return btrmm::config<BM, BN>(out), 0;
  REPRO_TRMM_BF16_TILES(REPRO_TRMM_BF16_CONFIG)
#undef REPRO_TRMM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}

// The tile of block L (y * nx + x) of a grid of nx column tiles by
// ceil(nb / 2) pairs: its pair p (the tiles of row blocks p and nb - 1 -
// p) and column tile, to out[0..1] (kernels/trmm.py::tile_of_block mirrors
// it).
extern "C" void repro_trmm_packed_bf16_block_tile(int nx, int nb,
                                                  long long L, int* out) {
  block_tile(L, nx, nb, out[0], out[1]);
}
