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
// packed tile index t and grid z the batch; a block de-triangularises t to
// (i, j), j <= i (a float sqrt seed, then an exact integer fix-up), and
// runs the tile rank_k_bf16.cu runs under tri (rank_k_tile_bf16.cuh: the
// rank-k producer on the bf16 mainloop, then one epilogue that parks the
// rounded values in the idle ring and stores the tile (i, j) and its
// transpose to (j, i), both coalesced; a diagonal tile takes its upper
// triangle from its own lower one).  Every stored value is computed by the
// same operations in the same order as under tri, so tri_packed equals tri
// bit for bit.
//
// Bound on an H100 SXM: as rank_k_bf16.cu, n^2 k operations (syrk) at
// 989 TFLOP/s; this variant does the BLAS count plus the diagonal tiles'
// upper halves and launches no idle block.

#include "launch_grid.cuh"
#include "rank_k_tile_bf16.cuh"

namespace {

using brank_k::Args;
using brank_k::bf16;

// t -> (i, j) with j <= i, row-major over the lower triangle
__device__ __forceinline__ void detri(long long t, int& i, int& j) {
  int r = int((sqrtf(8.f * float(t) + 1.f) - 1.f) * 0.5f);
  while (static_cast<long long>(r) * (r + 1) / 2 > t) --r;
  while (static_cast<long long>(r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = int(t - static_cast<long long>(r) * (r + 1) / 2);
}

template <int BM, int BK>
__global__ void __launch_bounds__(brank_k::Tile<BM, BK>::THREADS, 1)
rank_k_packed_bf16_kernel(const Args p) {
  using T = brank_k::Tile<BM, BK>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* smem = reinterpret_cast<bf16*>(smem_bytes);
  int ti, tj;
  detri(blockIdx.x, ti, tj);
  const long long z = blockIdx.z;
  brank_k::tile<T, true>(p, p.A + z * p.sAb,
                         p.two ? p.B + z * p.sBb : nullptr,
                         p.has_c ? p.C + z * p.sCb : nullptr,
                         p.O + z * p.sOb, ti * BM, tj * BM, smem);
}

template <int BM, int BK>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream,
                   int* launched) {
  using T = brank_k::Tile<BM, BK>;
  const cudaError_t e = cudaFuncSetAttribute(
      rank_k_packed_bf16_kernel<BM, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const long long nb = (p.n + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(nb * (nb + 1) / 2), 1, batch);
  set_grid(launched, grid);
  rank_k_packed_bf16_kernel<BM, BK><<<grid, T::THREADS, T::SMEM, stream>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated (bm, bk) of the Hopper syrk/syr2k
// knob space (bk is the knob's bn), with repro_rank_k_packed_f32's
// arguments (A, B, C and O bf16).  Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a tile with no instantiation.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned.
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
               alpha, beta, two, has_c, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_RANK_K_BF16_LAUNCH(BM, BK) \
  if (bm == BM && bk == BK)                \
    return int(launch<BM, BK>(p, batch, s, launched));
  REPRO_RANK_K_TILES(REPRO_RANK_K_BF16_LAUNCH)
#undef REPRO_RANK_K_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes and the warp grid (m, n), to
// out[0..5].
extern "C" int repro_rank_k_packed_bf16_config(int bm, int bk, int* out) {
#define REPRO_RANK_K_BF16_CONFIG(BM, BK) \
  if (bm == BM && bk == BK) return brank_k::config<BM, BK>(out), 0;
  REPRO_RANK_K_TILES(REPRO_RANK_K_BF16_CONFIG)
#undef REPRO_RANK_K_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}
