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
// sqrt seed, then an exact integer fix-up), accumulates the tile with the
// code rank_k.cu runs (rank_k_tile.cuh), parks its values in shared memory
// and, in the same epilogue, stores the tile (i, j) and its transpose to
// (j, i).  A diagonal tile takes its upper triangle from its own lower one.
// Every stored value is one that tri computes with the same operations and
// then mirrors by selection, so tri_packed equals tri bit for bit.
//
// Bound on an H100 SXM: as rank_k.cu, n^2 k operations (syrk) at
// 67 TFLOP/s; this variant does the BLAS count plus the diagonal tiles'
// upper halves and launches no idle block.  The epilogue writes each tile
// twice from shared memory, both times coalesced.

#include "launch_grid.cuh"
#include "rank_k_tile.cuh"

namespace {

using rank_k::Args;

// t -> (i, j) with j <= i, row-major over the lower triangle
__device__ __forceinline__ void detri(long long t, int& i, int& j) {
  int r = int((sqrtf(8.f * float(t) + 1.f) - 1.f) * 0.5f);
  while (static_cast<long long>(r) * (r + 1) / 2 > t) --r;
  while (static_cast<long long>(r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = int(t - static_cast<long long>(r) * (r + 1) / 2);
}

template <int BM, int BK>
__global__ void __launch_bounds__(BM * BM / 64)
rank_k_packed_kernel(Args p) {
  constexpr int T = BM / 8;
  constexpr int THREADS = T * T;
  constexpr int LDS = BM + 1;
  extern __shared__ float smem[];
  int ti, tj;
  detri(blockIdx.x, ti, tj);
  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sAb;
  const float* B = p.two ? p.B + z * p.sBb : nullptr;
  const float* C = p.has_c ? p.C + z * p.sCb : nullptr;
  float* O = p.O + z * p.sOb;
  const int row0 = ti * BM, col0 = tj * BM;

  float acc[8][8];
  rank_k::accumulate<BM, BK>(acc, p, A, B, row0, col0, smem);

  // accumulate() ends on a barrier, so its shared memory is free again
  float* tile = smem;  // [BM][BM + 1]
  const int tid = threadIdx.x;
  const int tx = tid % T, ty = tid / T;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + i * T, gr = row0 + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + j * T, gc = col0 + c;
      if (gr < p.n && gc < p.n)
        tile[r * LDS + c] = rank_k::value(p, C, acc[i][j], gr, gc, true);
    }
  }
  __syncthreads();
  const bool diag = ti == tj;
  for (int idx = tid; idx < BM * BM; idx += THREADS) {
    const int r = idx / BM, c = idx % BM;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < p.n && gc < p.n)
      O[gr * p.ldo + gc] = (diag && r < c) ? tile[c * LDS + r]
                                           : tile[r * LDS + c];
  }
  if (!diag) {
    // the mirror: O[col0 + c, row0 + r] = tile[r][c], neighbouring threads
    // on neighbouring r
    for (int idx = tid; idx < BM * BM; idx += THREADS) {
      const int c = idx / BM, r = idx % BM;
      const int gr = row0 + r, gc = col0 + c;
      if (gr < p.n && gc < p.n) O[gc * p.ldo + gr] = tile[r * LDS + c];
    }
  }
}

template <int BM, int BK>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream,
                   int* launched) {
  constexpr int THREADS = BM * BM / 64;
  static_assert(THREADS < 1024, "tiles of 1024 threads spill");
  const int operands = rank_k::operand_floats<BM, BK>(p.two);
  const int out_tile = BM * (BM + 1);
  const int smem =
      int(sizeof(float)) * (operands > out_tile ? operands : out_tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_k_packed_kernel<BM, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long nb = (p.n + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(nb * (nb + 1) / 2), 1, batch);
  set_grid(launched, grid);
  rank_k_packed_kernel<BM, BK><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated (bm, bk) of the Hopper syrk/syr2k
// knob space (bk is the knob's bn).  Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a tile with no instantiation.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.
extern "C" int repro_rank_k_packed_f32(int bm, int bk, const void* a,
                                       const void* b, const void* c, void* o,
                                       int n, int k, int batch, long long sAb,
                                       long long lda, long long sBb,
                                       long long ldb, long long sCb,
                                       long long ldc, long long sOb,
                                       long long ldo, float alpha, float beta,
                                       int two, int has_c, void* stream,
                                       int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               n, k, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, two, has_c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_RANK_K_TILE(BM, BK) \
  if (bm == BM && bk == BK)                    \
    return int(launch<BM, BK>(p, batch, s, launched));
  REPRO_RANK_K_TILE(64, 16) REPRO_RANK_K_TILE(64, 32) REPRO_RANK_K_TILE(64, 64)
  REPRO_RANK_K_TILE(128, 16) REPRO_RANK_K_TILE(128, 32)
  REPRO_RANK_K_TILE(128, 64)
#undef REPRO_RANK_K_TILE
  return int(cudaErrorInvalidValue);
}
