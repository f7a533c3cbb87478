// GEMM for Hopper (sm_90a): O = alpha * A @ B + beta * C, float32 in and
// out, float32 accumulator, in IEEE arithmetic on the CUDA cores.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/gemm.py::_gemm_kernel / gemm_pallas, together with its
// leading-batch-axis transform (_batching.py::with_batch_axis) and its
// ragged-tail masks (gemm.py::mask_cols / mask_rows).
//
// Layout.  One block computes one bm x bn tile of O.  Grid x walks the
// n-tiles, grid y the m-tiles, grid z the batch.  The k loop runs inside
// the block and replaces the reference's sequential ("arbitrary") grid axis:
// blocks run in parallel and in no order here, so nothing may carry over
// between them.  Each step stages one A tile (transposed, rows padded by one
// float so the transposing store is free of bank conflicts) and one B tile
// in shared memory; each of the bm * bn / 64 threads keeps an 8 x 8 tile of
// accumulators in registers.  Thread (ty, tx) owns rows ty + i * bm / 8 and
// columns tx + j * bn / 8, so the B reads of a warp and its stores of O fall
// on neighbouring addresses.
//
// Ragged edges.  Loads past m, n or k read zero and stores past m or n are
// dropped.  The masked zeros add nothing to the sums, the semantics of the
// reference's masks.  A B with batch stride 0 is one weight shared by every
// item of the stack.  C is read only when the caller passes has_c (beta != 0
// and a C was given), as the reference's has_c.
//
// Bound on an H100 SXM: float32 outside the tensor cores peaks at 67 TFLOP/s
// against 3.35 TB/s of HBM, so a GEMM with more than about 20 operations per
// byte moved is bound by the operations, and the decode-sized ones (a few
// rows) by the bytes.  This first design does nothing yet about either
// bound: one shared-memory stage, no asynchronous copies, no vector loads,
// no overlap of loads with the FMAs.  A float32 wgmma would run in TF32, a
// different result, so the fast path for float32 stays on the CUDA cores.

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

template <int BM, int BK, int BN>
__global__ void __launch_bounds__(BM * BN / 64)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ C, float* __restrict__ O,
            int m, int n, int k,
            long long sAb, long long lda, long long sBb, long long ldb,
            long long sCb, long long ldc, long long sOb, long long ldo,
            float alpha, float beta, int has_c) {
  constexpr int TX = BN / 8;
  constexpr int TY = BM / 8;
  constexpr int THREADS = TX * TY;
  constexpr int LDS_A = BM + 1;

  extern __shared__ float smem[];
  float* As = smem;               // [BK][BM + 1]: the A tile, transposed
  float* Bs = smem + BK * LDS_A;  // [BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  A += z * sAb;
  B += z * sBb;
  O += z * sOb;
  if (has_c) C += z * sCb;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk * LDS_A + r] = (gr < m && gk < k) ? A[gr * lda + gk] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk * BN + c] = (gk < k && gc < n) ? B[gk * ldb + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk * LDS_A + ty + i * TY];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk * BN + tx + j * TX];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= n) continue;
      float v = alpha * acc[i][j];
      if (has_c) v += beta * C[r * ldc + c];
      O[r * ldo + c] = v;
    }
  }
}

struct Args {
  const float* A;
  const float* B;
  const float* C;
  float* O;
  int m, n, k, batch;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int has_c;
};

template <int BM, int BK, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  constexpr int THREADS = BM * BN / 64;
  constexpr int SMEM = int(sizeof(float)) * BK * (BM + 1 + BN);
  static_assert(THREADS <= 1024, "one thread per 8 x 8 accumulator tile");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
  if (SMEM > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory; the attribute
    // belongs to the kernel and is set before every launch because it is
    // cheap and a process may use more than one card
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<BM, BK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  gemm_kernel<BM, BK, BN><<<grid, THREADS, SMEM, stream>>>(
      p.A, p.B, p.C, p.O, p.m, p.n, p.k, p.sAb, p.lda, p.sBb, p.ldb, p.sCb,
      p.ldc, p.sOb, p.ldo, p.alpha, p.beta, p.has_c);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated tile.  Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue for a tile with no
// instantiation.  Writes the grid it launched (x, y, z) to launched[0..2].
// Does not synchronise.
extern "C" int repro_gemm_f32(int bm, int bk, int bn, const void* a,
                              const void* b, const void* c, void* o, int m,
                              int n, int k, int batch, long long sAb,
                              long long lda, long long sBb, long long ldb,
                              long long sCb, long long ldc, long long sOb,
                              long long ldo, float alpha, float beta,
                              int has_c, void* stream, int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               m, n, k, batch, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, has_c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_GEMM_TILE(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN)                 \
    return int(launch<BM, BK, BN>(p, s, launched));
#define REPRO_GEMM_BK(BM, BN) \
  REPRO_GEMM_TILE(BM, 16, BN) REPRO_GEMM_TILE(BM, 32, BN) \
  REPRO_GEMM_TILE(BM, 64, BN)
  REPRO_GEMM_BK(64, 64) REPRO_GEMM_BK(64, 128) REPRO_GEMM_BK(64, 256)
  REPRO_GEMM_BK(128, 64) REPRO_GEMM_BK(128, 128) REPRO_GEMM_BK(128, 256)
  REPRO_GEMM_BK(256, 64) REPRO_GEMM_BK(256, 128) REPRO_GEMM_BK(256, 256)
#undef REPRO_GEMM_BK
#undef REPRO_GEMM_TILE
  return int(cudaErrorInvalidValue);
}
