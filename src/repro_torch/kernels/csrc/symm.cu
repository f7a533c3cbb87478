// SYMM for Hopper (sm_90a): O = alpha * sym(A) @ B + beta * C, with A
// stored in its lower triangle, float32 in and out, float32 accumulator, in
// IEEE arithmetic on the CUDA cores.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/symm.py::_symm_kernel / symm_pallas.  The TPU kernel
// loads two views of A per step, the tiles (i, l) and (l, i), and builds the
// symmetric tile from them: A[i,l] below the diagonal, A[l,i]^T above it,
// the diagonal tile mirrored from its own lower triangle.  Here every element
// of sym(A) is read from the one place it is stored: sym(A)[r, c] is
// A[r, c] when r >= c and A[c, r] otherwise.  A tile that lies wholly below
// the diagonal is read row by row (neighbouring threads on neighbouring
// columns), one wholly above it column by column (neighbouring threads on
// neighbouring rows, the mirror's rows), so both cases read coalesced; only
// tiles that cross the diagonal choose per element.
//
// Layout.  As in gemm.cu: one block computes one bm x bn tile of O; grid x
// walks the n-tiles, grid y the m-tiles, grid z the batch.  The contraction
// runs inside the block over m itself in steps of BK = 64 (a launch
// parameter derived from the tile, core/knobs.py HOPPER_CONTRACTION_STEP).
// Each step stages one sym(A) tile, transposed and padded by one float, and
// one B tile in shared memory; each of the bm * bn / 64 threads keeps an
// 8 x 8 tile of accumulators in registers and adds the products in order of
// the contraction index, so a stacked call equals its per-item calls bit
// for bit.
//
// Ragged edges.  The contraction dimension is m, so the ragged tail masks
// the sym(A) columns and the B rows alike: loads past m or n read zero,
// stores past m or n are dropped (the reference's mask_cols / mask_rows).
// C is read only when the caller passes has_c (beta != 0 and a C given).
//
// Bound on an H100 SXM: 2 m^2 n operations at 67 TFLOP/s in float32
// against 4 (m^2 + 2 m n) bytes at 3.35 TB/s, so every SYMM past m of a few
// dozen is bound by the operations.  This first design does nothing yet
// about that bound beyond the register tile: one shared-memory stage, no
// asynchronous copies, no overlap of loads with the FMAs.

#include <cuda_runtime.h>

#include "launch_grid.cuh"

namespace {

constexpr int BK = 64;

template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 64)
symm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ C, float* __restrict__ O, int m, int n,
            long long sAb, long long lda, long long sBb, long long ldb,
            long long sCb, long long ldc, long long sOb, long long ldo,
            float alpha, float beta, int has_c) {
  constexpr int TX = BN / 8;
  constexpr int TY = BM / 8;
  constexpr int THREADS = TX * TY;
  constexpr int LDS_A = BM + 1;

  extern __shared__ float smem[];
  float* As = smem;               // [BK][BM + 1]: the sym(A) tile, transposed
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

  for (int k0 = 0; k0 < m; k0 += BK) {
    if (k0 >= row0 + BM) {
      // wholly above the diagonal: every element is a mirror, A[gk, gr]
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int kk = idx / BM, r = idx % BM;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk * LDS_A + r] = (gr < m && gk < m) ? A[gk * lda + gr] : 0.f;
      }
    } else if (k0 + BK <= row0 + 1) {
      // wholly on or below the diagonal: every element is stored, A[gr, gk]
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int r = idx / BK, kk = idx % BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk * LDS_A + r] = (gr < m && gk < m) ? A[gr * lda + gk] : 0.f;
      }
    } else {
      for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int r = idx / BK, kk = idx % BK;
        const int gr = row0 + r, gk = k0 + kk;
        float v = 0.f;
        if (gr < m && gk < m)
          v = gr >= gk ? A[gr * lda + gk] : A[gk * lda + gr];
        As[kk * LDS_A + r] = v;
      }
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN, c = idx % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk * BN + c] = (gk < m && gc < n) ? B[gk * ldb + gc] : 0.f;
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
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int has_c;
};

template <int BM, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  constexpr int THREADS = BM * BN / 64;
  constexpr int SMEM = int(sizeof(float)) * BK * (BM + 1 + BN);
  static_assert(THREADS < 1024, "tiles of 1024 threads spill");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
  if (SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        symm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  symm_kernel<BM, BN><<<grid, THREADS, SMEM, stream>>>(
      p.A, p.B, p.C, p.O, p.m, p.n, p.sAb, p.lda, p.sBb, p.ldb, p.sCb, p.ldc,
      p.sOb, p.ldo, p.alpha, p.beta, p.has_c);
  return cudaGetLastError();
}

}  // namespace

// One launcher for every instantiated output tile (the Hopper symm knob
// space).  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a tile with no instantiation.  Writes the grid
// it launched (x, y, z) to launched[0..2].  Does not synchronise.
extern "C" int repro_symm_f32(int bm, int bn, const void* a, const void* b,
                              const void* c, void* o, int m, int n, int batch,
                              long long sAb, long long lda, long long sBb,
                              long long ldb, long long sCb, long long ldc,
                              long long sOb, long long ldo, float alpha,
                              float beta, int has_c, void* stream,
                              int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               m, n, batch, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, has_c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SYMM_TILE(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, s, launched));
  REPRO_SYMM_TILE(64, 64) REPRO_SYMM_TILE(64, 128) REPRO_SYMM_TILE(64, 256)
  REPRO_SYMM_TILE(128, 64) REPRO_SYMM_TILE(128, 128) REPRO_SYMM_TILE(128, 256)
  REPRO_SYMM_TILE(256, 64) REPRO_SYMM_TILE(256, 128)
#undef REPRO_SYMM_TILE
  return int(cudaErrorInvalidValue);
}
