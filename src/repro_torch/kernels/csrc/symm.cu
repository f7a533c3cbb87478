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
// A[r, c] when r >= c and A[c, r] otherwise.
//
// Layout.  As in gemm.cu, on the same mainloop (sgemm_mainloop.cuh): one
// block computes one bm x bn tile of O; grid x walks the n-tiles, grid y the
// m-tiles, grid z the batch.  The contraction runs inside the block over m
// itself in steps of BK = 64 (a launch parameter derived from the tile,
// core/knobs.py HOPPER_CONTRACTION_STEP).  The A producer stages each step
// by where its sym(A) tile lies:
//   - wholly on or below the diagonal: the stored tile (rows, k), row-major,
//     as the GEMM stages A;
//   - wholly above it: the stored tile (k, rows), which is the transpose of
//     the step's tile, copied as it is stored and read transposed by the
//     FMAs ([BK][PM]; the choice is per step and per block, never per
//     thread);
//   - across it (the bm / 64 + 1 steps at most that hold diagonal elements):
//     one 4-byte copy per element from wherever that element is stored.
// Each output element adds its products in order of the contraction index,
// so a stacked call equals its per-item calls bit for bit.  No split-k: the
// symm calls of the main path have 1,792 output tiles or more.
//
// Ragged edges.  The contraction dimension is m, so the ragged tail masks
// the sym(A) columns and the B rows alike: loads past m or n read zero,
// stores past m or n are dropped (the reference's mask_cols / mask_rows).
// C is read only when the caller passes has_c (beta != 0 and a C given).
//
// Bound on an H100 SXM: 2 m^2 n operations at 67 TFLOP/s in float32
// against 4 (m^2 + 2 m n) bytes at 3.35 TB/s, so every SYMM past m of a few
// dozen is bound by the operations.

#include <cuda_runtime.h>

#include "launch_grid.cuh"
#include "sgemm_mainloop.cuh"

namespace {

constexpr int BK = 64;

struct Args {
  const float* A;
  const float* B;
  const float* C;
  float* O;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int has_c, vec;
};

template <class T>
struct SymmProducer {
  const float* A;
  const float* B;
  long long lda, ldb;
  int m, n, prow0, pcol0;
  bool vec;
  __device__ bool transposed(int k0) const { return k0 >= prow0 + T::PM; }
  __device__ void load(float* As, float* Bs, int k0) const {
    if (transposed(k0)) {
      // every element a mirror: sym(A)[r, k] = A[k, r], staged [BK][PM]
      sgemm::load_tile<T::BK, T::PM, T::THREADS>(As, A, lda, m, m, k0, prow0,
                                                 vec);
    } else if (k0 + T::BK <= prow0 + 1) {
      // every element stored: sym(A)[r, k] = A[r, k], staged [PM][BK]
      sgemm::load_tile<T::PM, T::BK, T::THREADS>(As, A, lda, m, m, prow0, k0,
                                                 vec);
    } else {
      constexpr int PER = T::PM * T::BK / T::THREADS;
#pragma unroll 8
      for (int it = 0; it < PER; ++it) {
        const int t = threadIdx.x + it * T::THREADS;
        const int r = t / T::BK, kk = t % T::BK;
        const int gr = prow0 + r, gk = k0 + kk;
        const bool ok = gr < m && gk < m;
        const float* src = gr >= gk ? A + gr * lda + gk : A + gk * lda + gr;
        sgemm::cp_async4(As + t, ok ? src : A, ok ? 4 : 0);
      }
    }
    sgemm::load_tile<T::BK, T::PN, T::THREADS>(Bs, B, ldb, m, n, k0, pcol0,
                                               vec);
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(sgemm::Tile<BM, BN, BK>::THREADS)
symm_kernel(const Args p) {
  using T = sgemm::Tile<BM, BN, BK>;
  extern __shared__ __align__(16) float smem[];

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sAb;
  const float* B = p.B + z * p.sBb;
  const float* C = p.has_c ? p.C + z * p.sCb : p.C;
  float* O = p.O + z * p.sOb;

#pragma unroll 1
  for (int pm = 0; pm < T::PASSES_M; ++pm) {
#pragma unroll 1
    for (int pn = 0; pn < T::PASSES_N; ++pn) {
      const int prow0 = row0 + pm * T::PM, pcol0 = col0 + pn * T::PN;
      if (prow0 >= p.m || pcol0 >= p.n) continue;  // uniform in the block
      const SymmProducer<T> prod{A, B, p.lda, p.ldb, p.m, p.n,
                                 prow0, pcol0, bool(p.vec)};
      float acc[T::TM][T::TN];
      sgemm::mainloop<T>(smem, prod, 0, p.m,
                         sgemm::live_rows<T>(prow0, p.m), acc);
      sgemm::for_each_acc<T>(acc, prow0, pcol0, p.m, p.n,
                             [&](int r, int c, float v) {
                               float o = p.alpha * v;
                               if (p.has_c) o += p.beta * C[r * p.ldc + c];
                               O[r * p.ldo + c] = o;
                             });
    }
  }
}

template <int BM, int BN>
void config(int* out) {
  using T = sgemm::Tile<BM, BN, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
}

template <int BM, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  using T = sgemm::Tile<BM, BN, BK>;
  const cudaError_t e = cudaFuncSetAttribute(
      symm_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  symm_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_SYMM_TILES(X)                                          \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)

// One launcher for every instantiated output tile (the Hopper symm knob
// space).  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a tile with no instantiation.  Writes the grid
// it launched (x, y, z) to launched[0..2].  Does not synchronise.  vec says
// that A, B, their leading strides and batch strides are 16-byte aligned.
extern "C" int repro_symm_f32(int bm, int bn, const void* a, const void* b,
                              const void* c, void* o, int m, int n, int batch,
                              long long sAb, long long lda, long long sBb,
                              long long ldb, long long sCb, long long ldc,
                              long long sOb, long long ldo, float alpha,
                              float beta, int has_c, int vec, void* stream,
                              int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               m, n, batch, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, has_c, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SYMM_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, s, launched));
  REPRO_SYMM_TILES(REPRO_SYMM_LAUNCH)
#undef REPRO_SYMM_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes and passes, to out[0..3].
extern "C" int repro_symm_f32_config(int bm, int bn, int* out) {
#define REPRO_SYMM_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return config<BM, BN>(out), 0;
  REPRO_SYMM_TILES(REPRO_SYMM_CONFIG)
#undef REPRO_SYMM_CONFIG
  return int(cudaErrorInvalidValue);
}
