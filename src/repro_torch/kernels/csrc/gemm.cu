// GEMM for Hopper (sm_90a): O = alpha * A @ B + beta * C, float32 in and
// out, float32 accumulator, in IEEE arithmetic on the CUDA cores.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/gemm.py::_gemm_kernel / gemm_pallas, together with its
// leading-batch-axis transform (_batching.py::with_batch_axis) and its
// ragged-tail masks (gemm.py::mask_cols / mask_rows).
//
// Layout.  One block computes one bm x bn tile of O over one slice of the
// contraction.  Grid x walks the n-tiles and then the slices, grid y the
// m-tiles, grid z the batch.  The k loop of a slice runs inside the block
// (sgemm_mainloop.cuh: a cp.async ring of 2-4 stages, 16-byte shared loads,
// 128-256 threads with 4 x 8 or 8 x 8 register tiles, passes of 128 x 128
// for the larger tiles) and replaces the reference's sequential
// ("arbitrary") grid axis.  A is staged row-major, as it is stored.
//
// Split-k.  A grid of fewer output tiles than the card's 132 SMs leaves
// SMs idle and has each block walk all of k alone: the decode GEMMs of a
// few rows.  split_plan (mirrored from kernels/gemm.py::split_plan, and
// checked against the plan the wrapper sized its workspace for) cuts k into
// S slices of length L, a multiple of 128 that depends only on the tile and
// the per-item tile count, so the batch never changes the split and padding
// k to a multiple of 128 never adds a slice or moves a boundary.  Each slice
// writes its partial tile to a workspace of the call's own; the last block
// of a tile to arrive (an atomic ticket per tile, zeroed on the stream
// before the launch, taken after a __threadfence) adds the partials in
// slice order 0 .. S-1, 8 loads in flight, and applies the epilogue: one
// kernel launch, no float atomics, the same bits on every run.
//
// Ragged edges.  Loads past m, n or k read zero and stores past m or n are
// dropped.  The masked zeros add nothing to the sums, the semantics of the
// reference's masks.  A B with batch stride 0 is one weight shared by every
// item of the stack.  C is read only when the caller passes has_c (beta != 0
// and a C was given), as the reference's has_c.
//
// Bound on an H100 SXM: float32 outside the tensor cores peaks at 67 TFLOP/s
// against 3.35 TB/s of HBM, so a GEMM with more than about 20 operations per
// byte moved is bound by the operations (the pipeline keeps the FMAs fed),
// and the decode-sized ones (a few rows) by the bytes (split-k puts every SM
// to streaming B).  A float32 wgmma would run in TF32, a different result,
// so float32 stays on the CUDA cores.

#include <cuda_runtime.h>

#include "launch_grid.cuh"
#include "sgemm_mainloop.cuh"

namespace {

constexpr int kSms = 132;
constexpr int kSplitAlign = 128;

int cdiv(int a, int b) { return (a + b - 1) / b; }

// kernels/gemm.py::split_plan: (slices, slice length)
void split_plan(int m, int n, int k, int bm, int bn, int* slices, int* len) {
  const int tiles = cdiv(m, bm) * cdiv(n, bn);
  const int l = kSplitAlign * sgemm::cmax(2, cdiv(8 * tiles, kSms));
  if (tiles >= kSms || k <= l) {
    *slices = 1;
    *len = k;
  } else {
    *slices = cdiv(k, l);
    *len = l;
  }
}

struct Args {
  const float* A;
  const float* B;
  const float* C;
  float* O;
  float* ws;     // [batch][slices][m][n] partial sums (slices > 1)
  int* tickets;  // [batch][m-tiles][n-tiles], zeroed here (slices > 1)
  int m, n, k, batch;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int has_c, vec, slices, slice_len;
};

template <int BM, int BK, int BN>
__global__ void __launch_bounds__(sgemm::Tile<BM, BN, BK>::THREADS)
gemm_kernel(const Args p) {
  using T = sgemm::Tile<BM, BN, BK>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;

  const int n_tiles = (p.n + BN - 1) / BN;
  const int tile_n = blockIdx.x % n_tiles;
  const int slice = blockIdx.x / n_tiles;
  const int row0 = blockIdx.y * BM;
  const int col0 = tile_n * BN;
  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sAb;
  const float* B = p.B + z * p.sBb;
  const float* C = p.has_c ? p.C + z * p.sCb : p.C;
  float* O = p.O + z * p.sOb;
  const int kbeg = slice * p.slice_len;
  const int kend = min(p.k, kbeg + p.slice_len);
  // this item's partial sums, [slices][m][n]
  const long long plane = (long long)p.m * p.n;
  float* ws = p.slices == 1 ? nullptr : p.ws + z * p.slices * plane;

  auto finish = [&](int r, int c, float acc) {
    float v = p.alpha * acc;
    if (p.has_c) v += p.beta * C[r * p.ldc + c];
    O[r * p.ldo + c] = v;
  };

#pragma unroll 1
  for (int pm = 0; pm < T::PASSES_M; ++pm) {
#pragma unroll 1
    for (int pn = 0; pn < T::PASSES_N; ++pn) {
      const int prow0 = row0 + pm * T::PM, pcol0 = col0 + pn * T::PN;
      if (prow0 >= p.m || pcol0 >= p.n) continue;  // uniform in the block
      const sgemm::GemmProducer<T> prod{A, B, p.lda, p.ldb, p.m, p.n, p.k,
                                        prow0, pcol0, bool(p.vec)};
      float acc[T::TM][T::TN];
      sgemm::mainloop<T>(smem, prod, kbeg, kend,
                         sgemm::live_rows<T>(prow0, p.m), acc);
      if (p.slices == 1) {
        sgemm::for_each_acc<T>(acc, prow0, pcol0, p.m, p.n, finish);
      } else {
        float* part = ws + slice * plane;
        sgemm::for_each_acc<T>(acc, prow0, pcol0, p.m, p.n,
                               [&](int r, int c, float v) {
                                 part[r * (long long)p.n + c] = v;
                               });
      }
    }
  }
  if (p.slices == 1) return;

  // the last slice of this tile to arrive sums the partials in slice order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + (z * gridDim.y + blockIdx.y) * n_tiles + tile_n;
    last = atomicAdd(ticket, 1) == p.slices - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(BM, p.m - row0);
  for (int idx = threadIdx.x; idx < rows * BN; idx += T::THREADS) {
    const int r = row0 + idx / BN, c = col0 + idx % BN;
    if (c >= p.n) continue;
    const float* at = ws + r * (long long)p.n + c;
    // the loads of 8 slices in flight at once, added in slice order
    float v = __ldcg(at);
    int s = 1;
    for (; s + 8 <= p.slices; s += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = __ldcg(at + (s + j) * plane);
#pragma unroll
      for (int j = 0; j < 8; ++j) v += x[j];
    }
    for (; s < p.slices; ++s) v += __ldcg(at + s * plane);
    finish(r, c, v);
  }
}

template <int BM, int BK, int BN>
void config(int* out) {
  using T = sgemm::Tile<BM, BN, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
}

template <int BM, int BK, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  using T = sgemm::Tile<BM, BN, BK>;
  int slices, len;
  split_plan(p.m, p.n, p.k, BM, BN, &slices, &len);
  if (slices != p.slices || len != p.slice_len) return cudaErrorInvalidValue;
  // dynamic and static shared memory above 48 KB only as opted-in dynamic
  // shared memory; the attribute belongs to the kernel and is set before
  // every launch because it is cheap and a process may use more than one
  // card
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<BM, BK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(p.n, BN) * slices, cdiv(p.m, BM), p.batch);
  if (slices > 1) {
    const cudaError_t z = cudaMemsetAsync(
        p.tickets, 0, sizeof(int) * size_t(grid.y) * cdiv(p.n, BN) * p.batch,
        stream);
    if (z != cudaSuccess) return z;
  }
  set_grid(launched, grid);
  gemm_kernel<BM, BK, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_GEMM_TILES(X)                                            \
  X(64, 16, 64) X(64, 32, 64) X(64, 64, 64) X(64, 16, 128)             \
  X(64, 32, 128) X(64, 64, 128) X(64, 16, 256) X(64, 32, 256)          \
  X(64, 64, 256) X(128, 16, 64) X(128, 32, 64) X(128, 64, 64)          \
  X(128, 16, 128) X(128, 32, 128) X(128, 64, 128) X(128, 16, 256)      \
  X(128, 32, 256) X(128, 64, 256) X(256, 16, 64) X(256, 32, 64)        \
  X(256, 64, 64) X(256, 16, 128) X(256, 32, 128) X(256, 64, 128)       \
  X(256, 16, 256) X(256, 32, 256) X(256, 64, 256)

// One launcher for every instantiated tile.  Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue for a tile with no
// instantiation or a split other than split_plan's.  Writes the grid it
// launched (x, y, z) to launched[0..2].  Does not synchronise.  vec says
// that A, B, their leading strides and batch strides are 16-byte aligned.
extern "C" int repro_gemm_f32(int bm, int bk, int bn, const void* a,
                              const void* b, const void* c, void* o, void* ws,
                              void* tickets, int m, int n, int k, int batch,
                              long long sAb, long long lda, long long sBb,
                              long long ldb, long long sCb, long long ldc,
                              long long sOb, long long ldo, float alpha,
                              float beta, int has_c, int vec, int slices,
                              int slice_len, void* stream, int* launched) {
  const Args p{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(o),
               static_cast<float*>(ws), static_cast<int*>(tickets),
               m, n, k, batch, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, has_c, vec, slices, slice_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_GEMM_LAUNCH(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN) \
    return int(launch<BM, BK, BN>(p, s, launched));
  REPRO_GEMM_TILES(REPRO_GEMM_LAUNCH)
#undef REPRO_GEMM_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes and passes, to out[0..3].
extern "C" int repro_gemm_f32_config(int bm, int bk, int bn, int* out) {
#define REPRO_GEMM_CONFIG(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN) return config<BM, BK, BN>(out), 0;
  REPRO_GEMM_TILES(REPRO_GEMM_CONFIG)
#undef REPRO_GEMM_CONFIG
  return int(cudaErrorInvalidValue);
}

// split_plan as the launcher computes it: slices and slice length to
// out[0..1].
extern "C" int repro_gemm_f32_split(int m, int n, int k, int bm, int bn,
                                    int* out) {
  split_plan(m, n, k, bm, bn, &out[0], &out[1]);
  return 0;
}
