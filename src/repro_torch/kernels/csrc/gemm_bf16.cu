// GEMM for Hopper (sm_90a) in bfloat16: O = alpha * A @ B + beta * C with
// A, B, C and O bfloat16, every product and sum float32 on the tensor
// cores, and O rounded to bfloat16 once, at the store.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/gemm.py::_gemm_kernel / gemm_pallas (bf16 operands,
// a float32 VMEM accumulator, the output in A's dtype), with its
// leading-batch-axis transform (_batching.py::with_batch_axis) and its
// ragged-tail masks (gemm.py::mask_cols / mask_rows).  gemm.cu is its
// float32 twin: the same grid, split-k, masks, batch and shared B, on the
// bf16 mainloop (bf16_mainloop.cuh) in place of the float32 one.
//
// Layout.  One block computes one bm x bn tile of O over one slice of the
// contraction.  Grid x walks the n-tiles and then the slices, grid y the
// m-tiles, grid z the batch.  The k loop of a slice runs inside the block
// (bf16_mainloop.cuh: a cp.async ring, ldmatrix, mma.sync m16n8k16 with
// float32 accumulators, passes of 128 x 128 for the larger tiles).
//
// Split-k.  As gemm.cu: split_plan (kernels/gemm.py::split_plan, checked
// against the plan the wrapper sized its workspace for) cuts k into S
// slices of a length that is a multiple of 128; each slice writes its
// float32 partial tile to the call's workspace, and the last block of a
// tile to arrive (an atomic ticket per tile) adds the partials in slice
// order 0 .. S-1 in float32, applies alpha and beta and rounds to bf16
// once.  No sum is rounded to bf16 between slices (the reference's _flush
// rounds its float32 accumulator once).
//
// Ragged edges.  Loads past m, n or k read zero and stores past m or n are
// dropped, the semantics of the reference's masks.  A B with batch stride 0
// is one weight shared by every item of the stack.  C is read only when the
// caller passes has_c (beta != 0 and a C was given).
//
// Bound on an H100 SXM: 989 TFLOP/s of dense bf16 against 3.35 TB/s, so a
// GEMM with fewer than about 295 operations a byte is bound by its bytes:
// every decode product of a few rows, where split-k puts every SM to
// streaming B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mainloop.cuh"
#include "launch_grid.cuh"

namespace {

using bgemm::bf16;

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
  const bf16* A;
  const bf16* B;
  const bf16* C;
  bf16* O;
  float* ws;     // [batch][slices][m][n] float32 partial sums (slices > 1)
  int* tickets;  // [batch][m-tiles][n-tiles], zeroed here (slices > 1)
  int m, n, k, batch;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int has_c, vec, slices, slice_len;
};

template <int BM, int BK, int BN>
__global__ void __launch_bounds__(bgemm::Tile<BM, BN, BK>::THREADS, 1)
gemm_bf16_kernel(const Args p) {
  using T = bgemm::Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* smem = reinterpret_cast<bf16*>(smem_bytes);
  __shared__ int last;

  const int n_tiles = (p.n + BN - 1) / BN;
  const int tile_n = blockIdx.x % n_tiles;
  const int slice = blockIdx.x / n_tiles;
  const int row0 = blockIdx.y * BM;
  const int col0 = tile_n * BN;
  const long long z = blockIdx.z;
  const bf16* A = p.A + z * p.sAb;
  const bf16* B = p.B + z * p.sBb;
  const bf16* C = p.has_c ? p.C + z * p.sCb : p.C;
  bf16* O = p.O + z * p.sOb;
  const int kbeg = slice * p.slice_len;
  const int kend = min(p.k, kbeg + p.slice_len);
  // this item's partial sums, [slices][m][n]
  const long long plane = (long long)p.m * p.n;
  float* ws = p.slices == 1 ? nullptr : p.ws + z * p.slices * plane;

  auto finish = [&](int r, int c, float acc) {
    float v = p.alpha * acc;
    if (p.has_c) v += p.beta * __bfloat162float(C[r * p.ldc + c]);
    O[r * p.ldo + c] = __float2bfloat16_rn(v);
  };

#pragma unroll 1
  for (int pm = 0; pm < T::PASSES_M; ++pm) {
#pragma unroll 1
    for (int pn = 0; pn < T::PASSES_N; ++pn) {
      const int prow0 = row0 + pm * T::PM, pcol0 = col0 + pn * T::PN;
      if (prow0 >= p.m || pcol0 >= p.n) continue;  // uniform in the block
      const bgemm::GemmProducer<T> prod{A, B, p.lda, p.ldb, p.m, p.n, p.k,
                                        prow0, pcol0, bool(p.vec)};
      float acc[T::MT][T::NT][4];
      bgemm::mainloop<T>(smem, prod, kbeg, kend,
                         bgemm::live_tiles<T>(prow0, p.m), acc);
      if (p.slices == 1) {
        bgemm::for_each_acc<T>(acc, prow0, pcol0, p.m, p.n, finish);
      } else {
        float* part = ws + slice * plane;
        bgemm::for_each_acc<T>(acc, prow0, pcol0, p.m, p.n,
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
  using T = bgemm::Tile<BM, BN, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
  out[4] = T::WARPS_M;
  out[5] = T::WARPS_N;
}

template <int BM, int BK, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  using T = bgemm::Tile<BM, BN, BK>;
  int slices, len;
  split_plan(p.m, p.n, p.k, BM, BN, &slices, &len);
  if (slices != p.slices || len != p.slice_len) return cudaErrorInvalidValue;
  // shared memory above 48 KB only as opted-in dynamic shared memory, set
  // before every launch (cheap; a process may use more than one card)
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_bf16_kernel<BM, BK, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(p.n, BN) * slices, cdiv(p.m, BM), p.batch);
  if (slices > 1) {
    const cudaError_t z = cudaMemsetAsync(
        p.tickets, 0, sizeof(int) * size_t(grid.y) * cdiv(p.n, BN) * p.batch,
        stream);
    if (z != cudaSuccess) return z;
  }
  set_grid(launched, grid);
  gemm_bf16_kernel<BM, BK, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// the tiles of gemm.cu's REPRO_GEMM_TILES, every one tensor-core
// compatible (bm, bn in 64, 128, 256; bk in 16, 32, 64)
#define REPRO_GEMM_BF16_TILES(X)                                       \
  X(64, 16, 64) X(64, 32, 64) X(64, 64, 64) X(64, 16, 128)             \
  X(64, 32, 128) X(64, 64, 128) X(64, 16, 256) X(64, 32, 256)          \
  X(64, 64, 256) X(128, 16, 64) X(128, 32, 64) X(128, 64, 64)          \
  X(128, 16, 128) X(128, 32, 128) X(128, 64, 128) X(128, 16, 256)      \
  X(128, 32, 256) X(128, 64, 256) X(256, 16, 64) X(256, 32, 64)        \
  X(256, 64, 64) X(256, 16, 128) X(256, 32, 128) X(256, 64, 128)       \
  X(256, 16, 256) X(256, 32, 256) X(256, 64, 256)

// One launcher for every instantiated tile, with repro_gemm_f32's
// arguments (A, B, C and O bf16; the workspace float32).  Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for a
// tile with no instantiation or a split other than split_plan's.  Writes
// the grid it launched (x, y, z) to launched[0..2].  Does not synchronise.
// vec says that A, B, their leading strides and batch strides are 16-byte
// aligned.
extern "C" int repro_gemm_bf16(int bm, int bk, int bn, const void* a,
                               const void* b, const void* c, void* o,
                               void* ws, void* tickets, int m, int n, int k,
                               int batch, long long sAb, long long lda,
                               long long sBb, long long ldb, long long sCb,
                               long long ldc, long long sOb, long long ldo,
                               float alpha, float beta, int has_c, int vec,
                               int slices, int slice_len, void* stream,
                               void* ev_start, void* ev_end, int* launched) {
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
               static_cast<const bf16*>(c), static_cast<bf16*>(o),
               static_cast<float*>(ws), static_cast<int*>(tickets),
               m, n, k, batch, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, has_c, vec, slices, slice_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_GEMM_BF16_LAUNCH(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN)    \
    return int(launch<BM, BK, BN>(p, s, launched));
  REPRO_GEMM_BF16_TILES(REPRO_GEMM_BF16_LAUNCH)
#undef REPRO_GEMM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes and the warp grid (m, n), to
// out[0..5].
extern "C" int repro_gemm_bf16_config(int bm, int bk, int bn, int* out) {
#define REPRO_GEMM_BF16_CONFIG(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN) return config<BM, BK, BN>(out), 0;
  REPRO_GEMM_BF16_TILES(REPRO_GEMM_BF16_CONFIG)
#undef REPRO_GEMM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}

// split_plan as the launcher computes it: slices and slice length to
// out[0..1].
extern "C" int repro_gemm_bf16_split(int m, int n, int k, int bm, int bn,
                                     int* out) {
  split_plan(m, n, k, bm, bn, &out[0], &out[1]);
  return 0;
}
