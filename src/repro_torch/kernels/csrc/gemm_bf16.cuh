// GEMM for Hopper (sm_90a) in bfloat16: O = alpha * A @ B + beta * C with
// A, B, C and O bfloat16, every product and sum float32 on the tensor
// cores, and O rounded to bfloat16 once, at the store.  The kernel, its
// split plan and its launcher; gemm_bf16.cu instantiates the tiles of bn
// 64 and 128 and gemm_bf16_n256.cu those of bn 256, two sources that nvcc
// builds side by side (kernels/gemm.py::bf16_source picks one).
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/gemm.py::_gemm_kernel / gemm_pallas (bf16 operands,
// a float32 VMEM accumulator, the output in A's dtype), with its
// leading-batch-axis transform (_batching.py::with_batch_axis) and its
// ragged-tail masks (gemm.py::mask_cols / mask_rows).  gemm.cu is its
// float32 twin: the same grid, split-k, masks, batch and shared B, on the
// wgmma mainloop (bf16_wgmma_mainloop.cuh) in place of the float32 one.
//
// Layout.  One block computes one bm x bn tile of O over one slice of the
// contraction.  Grid x walks the n-tiles and then the slices, grid y the
// m-tiles, grid z the batch.  The k loop of a slice runs inside the block
// (bf16_wgmma_mainloop.cuh: TMA copies issued by elected lanes into a ring
// of mbarrier-guarded stages, one or two warpgroups' wgmma with float32
// accumulators, passes of 128 rows for bm = 256, of 128 columns too for
// 256 x 256).  The launcher
// encodes A's and B's tensor maps (cuTensorMapEncodeTiled through the
// runtime's driver entry point) and passes them as __grid_constant__
// parameters; an operand TMA cannot read (the wrapper's `vec` false, or
// rows or items that overlap) is staged by the threads instead.
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
// Ragged edges.  Loads past m, n or k read zero (TMA's fill, or the
// threads') and stores past m or n are dropped, the semantics of the
// reference's masks.  A B with batch stride 0 is one weight shared by
// every item of the stack (a 2-D map).  C is read only when the caller
// passes has_c (beta != 0 and a C was given).
//
// Bound on an H100 SXM: 989 TFLOP/s of dense bf16 against 3.35 TB/s, so a
// GEMM with fewer than about 295 operations a byte is bound by its bytes:
// every decode product of a few rows, where split-k puts every SM to
// streaming B.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_wgmma_mainloop.cuh"
#include "launch_grid.cuh"

namespace gemm_bf16 {

using wgemm::bf16;

constexpr int kSms = 132;
constexpr int kSplitAlign = 128;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// kernels/gemm.py::split_plan: (slices, slice length)
inline void split_plan(int m, int n, int k, int bm, int bn, int* slices,
                       int* len) {
  const int tiles = cdiv(m, bm) * cdiv(n, bn);
  const int l = kSplitAlign * wgemm::cmax(2, cdiv(8 * tiles, kSms));
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
  int has_c, slices, slice_len;
  int tma, za, zb;  // TMA reads A and B; their maps' batch coordinates
  int a_rows;       // the rows of A's box
};

template <int BM, int BK, int BN>
__global__ void __launch_bounds__(wgemm::Tile<BM, BN, BK>::THREADS,
                                  wgemm::Tile<BM, BN, BK>::BLOCKS)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap mb, const Args p) {
  using T = wgemm::Tile<BM, BN, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int last;
  const wgemm::Ring<T> ring = wgemm::make_ring<T>(smem_raw);

  const int n_tiles = (p.n + BN - 1) / BN;
  const int tile_n = blockIdx.x % n_tiles;
  const int slice = blockIdx.x / n_tiles;
  const int row0 = blockIdx.y * BM;
  const int col0 = tile_n * BN;
  const int z = blockIdx.z;
  const bf16* A = p.A + z * p.sAb;
  const bf16* B = p.B + z * p.sBb;
  const bf16* C = p.has_c ? p.C + z * p.sCb : p.C;
  bf16* O = p.O + z * p.sOb;
  const int kbeg = slice * p.slice_len;
  const int kend = min(p.k, kbeg + p.slice_len);
  // this item's partial sums, [slices][m][n]
  const long long plane = (long long)p.m * p.n;
  float* ws = p.slices == 1 ? nullptr : p.ws + z * p.slices * plane;

  // alpha * acc + beta * C in float32, for output element (r, c)
  auto value = [&](int r, int c, float acc) {
    float v = p.alpha * acc;
    if (p.has_c) v += p.beta * __bfloat162float(C[r * p.ldc + c]);
    return v;
  };

  const wgemm::GemmProducer<T> prod{&ma, &mb, p.za < 0 ? -1 : z,
                                    p.zb < 0 ? -1 : z, A, B, p.lda, p.ldb,
                                    p.m, p.n, p.k, p.a_rows, bool(p.tma)};
  const wgemm::Steps<T> st =
      wgemm::block_steps<T>(row0, col0, p.m, p.n, kbeg, kend);
  wgemm::prime(ring, prod, st);
#pragma unroll 1
  for (int pass = 0; pass < st.passes; ++pass) {
    const wgemm::Where o = st.origin(pass);
    float acc[T::ACC];
    wgemm::consume(ring, prod, st, pass, acc);
    if (p.slices == 1) {
      wgemm::for_each_acc<T>(
          acc, o.prow0, o.pcol0, p.m, p.n,
          [&](int r, int c, float v0, float v1, bool two) {
            wgemm::store2(O + r * p.ldo + c, value(r, c, v0),
                          two ? value(r, c + 1, v1) : 0.f, two);
          });
    } else {
      float* part = ws + slice * plane;
      wgemm::for_each_acc<T>(
          acc, o.prow0, o.pcol0, p.m, p.n,
          [&](int r, int c, float v0, float v1, bool two) {
            float* at = part + r * (long long)p.n + c;
            if (two && (reinterpret_cast<uintptr_t>(at) & 7) == 0) {
              *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
            } else {
              at[0] = v0;
              if (two) at[1] = v1;
            }
          });
    }
  }
  if (p.slices == 1) return;

  // the last slice of this tile to arrive sums the partials in slice order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + ((long long)z * gridDim.y + blockIdx.y) *
                                  n_tiles + tile_n;
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
    O[r * p.ldo + c] = __float2bfloat16_rn(value(r, c, v));
  }
}

template <int BM, int BK, int BN>
void config(int* out) {
  using T = wgemm::Tile<BM, BN, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES;
  out[4] = T::WARPGROUPS;
  out[5] = T::SWIZZLE;
}

template <int BM, int BK, int BN>
int launch(Args p, bool vec, cudaStream_t stream, int* launched) {
  using T = wgemm::Tile<BM, BN, BK>;
  int slices, len;
  split_plan(p.m, p.n, p.k, BM, BN, &slices, &len);
  if (slices != p.slices || len != p.slice_len) return cudaErrorInvalidValue;
  // TMA reads both operands or neither (the thread path stages a step
  // whole); no map for an empty contraction, which loads nothing
  CUtensorMap ma{}, mb{};
  p.tma = p.k > 0 &&
          wgemm::tma_layout(vec, p.m, p.k, p.batch, p.lda, p.sAb) &&
          wgemm::tma_layout(vec, p.k, p.n, p.batch, p.ldb, p.sBb);
  p.za = p.zb = -1;
  // a box of fewer rows than the pass where m is smaller (a decode's few
  // rows): TMA's work goes by rows, and rows past m meet only dropped
  // outputs
  p.a_rows = wgemm::cmin(T::PM, (p.m + 7) / 8 * 8);
  if (p.tma) {
    int rc = wgemm::encode_map(&ma, &p.za, p.A, p.m, p.k, p.batch, p.lda,
                               p.sAb, BK, p.a_rows, T::SWIZZLE);
    if (rc == 0)
      rc = wgemm::encode_map(&mb, &p.zb, p.B, p.k, p.n, p.batch, p.ldb,
                             p.sBb, wgemm::kSlab, BK, 128);
    if (rc != 0) return rc;
  }
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
  gemm_bf16_kernel<BM, BK, BN><<<grid, T::THREADS, T::SMEM, stream>>>(ma, mb,
                                                                       p);
  return cudaGetLastError();
}

}  // namespace gemm_bf16
