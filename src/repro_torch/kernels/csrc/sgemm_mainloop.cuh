// The float32 mainloop shared by gemm.cu, symm.cu, the trmm kernels
// (trmm.cu, trmm_packed.cu), the rank-k kernels (rank_k.cu,
// rank_k_packed.cu) and trsm.cu: one block computes its BM x BN tile of
// accumulators over a range of the contraction, in IEEE fmaf on the CUDA
// cores.  What feeds the A tile is a template parameter (a "producer"), so
// the GEMM stages a row-major A (GemmProducer, below; trsm's two steps
// too), symm stitches sym(A) from the stored triangle and trmm
// stages tril(A) with a per-row column limit; B is row-major in all
// three.  The rank-k tile (rank_k_tile.cuh, a Tile with B_ROWS) stages its
// B side as rows too, [PN][BK + 4] with the contraction innermost, and runs
// fma_nt in place of fma_rows.
//
// Pipeline.  Every contraction step of BK stages one A and one B tile in a
// ring of STAGES buffers in shared memory, filled with cp.async: while the
// FMAs run on step s, steps s + 1 .. s + STAGES - 1 are in flight, and one
// __syncthreads per step both publishes a step and frees the buffer of the
// step before.  When every pointer and leading stride of A and B is 16-byte
// aligned (the wrapper's `vec` flag) a copy moves 4 floats
// (cp.async.cg, 16 bytes); otherwise each float is its own 4-byte copy
// (cp.async.ca).  Both write the same values to the same places, and past
// an edge both zero-fill through the copy's src-size (0 bytes read), so
// interior tiles take no branch and ragged tiles are masked as the
// reference's mask_cols / mask_rows.
//
// Registers.  A pass of at most 128 x 128 outputs runs on 128-256 threads,
// each holding a TM x 8 register tile (TM = 4 or 8): rows ty * TM + i,
// columns tx * 4 + j * 4 * TX + e.  Per 4 contraction indices a thread reads
// its A rows as 16-byte shared loads (4 consecutive k of one row; the eight
// threads of a quarter warp share ty, so the reads broadcast) and per index
// its B row as 16-byte loads (a quarter warp reads 128 consecutive bytes),
// 12 or 16 LDS.128 per 128 or 256 FMAs (fma_nt: the same count, its B
// loads along k).  A tile beyond 128 x 128 accumulators (the whole register
// file at 256 x 256) runs as passes of 128 x 128, one after the other in the
// same block.  A thread whose rows all lie past m skips the FMAs (the
// decode grids of a few rows).
//
// Order.  Whatever the path (aligned or not), the layout of a step (symm
// reads a tile above the diagonal transposed) or the pass, each output
// element adds its products in increasing k with fmaf, starting from +0.

#pragma once

#include <cuda_runtime.h>

namespace sgemm {

// shared memory a block may use on an H100, and the budget of one ring, so
// that two blocks of a tile fit on an SM where the tile allows
constexpr int kSmemMax = 232448;
constexpr int kRingBudget = kSmemMax / 2;
// the accumulators of one pass
constexpr int kMaxPass = 128 * 128;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// the stages of a ring: as many of 4, 3 as fit in kRingBudget, else 2
__host__ __device__ constexpr int ring_stages(int stage_bytes) {
  return 4 * stage_bytes <= kRingBudget   ? 4
         : 3 * stage_bytes <= kRingBudget ? 3
                                          : 2;
}

// The launch parameters of a BM x BN tile with contraction step BK, all
// derived from the tile (kernels/gemm.py::mainloop_params mirrors them).
template <int BM_, int BN_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr bool kOnePass = BM * BN <= kMaxPass;
  static constexpr int PM = kOnePass ? BM : cmin(BM, 128);
  static constexpr int PN = kOnePass ? BN : cmin(BN, 128);
  static constexpr int PASSES_M = BM / PM, PASSES_N = BN / PN;
  static constexpr int THREADS = cmin(256, cmax(128, PM * PN / 64));
  static constexpr int TN = 8;
  static constexpr int TM = PM * PN / THREADS / TN;
  static constexpr int TX = PN / TN, TY = PM / TM;
  static constexpr int A_FLOATS = PM * BK;
  static constexpr int STAGE_FLOATS = BK * (PM + PN);
  static constexpr int STAGE_BYTES = 4 * STAGE_FLOATS;
  static constexpr int STAGES = ring_stages(STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  // B staged [BK][PN] (k-major); a tile that stages it as rows says so
  static constexpr bool B_ROWS = false;
  static_assert(TX * TY == THREADS, "thread grid covers the pass");
  static_assert(TM == 4 || TM == 8, "4 x 8 or 8 x 8 register tiles");
  static_assert(SMEM <= kSmemMax, "227 KB of shared memory per block");
  static_assert(BK % 4 == 0 && 128 % BK == 0, "steps tile 128");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bytes < 16 read that many bytes and zero-fill the rest
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages the R x C window starting at (i0, j0) of the row-major matrix p
// (leading stride ld, rows x cols stored) into s, row-major with stride LD
// (C unless padded); elements past rows or cols read zero.  With LOWER, row
// gi is stored in its columns 0 .. gi only (the lower triangle of a square
// matrix): its columns past gi read zero too, and no copy reads them.  p is
// a safe address for the zero-byte copies.
template <int R, int C, int THREADS, bool LOWER = false, int LD = C>
__device__ __forceinline__ void load_tile(float* s, const float* p,
                                          long long ld, int rows, int cols,
                                          int i0, int j0, bool vec) {
  constexpr int CH = C / 4;
  static_assert((R * CH) % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < R * CH / THREADS; ++it) {
    const int t = threadIdx.x + it * THREADS;
    const int i = t / CH, jc = (t % CH) * 4;
    const int gi = i0 + i, gj = j0 + jc;
    // the end of row gi's stored columns
    const int lim = LOWER ? cmin(cols, gi + 1) : cols;
    float* d = s + i * LD + jc;
    const float* row = p + gi * ld;
    if (vec) {
      const int nv = gi < rows ? cmin(cmax(lim - gj, 0), 4) : 0;
      cp_async16(d, nv ? row + gj : p, 4 * nv);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gi < rows && gj + e < lim;
        cp_async4(d + e, ok ? row + gj + e : p, ok ? 4 : 0);
      }
    }
  }
}

// The row-major producer: the PM x BK window of A at (prow0, k0) and the
// BK x PN window of B at (k0, pcol0), A (m, k) and B (k, n) both row-major
// with leading strides lda and ldb, zero past their edges.
template <class T>
struct GemmProducer {
  const float* A;
  const float* B;
  long long lda, ldb;
  int m, n, k, prow0, pcol0;
  bool vec;
  __device__ void load(float* As, float* Bs, int k0) const {
    load_tile<T::PM, T::BK, T::THREADS>(As, A, lda, m, k, prow0, k0, vec);
    load_tile<T::BK, T::PN, T::THREADS>(Bs, B, ldb, k, n, k0, pcol0, vec);
  }
  __device__ bool transposed(int) const { return false; }
};

// B rows of one contraction index: the thread's 8 columns
template <class T>
__device__ __forceinline__ void load_b(const float* Bs, int tx,
                                       float (&b)[T::TN]) {
#pragma unroll
  for (int j = 0; j < T::TN / 4; ++j) {
    const float4 v =
        *reinterpret_cast<const float4*>(Bs + tx * 4 + j * 4 * T::TX);
    b[4 * j] = v.x;
    b[4 * j + 1] = v.y;
    b[4 * j + 2] = v.z;
    b[4 * j + 3] = v.w;
  }
}

// One step's FMAs, A staged row-major [PM][BK]
template <class T>
__device__ __forceinline__ void fma_rows(const float* As, const float* Bs,
                                         int ty, int tx,
                                         float (&acc)[T::TM][T::TN]) {
#pragma unroll 4
  for (int kq = 0; kq < T::BK / 4; ++kq) {
    float a[T::TM][4];
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + (ty * T::TM + i) * T::BK + kq * 4);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b[T::TN];
      load_b<T>(Bs + (kq * 4 + e) * T::PN, tx, b);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(a[i][e], b[j], acc[i][j]);
    }
  }
}

// One step's FMAs, A staged transposed [BK][PM]
template <class T>
__device__ __forceinline__ void fma_cols(const float* As, const float* Bs,
                                         int ty, int tx,
                                         float (&acc)[T::TM][T::TN]) {
#pragma unroll 8
  for (int kk = 0; kk < T::BK; ++kk) {
    float a[T::TM];
#pragma unroll
    for (int q = 0; q < T::TM / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + kk * T::PM + ty * T::TM + 4 * q);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
    float b[T::TN];
    load_b<T>(Bs + kk * T::PN, tx, b);
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// One step's FMAs, A staged [PM][BK] and B staged as rows [PN][T::LDB]
// (T::B_ROWS): both operands with the contraction innermost, so both are
// read as 16-byte loads of 4 consecutive k.  Thread tx owns the columns
// tx + j * TX; with a row stride of BK + 4 floats the 8 rows a quarter warp
// reads start 4 banks apart (BK = 32, 64) or 20 (BK = 16), so its 128
// bytes fall in 32 distinct banks.  Per element the products still add in
// increasing k.
template <class T>
__device__ __forceinline__ void fma_nt(const float* As, const float* Bs,
                                       int ty, int tx,
                                       float (&acc)[T::TM][T::TN]) {
#pragma unroll 4
  for (int kq = 0; kq < T::BK / 4; ++kq) {
    float a[T::TM][4];
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          As + (ty * T::TM + i) * T::BK + kq * 4);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(
          Bs + (tx + j * T::TX) * T::LDB + kq * 4);
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        acc[i][j] = fmaf(a[i][0], b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i][1], b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i][2], b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i][3], b.w, acc[i][j]);
      }
    }
  }
}

// The accumulators of one pass over the contraction [kbeg, kend).  The
// producer P supplies
//   void load(float* As, float* Bs, int k0)  issue the copies of step k0;
//   bool transposed(int k0)                  its A layout ([BK][PM] if true;
//                                            not asked under T::B_ROWS).
// `live` is false for a thread whose rows all lie past the output (it
// skips the FMAs, never a barrier).  Leaves the ring idle on return.
template <class T, class P>
__device__ __forceinline__ void mainloop(float* smem, const P& prod,
                                         int kbeg, int kend, bool live,
                                         float (&acc)[T::TM][T::TN]) {
  const int ty = threadIdx.x / T::TX, tx = threadIdx.x % T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  const int steps = kend > kbeg ? (kend - kbeg + T::BK - 1) / T::BK : 0;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < steps) {
      float* st = smem + s * T::STAGE_FLOATS;
      prod.load(st, st + T::A_FLOATS, kbeg + s * T::BK);
    }
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int nx = s + T::STAGES - 1;
    if (nx < steps) {
      float* st = smem + (nx % T::STAGES) * T::STAGE_FLOATS;
      prod.load(st, st + T::A_FLOATS, kbeg + nx * T::BK);
    }
    cp_async_commit();
    if (live) {
      const float* st = smem + (s % T::STAGES) * T::STAGE_FLOATS;
      if constexpr (T::B_ROWS)
        fma_nt<T>(st, st + T::A_FLOATS, ty, tx, acc);
      else if (prod.transposed(kbeg + s * T::BK))
        fma_cols<T>(st, st + T::A_FLOATS, ty, tx, acc);
      else
        fma_rows<T>(st, st + T::A_FLOATS, ty, tx, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Calls f(r, c, v) for every accumulator of a pass whose output element
// (prow0 + r, pcol0 + c) lies inside m x n.
template <class T, class F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[T::TM][T::TN],
                                             int prow0, int pcol0, int m,
                                             int n, F f) {
  const int ty = threadIdx.x / T::TX, tx = threadIdx.x % T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = prow0 + ty * T::TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int c = pcol0 + tx * 4 + (j / 4) * 4 * T::TX + j % 4;
      if (c < n) f(r, c, acc[i][j]);
    }
  }
}

// whether any row of this thread in a pass starting at prow0 lies inside m
template <class T>
__device__ __forceinline__ bool live_rows(int prow0, int m) {
  return prow0 + (int(threadIdx.x) / T::TX) * T::TM < m;
}

}  // namespace sgemm
