// The bfloat16 mainloop on the tensor cores with mma.sync, beside the
// float32 one (sgemm_mainloop.cuh): one block computes its BM x BN tile of
// float32 accumulators over a range of the contraction from bfloat16 A and
// B, with mma.sync m16n8k16 (bf16 in, f32 accumulate).  trsm_bf16.cu's
// substitution is its last user (gemm_bf16.cu, symm_bf16.cu, the rank-k
// and the trmm kernels run the wgmma loop, bf16_wgmma_mainloop.cuh); what
// feeds the tiles is a producer, as in the float32 loop.
//
// Replaces, with the float32 loop, the reference package's Pallas dot
// src/repro/kernels/gemm.py::_gemm_kernel (jnp.dot(...,
// preferred_element_type=jnp.float32) into a float32 VMEM accumulator): the
// bf16 operands meet in the tensor cores and every sum is float32.
//
// Pipeline.  Every contraction step of BK stages one A tile [PM][BK] and
// one B tile [BK][PN] in a ring of STAGES buffers in shared memory, both
// row-major as they are stored in device memory, each row padded by 8
// elements (16 bytes): the eight 16-byte rows an ldmatrix phase reads then
// fall in distinct banks (row strides of 48, 80 and 144 bytes for A, 144,
// 272 and 528 for B).  When every pointer, leading stride and batch stride
// of A and B is 16-byte aligned (the wrapper's `vec` flag) a copy is one
// cp.async.cg of 8 elements (16 bytes), zero-filled past an edge through
// its src-size.  cp.async takes 4, 8 or 16 bytes and a bf16 operand with
// an odd stride or pointer has no such alignment, so otherwise a thread
// reads the same 8 elements with 2-byte loads (zero past an edge) and
// writes them with one 16-byte shared store: the same values in the same
// places, so both paths give the same bits.  One __syncthreads a step
// publishes the step and frees the buffer of the step before, as in the
// float32 loop.
//
// Tensor cores.  A pass of at most 128 x 128 accumulators runs on 128 or
// 256 threads (4 or 8 warps, the float32 loop's thread counts), each warp
// a 32 x 32, 32 x 64 or 64 x 32 tile of m16n8 mma tiles.  Per 16
// contraction indices a warp loads its A fragments with ldmatrix.x4 (one
// per m16 tile) and its B fragments with ldmatrix.x4.trans (one per two n8
// tiles: B is stored (k, n) row-major and mma's B operand is k-major), and
// issues MT x NT mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  A tile
// beyond 128 x 128 runs its passes one after the other in the same block.
// A warp skips the m16 tiles whose rows all lie past m (the decode grids
// of a few rows).  A producer may stage a step's A tile transposed, as
// the (k, m) window it is stored in, [BK][PM + 8]: that step loads its A
// fragments with ldmatrix.x4.trans, which hands each lane the same
// elements as ldmatrix.x4 of the row-major tile, so a step's products do
// not depend on its layout.
//
// Order.  The sums inside one mma are the tensor core's own, not IEEE
// sequential; across mma they add in increasing k.  Whatever the copy path
// and wherever a tile lies in the grid, an output element sees the same
// inputs in the same mma, so unaligned == aligned, stacked == per-item and
// masked == zero-padded hold bit for bit.
//
// Bound on an H100 SXM: 989 TFLOP/s of dense bf16 against 3.35 TB/s, so a
// product with fewer than about 295 operations a byte (every decode GEMM
// and the thin prefill ones) is bound by its bytes.  mma.sync reaches only
// a part of the tensor cores' rate; bf16_wgmma_mainloop.cuh is the wgmma
// and TMA loop these kernels may move to.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sgemm_mainloop.cuh"

namespace bgemm {

using bf16 = __nv_bfloat16;
using sgemm::cmax;
using sgemm::cmin;

// elements a shared row is padded by
constexpr int kPad = 8;

// The launch parameters of a BM x BN tile with contraction step BK, all
// derived from the tile (kernels/gemm.py::mainloop_params with
// dtype=torch.bfloat16 mirrors them).
template <int BM_, int BN_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr bool kOnePass = BM * BN <= sgemm::kMaxPass;
  static constexpr int PM = kOnePass ? BM : cmin(BM, 128);
  static constexpr int PN = kOnePass ? BN : cmin(BN, 128);
  static constexpr int PASSES_M = BM / PM, PASSES_N = BN / PN;
  static constexpr int THREADS = cmin(256, cmax(128, PM * PN / 64));
  static constexpr int WARPS = THREADS / 32;
  static constexpr int WARPS_N = PN >= 128 && WARPS == 8 ? 4 : 2;
  static constexpr int WARPS_M = WARPS / WARPS_N;
  // a warp's tile, and its m16 and n8 mma tiles
  static constexpr int WM = PM / WARPS_M, WN = PN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // shared row strides in elements (LDAT: an A tile staged transposed)
  static constexpr int LDA = BK + kPad, LDB = PN + kPad, LDAT = PM + kPad;
  // room for either A layout; PM >= BK, so the row-major one is the larger
  static constexpr int A_ELEMS = cmax(PM * LDA, BK * LDAT);
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int STAGE_BYTES = 2 * STAGE_ELEMS;
  static constexpr int STAGES = sgemm::ring_stages(STAGE_BYTES);
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(WARPS_M * WARPS_N == WARPS, "warp grid covers the pass");
  static_assert(MT >= 1 && NT % 2 == 0, "m16 tiles, pairs of n8 tiles");
  static_assert(BK % 16 == 0 && 128 % BK == 0, "k16 steps that tile 128");
  static_assert(A_ELEMS % 8 == 0 && STAGE_BYTES % 16 == 0,
                "16-byte aligned B tiles and stages");
  static_assert(SMEM <= sgemm::kSmemMax, "227 KB of shared memory per block");
};

// bytes < 16 read that many bytes and zero-fill the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sgemm::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// Stages the R x C window starting at (i0, j0) of the row-major bf16
// matrix p (leading stride ld, rows x cols stored) into s, row-major with
// stride LD, in chunks of 8 elements; elements past rows or cols read zero.
// p is a safe address for the zero-byte copies.
template <int R, int C, int THREADS, int LD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* p,
                                          long long ld, int rows, int cols,
                                          int i0, int j0, bool vec) {
  constexpr int CH = C / 8;
  constexpr int N = R * CH;
#pragma unroll
  for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
    const int t = threadIdx.x + it * THREADS;
    if (N % THREADS != 0 && t >= N) break;
    const int i = t / CH, jc = (t % CH) * 8;
    const int gi = i0 + i, gj = j0 + jc;
    bf16* d = s + i * LD + jc;
    const bf16* row = p + gi * ld;
    if (vec) {
      const int nv = gi < rows ? cmin(cmax(cols - gj, 0), 8) : 0;
      cp_async16(d, nv ? row + gj : p, 2 * nv);
    } else {
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(row + gj);
      unsigned v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = gi < rows && gj + e < cols ? __ldg(src + e) : 0u;
      *reinterpret_cast<uint4*>(d) =
          make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                     v[6] | v[7] << 16);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sgemm::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sgemm::smem_addr(p)));
}

// d += a @ b on one m16n8k16 tile, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One step's products.  The warp's tile starts at (wm0, wn0) of the pass;
// `live` of its MT m16 tiles hold a row inside m.  ldmatrix.x4 of A: lane
// l addresses row l % 16 at k offset (l / 16) * 8, the four 8 x 8 matrices
// of mma's A fragment in its register order (rows 0-7 and 8-15 at k 0-7,
// then at k 8-15).  A_T, A staged [BK][LDAT]: ldmatrix.x4.trans, lane l
// addressing k row (l % 8) + (l / 16) * 8 at row offset ((l / 8) % 2) * 8,
// the same four matrices, each transposed into place.  ldmatrix.x4.trans
// of B: lane l addresses k row (l % 8) + ((l / 8) % 2) * 8 at column
// (l / 16) * 8, the (k0-7, k8-15) halves of two n8 tiles.
template <class T, bool A_T>
__device__ __forceinline__ void mma_step(const bf16* As, const bf16* Bs,
                                         int wm0, int wn0, int live,
                                         float (&acc)[T::MT][T::NT][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 16) {
    unsigned b[T::NT][2];
#pragma unroll
    for (int np = 0; np < T::NT / 2; ++np) {
      unsigned r[4];
      ldsm_x4_trans(r, Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * T::LDB +
                           wn0 + np * 16 + (lane / 16) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      if (mt >= live) break;  // uniform in the warp
      unsigned a[4];
      if (A_T)
        ldsm_x4_trans(a, As + (kk + lane % 8 + (lane / 16) * 8) * T::LDAT +
                             wm0 + mt * 16 + ((lane / 8) % 2) * 8);
      else
        ldsm_x4(a, As + (wm0 + mt * 16 + lane % 16) * T::LDA + kk +
                       (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
        mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

// the warp's first row and column in a pass
template <class T>
__device__ __forceinline__ int warp_row0() {
  return (int(threadIdx.x) / 32 / T::WARPS_N) * T::WM;
}
template <class T>
__device__ __forceinline__ int warp_col0() {
  return (int(threadIdx.x) / 32 % T::WARPS_N) * T::WN;
}

// the warp's m16 tiles of a pass starting at prow0 with a row inside m
template <class T>
__device__ __forceinline__ int live_tiles(int prow0, int m) {
  const int rows = m - (prow0 + warp_row0<T>());
  return rows <= 0 ? 0 : cmin(T::MT, (rows + 15) / 16);
}

// The accumulators of one pass over the contraction [kbeg, kend).  The
// producer P supplies
//   void load(bf16* As, bf16* Bs, int k0)  issue the copies of step k0,
//                                          A as [PM][LDA] (or [BK][LDAT]),
//                                          B as [BK][LDB];
//   bool transposed(int k0)                its A layout ([BK][LDAT] if
//                                          true; a constant false folds
//                                          the transposed step away).
// A producer may also fill a stage with plain shared stores: the
// cp_async_wait and __syncthreads that publish a step's copies publish
// them too.  `live` is live_tiles (a warp with none skips the products,
// never a barrier).  Leaves the ring idle on return.
template <class T, class P>
__device__ __forceinline__ void mainloop(bf16* smem, const P& prod, int kbeg,
                                         int kend, int live,
                                         float (&acc)[T::MT][T::NT][4]) {
  const int wm0 = warp_row0<T>(), wn0 = warp_col0<T>();
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int steps = kend > kbeg ? (kend - kbeg + T::BK - 1) / T::BK : 0;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < steps) {
      bf16* st = smem + s * T::STAGE_ELEMS;
      prod.load(st, st + T::A_ELEMS, kbeg + s * T::BK);
    }
    sgemm::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    sgemm::cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int nx = s + T::STAGES - 1;
    if (nx < steps) {
      bf16* st = smem + (nx % T::STAGES) * T::STAGE_ELEMS;
      prod.load(st, st + T::A_ELEMS, kbeg + nx * T::BK);
    }
    sgemm::cp_async_commit();
    if (live > 0) {
      const bf16* st = smem + (s % T::STAGES) * T::STAGE_ELEMS;
      if (prod.transposed(kbeg + s * T::BK))
        mma_step<T, true>(st, st + T::A_ELEMS, wm0, wn0, live, acc);
      else
        mma_step<T, false>(st, st + T::A_ELEMS, wm0, wn0, live, acc);
    }
  }
  sgemm::cp_async_wait<0>();
  __syncthreads();
}

// Calls f(r, c, v) for every accumulator of a pass whose output element
// (prow0 + r, pcol0 + c) lies inside m x n.  mma's accumulator layout:
// lane l holds rows l / 4 and l / 4 + 8 of an m16n8 tile, columns
// (l % 4) * 2 and the one after.
template <class T, class F>
__device__ __forceinline__ void for_each_acc(
    const float (&acc)[T::MT][T::NT][4], int prow0, int pcol0, int m, int n,
    F f) {
  const int lane = threadIdx.x % 32;
  const int r0 = prow0 + warp_row0<T>() + lane / 4;
  const int c0 = pcol0 + warp_col0<T>() + (lane % 4) * 2;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mt * 16 + h * 8;
      if (r >= m) continue;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + nt * 8 + e;
          if (c < n) f(r, c, acc[mt][nt][2 * h + e]);
        }
    }
}

}  // namespace bgemm
