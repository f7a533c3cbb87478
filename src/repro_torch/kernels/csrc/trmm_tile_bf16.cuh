// What trmm_bf16.cu (variants full and tri) and trmm_packed_bf16.cu
// (variant tri_packed) share, the bfloat16 twin of trmm_tile.cuh: the
// producer that feeds tril(A) and B to the wgmma mainloop
// (bf16_wgmma_mainloop.cuh: TMA into a ring of mbarrier-guarded stages,
// wgmma.mma_async with float32 accumulators), the step plan that ends each
// pass where its rows' stored columns do, the one function both kernels
// run and the block order of both grids.  Every variant computes and
// stores its output tiles with this code and the same contraction ends, so
// tri_packed equals tri bit for bit.
//
// Tile.  wgemm::Tile<BM, BN, 64>, the tile symm compiles for the same
// eight (bm, bn): one or two warpgroups, passes of at most 128 x 128 (a bm
// of 256 runs two passes of 128 rows), __launch_bounds__(THREADS, BLOCKS)
// and the ring sized from BLOCKS.  A stage holds A's PM x 64 window
// K-major (rows of 128 bytes, 128-byte swizzle) and B's 64 x PN window as
// it lies (slabs of 64 columns, read with wgmma's transpose flag): the
// GEMM's layouts, since tril(A) is (rows, k) and B (k, n) as stored.
//
// Producer.  Row r of tril(A) is stored in its columns 0 .. r.  A step of
// the pass of rows prow0 .. prow0 + PM - 1 at contraction index k0 (both
// multiples of 64) lies, as a whole, on one side of the diagonal or across
// it, so the choice is made per step and per block, never per thread (a
// branch around wgmma that ptxas cannot prove uniform makes it serialise
// every wgmma):
//   - below it (k0 + 64 <= prow0 + 1): every element stored; TMA boxes of
//     64 x 64, as symm stages A there;
//   - across it (prow0 <= k0 < prow0 + PM: PM / 64 steps a pass): TMA
//     copies the boxes, and after the step's `full` barrier the threads
//     zero what lies above the diagonal in the swizzled stage (kCrossByTma;
//     else the threads write the step from the stored triangle), then
//     fence.proxy.async and the barrier consume() runs: the reference's
//     _tril_block on a loaded block;
//   - above it (k0 >= prow0 + PM; full only): A is zero.  A TMA box wholly
//     past A's last column, which TMA fills with zeros and which reads no
//     memory (kAboveByTma; else zeros written by the threads).  B's rows
//     are still multiplied: the reference's uniform pipeline, so a
//     non-finite B propagates as it does there.
// B is copied by TMA in every step, boxes wholly past n not at all (what
// they would hold meets only outputs past n).  Whatever A holds above its
// diagonal reaches no wgmma, so NaN there changes no bit.  An operand TMA
// cannot take (the wrapper's `vec` false) has every stage written by the
// threads in the same layout, A through the same row limit (stage_tril),
// so odd strides == aligned holds bit for bit.
//
// Steps.  The contraction of a pass ends at m under full and at
// min(prow0 + PM, m) under tri, the end of its rows' stored columns, so the
// passes of one block end at different steps (TrmmSteps; gemm, symm and
// rank-k run wgemm::Steps, the same steps every pass).  A tri_packed block
// computes the tiles of row blocks p and nb - 1 - p as one sequence of
// passes through one ring: the second tile's first copies overlap the
// first tile's last products and its epilogue.  kernels/trmm.py::step_plan
// mirrors the plan.
//
// Epilogue: each output element stored as bf16(__fmul_rn(alpha, acc)),
// rounded once, as the plain version's alpha * (tril(A) @ B) in float32
// then cast; rows past m and columns past n are dropped.
//
// Block order.  The grids stay (n-tiles, nb, batch) for full and tri and
// (n-tiles, ceil(nb / 2), batch) for tri_packed, but a block's linear index
// is mapped to its tile by groups of kGroup column tiles, each walked row
// by row with its columns fastest, the longest rows first (grouped()).
// The blocks in flight then share the B columns of their group in L2
// instead of streaming B (117 MB at the preconditioner's big call, against
// the card's 50 MB of L2) once a wave of row blocks; tril(A)'s 16.8 MB is
// re-read from L2.  On an H100 SXM at that call (scripts/
// torch_trmm_bf16_variants.py) groups of 16 read 3-6 % faster than the
// grid's row-by-row order under tri at the 128-row tiles and 3 % slower
// under full at 64x64: the tiles are bound by L2 and shared memory more
// than by HBM.  kernels/trmm.py::tile_of_block mirrors the map.
//
// Bound on an H100 SXM: m^2 n operations (the BLAS count) at 989 TFLOP/s
// of dense bf16 against 2 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so a TRMM
// past m of a few hundred is bound by the operations.  tri does the BLAS
// count plus the diagonal blocks' upper halves, full about twice it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_wgmma_mainloop.cuh"

namespace btrmm {

using wgemm::bf16;
using wgemm::cmin;
using wgemm::kSlab;
using wgemm::Where;

// the contraction step (core/knobs.py HOPPER_CONTRACTION_STEP)
constexpr int BK = 64;
// column tiles of a group in the block order (kernels/trmm.py BLOCK_GROUP)
constexpr int kGroup = 16;
// a step across the diagonal: TMA's boxes, then the threads zero the part
// above it (true), or the threads write it from the stored triangle
constexpr bool kCrossByTma = true;
// a step above the diagonal (full): a TMA box past A's last column (true),
// or zeros written by the threads
constexpr bool kAboveByTma = true;

template <int BM, int BN>
using Tile = wgemm::Tile<BM, BN, BK>;

struct Args {
  const bf16* A;
  const bf16* B;
  bf16* O;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sOb, ldo;
  float alpha;
  int tma, za, zb;  // TMA reads A and B; their maps' batch coordinates
};

// -- the step plan -----------------------------------------------------------

// The passes of a block's tiles, the first at row0 and, for tri_packed, a
// second at row1 (< 0: none), each of PM rows at column col0, and their
// steps: up to m (full) or the end of the pass's rows (tri).
template <class T>
struct TrmmSteps {
  int row0, row1, col0, m, pm0, passes;
  bool tri;
  __device__ int prow(int pass) const {
    return pass < pm0 ? row0 + pass * T::PM : row1 + (pass - pm0) * T::PM;
  }
  __device__ int count(int pass) const {
    const int kend = tri ? cmin(prow(pass) + T::PM, m) : m;
    return (kend + BK - 1) / BK;
  }
  __device__ int first(int pass) const {
    int g = 0;
    for (int p = 0; p < pass; ++p) g += count(p);
    return g;
  }
  __device__ int total() const { return first(passes); }
  __device__ Where origin(int pass) const { return {prow(pass), col0, 0}; }
  __device__ Where at(int g) const {
    int pass = 0;
    for (int c = count(0); g >= c; c = count(++pass)) g -= c;
    return {prow(pass), col0, g * BK};
  }
};

// the passes of the tile at row0 that hold a row inside m
template <class T>
__device__ __forceinline__ int passes_of(int row0, int m) {
  return cmin(T::PASSES_M, (m - row0 + T::PM - 1) / T::PM);
}

template <class T>
__device__ __forceinline__ TrmmSteps<T> block_steps(int row0, int row1,
                                                    int col0, int m,
                                                    bool tri) {
  static_assert(T::PASSES_N == 1, "trmm's passes run down the rows");
  const int pm0 = passes_of<T>(row0, m);
  return {row0, row1, col0, m, pm0,
          pm0 + (row1 < 0 ? 0 : passes_of<T>(row1, m)), tri};
}

// -- the producer ------------------------------------------------------------

template <class T>
struct TrmmProducer {
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int za, zb;
  const bf16* A;
  const bf16* B;
  long long lda, ldb;
  int m, n;
  bool use_tma;
  // every element stored: tril(A)[r, k] = A[r, k]
  __device__ static bool below(Where w) { return w.k0 + BK <= w.prow0 + 1; }
  // every element zero
  __device__ static bool above(Where w) { return w.k0 >= w.prow0 + T::PM; }
  __device__ static bool cross(Where w) { return !above(w) && !below(w); }
  // whether TMA stages A (under use_tma)
  __device__ static bool a_by_tma(Where w) {
    return above(w) ? kAboveByTma : cross(w) ? kCrossByTma : true;
  }
  __device__ int a_boxes(Where w) const {
    return wgemm::boxes_inside(m, w.prow0, kSlab, T::PM / kSlab);
  }
  __device__ int b_boxes(Where w) const {
    return wgemm::boxes_inside(n, w.pcol0, kSlab, T::PN / kSlab);
  }
  __device__ int tma_bytes(Where w) const {
    if (!use_tma) return 0;
    return (a_by_tma(w) ? a_boxes(w) * kSlab * BK * 2 : 0) +
           b_boxes(w) * T::SLAB_BYTES;
  }
  __device__ void issue(uint32_t a, uint32_t b, uint32_t bar, Where w) const {
    if (a_by_tma(w)) {
      // rows 64 j .. 64 j + 63 of the step, K-major (8 KB a box); above the
      // diagonal from column m on, wholly past A's edge: zeros
      const int k = above(w) ? m : w.k0;
      const int na = a_boxes(w);
      for (int j = 0; j < na; ++j)
        wgemm::tma_load(a + j * kSlab * BK * 2, ma, bar, k,
                        w.prow0 + j * kSlab, za);
    }
    const int nb = b_boxes(w);
    for (int j = 0; j < nb; ++j)
      wgemm::tma_load(b + j * T::SLAB_BYTES, mb, bar, w.pcol0 + j * kSlab,
                      w.k0, zb);
  }
  __device__ bool threads_write(Where w) const {
    return !use_tma || cross(w) || !a_by_tma(w);
  }
  // A's PM x 64 window at (prow0, k0) through row r's limit min(m, r + 1),
  // zero past it: no element above the diagonal is read
  __device__ void stage_tril(unsigned char* a, Where w) const {
    constexpr int CH = BK / 8, N = T::PM * CH;
#pragma unroll 1
    for (int t = threadIdx.x; t < N; t += T::THREADS) {
      const int i = t / CH, j = (t % CH) * 8;
      const int gi = w.prow0 + i, gj = w.k0 + j;
      const int lim = gi < m ? gi + 1 : 0;  // row gi's stored columns
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(A + gi * lda + gj);
      unsigned v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gj + e < lim ? __ldg(src + e) : 0u;
      wgemm::put8<2 * BK>(a, i, j / 8, wgemm::pack8(v));
    }
  }
  // zeroes the elements of TMA's window that lie above the diagonal: each
  // 16-byte chunk wholly above it, and the tail of the one it crosses
  __device__ void zero_upper(unsigned char* a, Where w) const {
    constexpr int CH = BK / 8, N = T::PM * CH;
#pragma unroll 1
    for (int t = threadIdx.x; t < N; t += T::THREADS) {
      const int i = t / CH, c = t % CH;
      const int keep = w.prow0 + i - (w.k0 + 8 * c) + 1;  // elements kept
      if (keep >= 8) continue;
      const int off = i * 2 * BK + c * 16;
      unsigned char* chunk = a + (off ^ (((off >> 7) & 7) << 4));
      if (keep <= 0) {
        *reinterpret_cast<uint4*>(chunk) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        unsigned short* h = reinterpret_cast<unsigned short*>(chunk);
        for (int e = keep; e < 8; ++e) h[e] = 0;
      }
    }
  }
  __device__ void write(unsigned char* a, unsigned char* b, Where w) const {
    if (!use_tma || !a_by_tma(w))
      stage_tril(a, w);
    else
      zero_upper(a, w);
    if (!use_tma)
      wgemm::stage_window<BK, T::PN, T::THREADS>(b, B, ldb, m, n, w.k0,
                                                 w.pcol0);
  }
  __device__ bool trans_a(Where) const { return false; }
};

// -- block order -------------------------------------------------------------

// block L of a grid of nx column tiles by ny rows (row blocks; tri_packed:
// pairs of them) -> its column tile and its rank in the walk of its
// group: groups of kGroup column tiles (the last may hold fewer), each
// walked row by row, its columns fastest
__host__ __device__ inline void grouped(long long L, int nx, int ny,
                                        int& rank, int& col) {
  const int x0 = int(L / (static_cast<long long>(kGroup) * ny)) * kGroup;
  const int g = cmin(kGroup, nx - x0);
  const long long u = L - static_cast<long long>(x0) * ny;
  col = x0 + int(u % g);
  rank = int(u / g);
}

// -- the tiles of a block ----------------------------------------------------

// The tiles at (row0, col0) and, when row1 >= 0, (row1, col0) of batch
// item z, as one sequence of passes; tri ends each pass at its rows.
template <class T>
__device__ __forceinline__ void run(const CUtensorMap* ma,
                                    const CUtensorMap* mb, const Args& p,
                                    int z, int row0, int row1, int col0,
                                    bool tri, unsigned char* smem_raw) {
  const wgemm::Ring<T> ring = wgemm::make_ring<T>(smem_raw);
  const bf16* A = p.A + z * p.sAb;
  const bf16* B = p.B + z * p.sBb;
  bf16* O = p.O + z * p.sOb;
  const TrmmProducer<T> prod{ma, mb, p.za < 0 ? -1 : z, p.zb < 0 ? -1 : z,
                             A, B, p.lda, p.ldb, p.m, p.n, bool(p.tma)};
  const TrmmSteps<T> st = block_steps<T>(row0, row1, col0, p.m, tri);
  wgemm::prime(ring, prod, st);
#pragma unroll 1
  for (int pass = 0; pass < st.passes; ++pass) {
    const Where o = st.origin(pass);
    float acc[T::ACC];
    wgemm::consume(ring, prod, st, pass, acc);
    wgemm::for_each_acc<T>(
        acc, o.prow0, o.pcol0, p.m, p.n,
        [&](int r, int c, float v0, float v1, bool two) {
          wgemm::store2(O + r * p.ldo + c, __fmul_rn(p.alpha, v0),
                        __fmul_rn(p.alpha, v1), two);
        });
  }
}

// Whether TMA reads A and B, and their maps: A in boxes of 64 x 64, B in
// boxes of 64 columns x BK rows, both swizzled over 128 bytes.  Returns 0
// or a launcher error code.
inline int encode(Args& p, bool vec, CUtensorMap* ma, CUtensorMap* mb) {
  p.tma = wgemm::tma_layout(vec, p.m, p.m, p.batch, p.lda, p.sAb) &&
          wgemm::tma_layout(vec, p.m, p.n, p.batch, p.ldb, p.sBb);
  p.za = p.zb = -1;
  if (!p.tma) return 0;
  const int rc = wgemm::encode_map(ma, &p.za, p.A, p.m, p.m, p.batch, p.lda,
                                   p.sAb, kSlab, kSlab, 128);
  if (rc != 0) return rc;
  return wgemm::encode_map(mb, &p.zb, p.B, p.m, p.n, p.batch, p.ldb, p.sBb,
                           kSlab, BK, 128);
}

// The launch parameters of a tile: threads, stages, dynamic shared bytes,
// passes, warpgroups and A's swizzle bytes (kernels/gemm.py::
// mainloop_params(bm, 64, bn, torch.bfloat16) mirrors them).
template <int BM, int BN>
void config(int* out) {
  using T = Tile<BM, BN>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES;
  out[4] = T::WARPGROUPS;
  out[5] = T::SWIZZLE;
}

}  // namespace btrmm

// the output tiles of the Hopper trmm knob space (trmm_tile.cuh's
// REPRO_TRMM_TILES), instantiated by both bf16 kernels
#define REPRO_TRMM_BF16_TILES(X)                                     \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)
