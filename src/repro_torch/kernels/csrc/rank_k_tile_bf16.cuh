// What rank_k_bf16.cu (variants full and tri) and rank_k_packed_bf16.cu
// (variant tri_packed) share, the bfloat16 twin of rank_k_tile.cuh: the
// producer that feeds a rank-k tile to the wgmma mainloop
// (bf16_wgmma_mainloop.cuh: TMA into a ring of mbarrier-guarded stages,
// wgmma.mma_async with float32 accumulators), the one tile function both
// kernels run and the epilogue it stores with, so that tri_packed equals
// tri bit for bit, and the block orders of both grids.
//
// One block owns the BM x BM output tile whose rows are rows row0.. of A
// (the tile row i) and whose columns are rows col0.. of A (the tile column
// j):  acc[r][c] = sum over l of A[row0+r, l] * A[col0+c, l]  (syrk), or of
// A[row0+r, l] * B[col0+c, l] + B[row0+r, l] * A[col0+c, l]  (syr2k, under
// the runtime flag two), every product and sum float32 in the tensor cores.
//
// Layout.  The tile is wgemm::Tile<BM, BM, 64, true>: one pass, BM / 64
// warpgroups (m64nBMk16), BM / 2 accumulators a thread.  Both sides are rows
// of a row-major (n, k) matrix, so both are K-major: the i side is wgmma's
// A and the j side its B without the transpose flag (the tile's B_KMAJOR).
// A stage holds kStep = 64 contraction indices of both sides, BM rows of
// 128 bytes each swizzled over 128 bytes (TMA's SWIZZLE_128B), at every
// knob bk: TMA's work goes by rows, and a 16-deep stage would carry 32-byte
// rows.  So the knob's bk (16, 32, 64; the reference's bk = kb["bn"], kept
// because the knob space has it) sets nothing: the three instantiations of
// a bm compile the same kernel.  TMA reads the i side and the j side as
// boxes of 64 x BM from one tensor map per operand (2-D, or 3-D with the
// batch outermost); syrk reads both from A's map.  An operand TMA cannot
// take (the wrapper's `vec` false) is staged by the threads into the same
// swizzled layout (wgemm::stage_window: 2-byte loads, 16-byte shared
// stores, fence.proxy.async), so odd strides == aligned bit for bit.  Rows
// past n and indices past k read zero (TMA's fill, or the threads').
//
// syr2k runs as one contraction of length 2 kb, kb = ceil(k / 64) * 64:
// steps in [0, kb) stage (A rows i, B rows j), steps in [kb, 2 kb) stage
// (B rows i, A rows j), B's map swapped in for A's, so every A B^T product
// of an element comes before every B A^T one.  The half boundary sits on a
// step boundary, so a k padded with zeros adds only zero products at the
// end of each half and changes no bit (masked == padded).
//
// Epilogue.  value() computes alpha * acc + beta * C in float32 (C read
// only when has_c and, under tri and tri_packed, only on and below the
// diagonal: C is lower-stored there) and rounds it to bf16 once.  The
// mainloop returns with no wgmma and no TMA copy in flight; once every
// warpgroup is past it the rounded tile is parked in the idle ring,
// [BM][BM + 2] (an odd number of 4-byte words a row: the transposed reads
// of neighbouring rows hit distinct banks), and stored row by row, two
// elements a thread; under MIRROR (tri, tri_packed) the parked tile is
// then stored transposed to (j, i), neighbouring threads on neighbouring
// rows of the tile.  A diagonal tile takes its upper triangle from its own
// lower one.  Rounding is elementwise, so "round once, then mirror the
// rounded lower triangle" is the reference's cast after tril(out) +
// tril(out, -1)^T, and the output is symmetric bit for bit.
//
// Block order.  The grids stay (nb, nb, batch) and (nb (nb + 1) / 2, 1,
// batch), but a block's index is mapped to its tile so that the blocks in
// flight (2-4 an SM) cover a compact group of tile rows and columns, whose
// rows of A share the 50 MB L2 (worth about a tenth at bm = 128 against
// row-major order, nothing at 64): kGroup = 16 tile rows a group, walked
// column by column (grouped()); tri_packed walks bands of 16 tile rows,
// each band's rectangle left of its diagonal block column by column and
// then that block's lower triangle (packed()).  kernels/syrk.py::
// tile_of_block mirrors both maps.  Under tri the blocks whose tile lies
// above the diagonal (j > i) still return at once.
//
// Bound on an H100 SXM: syrk's BLAS count is n^2 k operations (one
// triangle; syr2k twice) at 989 TFLOP/s of dense bf16, against
// 2 (n k + n^2) bytes at 3.35 TB/s, so a call past k of a few hundred is
// bound by the operations.  full does twice the BLAS count, tri and
// tri_packed the BLAS count plus the diagonal tiles' upper halves.  Shared
// memory bounds a tile before the tensor cores do: a warpgroup's m64nBMk16
// reads (64 + BM) x 32 bytes of its stage in BM / 2 of the SM's
// tensor-core cycles (2,048 multiply-adds a cycle), and TMA writes the
// stage's bytes as well, against the SM's 128 bytes a cycle: at most half
// the tensor cores' rate at bm = 64 and four fifths at 128.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_wgmma_mainloop.cuh"
// REPRO_RANK_K_TILES, the tiles of both dtypes, and rank_k::tri_row
#include "rank_k_tile.cuh"

namespace brank_k {

using wgemm::bf16;
using wgemm::Where;

// contraction indices a stage holds, at every knob bk
constexpr int kStep = 64;
// tile rows of a group (a band) in the block order
constexpr int kGroup = 16;

struct Args {
  const bf16* A;
  const bf16* B;
  const bf16* C;
  bf16* O;
  int n, k;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int two, has_c;
  int tma, za, zb;  // TMA reads A (and B); their maps' batch coordinates
};

// The wgmma mainloop's BM x BM tile, both sides K-major, and the parked
// output tile of the epilogue: the launch parameters (kernels/syrk.py::
// rank_k_params(bm, bk, torch.bfloat16) mirrors them).  BK, the knob's
// contraction block, sets nothing.
template <int BM_, int BK_>
struct Tile : wgemm::Tile<BM_, BM_, kStep, true> {
  using Base = wgemm::Tile<BM_, BM_, kStep, true>;
  static constexpr int PARK_LD = BM_ + 2;
  static constexpr int PARK = 2 * BM_ * PARK_LD;
  static constexpr int SMEM = Base::SMEM > PARK ? Base::SMEM : PARK;
  static_assert(Base::PASSES == 1, "one pass a tile");
  static_assert(PARK <= Base::STAGES * Base::STAGE_BYTES,
                "the parked tile inside the ring, clear of its barriers");
};

// -- block order -------------------------------------------------------------

// block L of the nb x nb grid -> its tile (i, j): groups of kGroup tile
// rows (the last may hold fewer), each walked column by column
__host__ __device__ inline void grouped(long long L, int nb, int& i,
                                        int& j) {
  const int x = int(L / (static_cast<long long>(kGroup) * nb)) * kGroup;
  const int g = wgemm::cmin(kGroup, nb - x);
  const long long u = L - static_cast<long long>(x) * nb;
  i = x + int(u % g);
  j = int(u / g);
}

// block t of the nb (nb + 1) / 2 packed grid -> its tile (i, j), j <= i:
// bands of kGroup tile rows from x = kGroup * (row of t / kGroup; the row
// of t in the lower triangle's row-major order, rank_k::tri_row), each
// holding the band's g x x rectangle left of its diagonal block column by
// column, then that block's lower triangle column by column (column c of
// it holds g - c tiles)
__host__ __device__ inline void packed(long long t, int nb, int& i, int& j) {
  const int x = rank_k::tri_row(t) / kGroup * kGroup;
  const int g = wgemm::cmin(kGroup, nb - x);
  const long long u = t - static_cast<long long>(x) * (x + 1) / 2;
  if (u < static_cast<long long>(g) * x) {
    i = x + int(u % g);
    j = int(u / g);
    return;
  }
  int v = int(u - static_cast<long long>(g) * x), c = 0;
  while (v >= g - c) v -= g - c++;
  i = x + c + v;
  j = x + c;
}

// -- the producer ------------------------------------------------------------

// A step's stages: the 64 contraction indices from w.k0 of rows w.prow0..
// (the i side, wgmma's A) and of rows w.pcol0.. (the j side, its B), of A
// and B (syrk: B is A, mb is ma), swapped past kb (syr2k's second half).
template <class T>
struct Producer {
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int za, zb;
  const bf16* A;
  const bf16* B;
  long long lda, ldb;
  int n, k, kb;
  bool use_tma;
  __device__ int tma_bytes(Where) const {
    return use_tma ? T::A_BYTES + T::B_BYTES : 0;
  }
  __device__ void issue(uint32_t a, uint32_t b, uint32_t bar, Where w) const {
    const bool second = w.k0 >= kb;
    const int kk = second ? w.k0 - kb : w.k0;
    wgemm::tma_load(a, second ? mb : ma, bar, kk, w.prow0, second ? zb : za);
    wgemm::tma_load(b, second ? ma : mb, bar, kk, w.pcol0, second ? za : zb);
  }
  __device__ bool threads_write(Where) const { return !use_tma; }
  __device__ void write(unsigned char* a, unsigned char* b, Where w) const {
    const bool second = w.k0 >= kb;
    const int kk = second ? w.k0 - kb : w.k0;
    wgemm::stage_window<T::PM, kStep, T::THREADS>(
        a, second ? B : A, second ? ldb : lda, n, k, w.prow0, kk);
    wgemm::stage_window<T::PN, kStep, T::THREADS>(
        b, second ? A : B, second ? lda : ldb, n, k, w.pcol0, kk);
  }
  __device__ bool trans_a(Where) const { return false; }
};

// -- the epilogue ------------------------------------------------------------

// The output value at (gr, gc) inside the matrix, alpha * acc + beta * C in
// float32, rounded to bf16 once.  With lower_c (variants tri and
// tri_packed) C is read as lower-stored: its strict upper triangle counts
// as zero and is never read.  The variant full adds C as given.
__device__ __forceinline__ bf16 value(const Args& p,
                                      const bf16* __restrict__ C, float acc,
                                      int gr, int gc, bool lower_c) {
  float v = __fmul_rn(p.alpha, acc);
  if (p.has_c && (!lower_c || gr >= gc))
    v = __fmaf_rn(p.beta, __bfloat162float(C[gr * p.ldc + gc]), v);
  return __float2bfloat16_rn(v);
}

// two adjacent rounded outputs (the second when `two`), as one 4-byte store
// where the address allows
__device__ __forceinline__ void put2(bf16* o, bf16 v0, bf16 v1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(v0, v1);
  } else {
    o[0] = v0;
    if (two) o[1] = v1;
  }
}

// Parks the tile's rounded values in the idle ring and stores them at
// (row0, col0) and, under MIRROR (tri, tri_packed), transposed at
// (col0, row0); C is then read as lower-stored.
template <class T, bool MIRROR>
__device__ __forceinline__ void store(const Args& p, const bf16* C, bf16* O,
                                      const float (&acc)[T::ACC], int row0,
                                      int col0, unsigned char* ring) {
  constexpr int BM = T::BM, LD = T::PARK_LD, HALF = BM / 2;
  bf16* park = reinterpret_cast<bf16*>(ring);
  // every warpgroup's wgmma are done with the ring
  __syncthreads();
  wgemm::for_each_acc<T>(
      acc, row0, col0, p.n, p.n,
      [&](int gr, int gc, float v0, float v1, bool two) {
        bf16* at = park + (gr - row0) * LD + gc - col0;
        const bf16 b0 = value(p, C, v0, gr, gc, MIRROR);
        if (two)
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __halves2bfloat162(b0, value(p, C, v1, gr, gc + 1, MIRROR));
        else
          at[0] = b0;
      });
  __syncthreads();
  const int rows = wgemm::cmin(BM, p.n - row0);
  const int cols = wgemm::cmin(BM, p.n - col0);
  const bool diag = MIRROR && row0 == col0;
  // O[row0 + r, col0 + c .. c + 1], neighbouring threads on neighbouring
  // pairs of a row
  for (int idx = threadIdx.x; idx < BM * HALF; idx += T::THREADS) {
    const int r = idx / HALF, c = idx % HALF * 2;
    if (r >= rows || c >= cols) continue;
    auto at = [&](int cc) {
      return diag && r < cc ? park[cc * LD + r] : park[r * LD + cc];
    };
    put2(O + (row0 + r) * p.ldo + col0 + c, at(c), at(c + 1), c + 1 < cols);
  }
  if (MIRROR && !diag) {
    // O[col0 + c, row0 + r] = tile[r][c], neighbouring threads on
    // neighbouring r
    for (int idx = threadIdx.x; idx < BM * BM; idx += T::THREADS) {
      const int c = idx / BM, r = idx % BM;
      if (r < rows && c < cols)
        O[(col0 + c) * p.ldo + row0 + r] = park[r * LD + c];
    }
  }
}

// The tile (row0, col0) of batch item z: the wgmma mainloop over syrk's kb
// or syr2k's 2 kb contraction indices, then the epilogue (mirror: tri,
// tri_packed; the two epilogues are compiled in beside one mainloop).
template <class T>
__device__ __forceinline__ void tile(const CUtensorMap* ma,
                                     const CUtensorMap* mb, const Args& p,
                                     int z, int row0, int col0, bool mirror,
                                     unsigned char* smem_raw) {
  const wgemm::Ring<T> ring = wgemm::make_ring<T>(smem_raw);
  const bf16* A = p.A + z * p.sAb;
  const bf16* B = p.two ? p.B + z * p.sBb : A;
  const bf16* C = p.has_c ? p.C + z * p.sCb : nullptr;
  bf16* O = p.O + z * p.sOb;
  const int kb = (p.k + kStep - 1) / kStep * kStep;
  const int za = p.za < 0 ? -1 : z;
  const Producer<T> prod{ma, p.two ? mb : ma, za, p.two ? (p.zb < 0 ? -1 : z)
                                                        : za,
                         A, B, p.lda, p.two ? p.ldb : p.lda, p.n, p.k, kb,
                         bool(p.tma)};
  const wgemm::Steps<T> st =
      wgemm::block_steps<T>(row0, col0, p.n, p.n, 0, p.two ? 2 * kb : kb);
  wgemm::prime(ring, prod, st);
  float acc[T::ACC];
  wgemm::consume(ring, prod, st, 0, acc);
  if (mirror)
    store<T, true>(p, C, O, acc, row0, col0, ring.base);
  else
    store<T, false>(p, C, O, acc, row0, col0, ring.base);
}

// Whether TMA reads the operands (TMA reads both or neither: the thread
// path stages a step whole; no map for an empty contraction, which loads
// nothing), and their maps: boxes of 64 contraction indices x BM rows,
// swizzled over 128 bytes.  Returns 0 or a launcher error code.
template <class T>
int encode(Args& p, bool vec, int batch, CUtensorMap* ma, CUtensorMap* mb) {
  p.tma = p.k > 0 &&
          wgemm::tma_layout(vec, p.n, p.k, batch, p.lda, p.sAb) &&
          (!p.two || wgemm::tma_layout(vec, p.n, p.k, batch, p.ldb, p.sBb));
  p.za = p.zb = -1;
  if (!p.tma) return 0;
  const int rc = wgemm::encode_map(ma, &p.za, p.A, p.n, p.k, batch, p.lda,
                                   p.sAb, kStep, T::PM, T::SWIZZLE);
  if (rc != 0 || !p.two) return rc;
  return wgemm::encode_map(mb, &p.zb, p.B, p.n, p.k, batch, p.ldb, p.sBb,
                           kStep, T::PM, T::SWIZZLE);
}

// The launch parameters of a tile: threads, stages, dynamic shared bytes,
// passes, warpgroups, the swizzle bytes, the blocks an SM is meant to hold
// and the park's bytes (kernels/syrk.py::rank_k_params(bm, bk,
// torch.bfloat16) mirrors them).
template <int BM, int BK>
void config(int* out) {
  using T = Tile<BM, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES;
  out[4] = T::WARPGROUPS;
  out[5] = T::SWIZZLE;
  out[6] = T::BLOCKS;
  out[7] = T::PARK;
}

}  // namespace brank_k
