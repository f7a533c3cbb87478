// SYMM for Hopper (sm_90a) in bfloat16: O = alpha * sym(A) @ B + beta * C,
// A stored in its lower triangle, A, B, C and O bfloat16, every product and
// sum float32 on the tensor cores, and O rounded to bfloat16 once, at the
// store.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/symm.py::_symm_kernel / symm_pallas (bf16 operands, a
// float32 VMEM accumulator, alpha * acc + beta * C in float32, the output
// in A's dtype).  symm.cu is its float32 twin: the same grid, masks, batch
// and stitching of sym(A), on the wgmma mainloop (bf16_wgmma_mainloop.cuh)
// in place of the float32 one.
//
// Layout.  One block computes one bm x bn tile of O; grid x walks the
// n-tiles, grid y the m-tiles, grid z the batch.  The contraction runs
// inside the block over m itself in steps of BK = 64 (core/knobs.py
// HOPPER_CONTRACTION_STEP): TMA copies issued by elected lanes into a ring
// of mbarrier-guarded stages, one or two warpgroups' wgmma.  Every
// element of sym(A) is read from the one place it is stored (sym(A)[r, c]
// = A[r, c] when r >= c, else A[c, r]), and a step's A tile is staged by
// where it lies (the choice is per step and per block, never per thread):
//   - wholly on or below the diagonal: the stored tile (rows, k), K-major,
//     by TMA boxes of 64 x 64 (128-byte swizzle), as the GEMM stages A;
//   - wholly above it: the stored tile (k, rows), which is the transpose of
//     the step's tile, as it lies, by boxes of 64 x 64 into slabs of 64
//     rows (MN-major), read with wgmma's transpose flag for A;
//   - across it (PM / 64 steps a pass): written by the block's threads,
//     K-major, each element by a 2-byte load from wherever it is stored,
//     after the step's barrier (which then guards B's copies alone).
// No TMA box covers an element above the diagonal, so NaN there changes
// no bit.  An operand TMA cannot read (the wrapper's `vec` false) has
// every one of its stages written by the threads in the same layout as
// the copies'.  Every path puts the same values into the same wgmma, so an
// output element sees the same products in the same order whatever the
// copy path and wherever its tile lies: stacked == per-item, odd strides
// == aligned and masked == zero-padded hold bit for bit.  No split-k, as
// in float32: the symm calls of the main path have 1,792 output tiles or
// more.
//
// Ragged edges.  The contraction dimension is m, so the ragged tail masks
// the sym(A) columns and the B rows alike: loads past m or n read zero,
// stores past m or n are dropped (the reference's mask_cols / mask_rows).
// C is read only when the caller passes has_c (beta != 0 and a C given),
// widened to float32: O = bf16(alpha * acc + beta * C), each product and
// the sum rounded in float32 as the plain version's.
//
// Bound on an H100 SXM: 2 m^2 n operations at 989 TFLOP/s of dense bf16
// against 2 (m^2 / 2 + 2 m n) bytes at 3.35 TB/s, so a SYMM past m of a
// few hundred is bound by the operations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_wgmma_mainloop.cuh"
#include "launch_grid.cuh"

namespace {

using wgemm::bf16;
using wgemm::kSlab;
using wgemm::Where;

constexpr int BK = 64;

struct Args {
  const bf16* A;
  const bf16* B;
  const bf16* C;
  bf16* O;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int has_c;
  int tma, za, zb;  // TMA reads A and B; their maps' batch coordinates
};

template <class T>
struct SymmProducer {
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int za, zb;
  const bf16* A;
  const bf16* B;
  long long lda, ldb;
  int m, n;
  bool use_tma;
  // every element a mirror: sym(A)[r, k] = A[k, r]
  __device__ static bool above(Where w) { return w.k0 >= w.prow0 + T::PM; }
  // every element stored: sym(A)[r, k] = A[r, k]
  __device__ static bool below(Where w) { return w.k0 + BK <= w.prow0 + 1; }
  __device__ static bool cross(Where w) { return !above(w) && !below(w); }
  __device__ int a_boxes(Where w) const {
    return wgemm::boxes_inside(m, w.prow0, kSlab, T::PM / kSlab);
  }
  __device__ int b_boxes(Where w) const {
    return wgemm::boxes_inside(n, w.pcol0, kSlab, T::PN / kSlab);
  }
  __device__ int tma_bytes(Where w) const {
    if (!use_tma) return 0;
    return (cross(w) ? 0 : a_boxes(w) * kSlab * BK * 2) +
           b_boxes(w) * T::SLAB_BYTES;
  }
  __device__ void issue(uint32_t a, uint32_t b, uint32_t bar, Where w) const {
    if (!cross(w)) {
      const bool up = above(w);
      const int na = a_boxes(w);
      // rows 64 j .. 64 j + 63 of the step: K-major rows (8 KB a box) or
      // an MN-major slab (8 KB)
      for (int j = 0; j < na; ++j)
        wgemm::tma_load(a + j * kSlab * BK * 2, ma, bar,
                        up ? w.prow0 + j * kSlab : w.k0,
                        up ? w.k0 : w.prow0 + j * kSlab, za);
    }
    const int nb = b_boxes(w);
    for (int j = 0; j < nb; ++j)
      wgemm::tma_load(b + j * T::SLAB_BYTES, mb, bar, w.pcol0 + j * kSlab,
                      w.k0, zb);
  }
  __device__ bool threads_write(Where w) const {
    return !use_tma || cross(w);
  }
  __device__ void write(unsigned char* a, unsigned char* b, Where w) const {
    constexpr int NT = T::THREADS;
    if (cross(w)) {
      constexpr int CH = BK / 8;
      static_assert(T::PM * CH % NT == 0, "whole chunks a thread");
      // one chunk at a time: 8 loads in flight and no more, so that the
      // step's registers stay within the tile's budget
#pragma unroll 1
      for (int it = 0; it < T::PM * CH / NT; ++it) {
        const int t = threadIdx.x + it * NT;
        const int r = t / CH, kc = (t % CH) * 8;
        const int gr = w.prow0 + r;
        unsigned v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int gk = w.k0 + kc + e;
          const bf16* src = gr >= gk ? A + gr * lda + gk : A + gk * lda + gr;
          v[e] = gr < m && gk < m
                     ? __ldg(reinterpret_cast<const unsigned short*>(src))
                     : 0u;
        }
        wgemm::put8<2 * BK>(a, r, kc / 8, wgemm::pack8(v));
      }
    } else if (!use_tma) {
      if (above(w))
        wgemm::stage_window<BK, T::PM, NT>(a, A, lda, m, m, w.k0, w.prow0);
      else
        wgemm::stage_window<T::PM, BK, NT>(a, A, lda, m, m, w.prow0, w.k0);
    }
    if (!use_tma)
      wgemm::stage_window<BK, T::PN, NT>(b, B, ldb, m, n, w.k0, w.pcol0);
  }
  __device__ bool trans_a(Where w) const { return above(w); }
};

template <int BM, int BN>
__global__ void __launch_bounds__(wgemm::Tile<BM, BN, BK>::THREADS,
                                  wgemm::Tile<BM, BN, BK>::BLOCKS)
symm_bf16_kernel(const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap mb, const Args p) {
  using T = wgemm::Tile<BM, BN, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const wgemm::Ring<T> ring = wgemm::make_ring<T>(smem_raw);

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const bf16* A = p.A + z * p.sAb;
  const bf16* B = p.B + z * p.sBb;
  const bf16* C = p.has_c ? p.C + z * p.sCb : p.C;
  bf16* O = p.O + z * p.sOb;

  const SymmProducer<T> prod{&ma, &mb, p.za < 0 ? -1 : z,
                             p.zb < 0 ? -1 : z, A, B, p.lda, p.ldb, p.m,
                             p.n, bool(p.tma)};
  const wgemm::Steps<T> st =
      wgemm::block_steps<T>(row0, col0, p.m, p.n, 0, p.m);
  wgemm::prime(ring, prod, st);
#pragma unroll 1
  for (int pass = 0; pass < st.passes; ++pass) {
    const Where o = st.origin(pass);
    float acc[T::ACC];
    wgemm::consume(ring, prod, st, pass, acc);
    // alpha * acc + beta * C, each product and the sum rounded in float32
    auto value = [&](int r, int c, float v) {
      float o = __fmul_rn(p.alpha, v);
      if (p.has_c)
        o = __fadd_rn(o, __fmul_rn(p.beta,
                                   __bfloat162float(C[r * p.ldc + c])));
      return o;
    };
    wgemm::for_each_acc<T>(
        acc, o.prow0, o.pcol0, p.m, p.n,
        [&](int r, int c, float v0, float v1, bool two) {
          wgemm::store2(O + r * p.ldo + c, value(r, c, v0),
                        two ? value(r, c + 1, v1) : 0.f, two);
        });
  }
}

template <int BM, int BN>
void config(int* out) {
  using T = wgemm::Tile<BM, BN, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES;
  out[4] = T::WARPGROUPS;
  out[5] = T::SWIZZLE;
}

template <int BM, int BN>
int launch(Args p, bool vec, cudaStream_t stream, int* launched) {
  using T = wgemm::Tile<BM, BN, BK>;
  CUtensorMap ma{}, mb{};
  p.tma = wgemm::tma_layout(vec, p.m, p.m, p.batch, p.lda, p.sAb) &&
          wgemm::tma_layout(vec, p.m, p.n, p.batch, p.ldb, p.sBb);
  p.za = p.zb = -1;
  if (p.tma) {
    int rc = wgemm::encode_map(&ma, &p.za, p.A, p.m, p.m, p.batch, p.lda,
                               p.sAb, kSlab, kSlab, 128);
    if (rc == 0)
      rc = wgemm::encode_map(&mb, &p.zb, p.B, p.m, p.n, p.batch, p.ldb,
                             p.sBb, kSlab, BK, 128);
    if (rc != 0) return rc;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      symm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  symm_bf16_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(ma, mb, p);
  return cudaGetLastError();
}

}  // namespace

// symm.cu's tiles: the Hopper symm knob space
#define REPRO_SYMM_BF16_TILES(X)                                     \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)

// One launcher for every instantiated output tile, with repro_symm_f32's
// arguments (A, B, C and O bf16).  Returns the cudaError_t of the launch (0
// on success); cudaErrorInvalidValue for a tile with no instantiation;
// wgemm::kEncodeFailed + the CUresult when a tensor map cannot be encoded.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned (TMA reads them).
extern "C" int repro_symm_bf16(int bm, int bn, const void* a, const void* b,
                               const void* c, void* o, int m, int n,
                               int batch, long long sAb, long long lda,
                               long long sBb, long long ldb, long long sCb,
                               long long ldc, long long sOb, long long ldo,
                               float alpha, float beta, int has_c, int vec,
                               void* stream, void* ev_start, void* ev_end,
                               int* launched) {
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
               static_cast<const bf16*>(c), static_cast<bf16*>(o),
               m, n, batch, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, has_c, 0, -1, -1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_SYMM_BF16_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return launch<BM, BN>(p, vec != 0, s, launched);
  REPRO_SYMM_BF16_TILES(REPRO_SYMM_BF16_LAUNCH)
#undef REPRO_SYMM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes, warpgroups and A's
// swizzle bytes, to out[0..5].
extern "C" int repro_symm_bf16_config(int bm, int bn, int* out) {
#define REPRO_SYMM_BF16_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return config<BM, BN>(out), 0;
  REPRO_SYMM_BF16_TILES(REPRO_SYMM_BF16_CONFIG)
#undef REPRO_SYMM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}
