// SYMM for Hopper (sm_90a) in bfloat16: O = alpha * sym(A) @ B + beta * C,
// A stored in its lower triangle, A, B, C and O bfloat16, every product and
// sum float32 on the tensor cores, and O rounded to bfloat16 once, at the
// store.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/symm.py::_symm_kernel / symm_pallas (bf16 operands, a
// float32 VMEM accumulator, alpha * acc + beta * C in float32, the output
// in A's dtype).  symm.cu is its float32 twin: the same grid, masks, batch
// and stitching of sym(A), on the bf16 mainloop (bf16_mainloop.cuh) in
// place of the float32 one.
//
// Layout.  One block computes one bm x bn tile of O; grid x walks the
// n-tiles, grid y the m-tiles, grid z the batch.  The contraction runs
// inside the block over m itself in steps of BK = 64 (core/knobs.py
// HOPPER_CONTRACTION_STEP), on the mainloop's cp.async ring, ldmatrix and
// mma.sync m16n8k16.  Every element of sym(A) is read from the one place
// it is stored (sym(A)[r, c] = A[r, c] when r >= c, else A[c, r]), and the
// A producer stages each step by where its tile lies:
//   - wholly on or below the diagonal: the stored tile (rows, k),
//     row-major, as the GEMM stages A;
//   - wholly above it: the stored tile (k, rows), which is the transpose of
//     the step's tile, copied as it is stored, [BK][PM + 8], and read by
//     the mainloop's transposed step (ldmatrix.x4.trans; the choice is per
//     step and per block, never per thread);
//   - across it (at most PM / 64 + 1 steps a pass): each 8-element chunk
//     read with 2-byte loads, every element from wherever it is stored,
//     and written with one 16-byte shared store (cp.async moves no fewer
//     than 4 bytes); the barrier that publishes the step's copies
//     publishes these stores too.
// Every layout puts the same values into the same mma fragments, so an
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
// few hundred is bound by the operations.  mma.sync reaches only a part of
// the tensor cores' rate; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mainloop.cuh"
#include "launch_grid.cuh"

namespace {

using bgemm::bf16;

constexpr int BK = 64;

struct Args {
  const bf16* A;
  const bf16* B;
  const bf16* C;
  bf16* O;
  int m, n, batch;
  long long sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo;
  float alpha, beta;
  int has_c, vec;
};

template <class T>
struct SymmProducer {
  const bf16* A;
  const bf16* B;
  long long lda, ldb;
  int m, n, prow0, pcol0;
  bool vec;
  __device__ bool transposed(int k0) const { return k0 >= prow0 + T::PM; }
  __device__ void load(bf16* As, bf16* Bs, int k0) const {
    if (transposed(k0)) {
      // every element a mirror: sym(A)[r, k] = A[k, r], staged [BK][PM]
      bgemm::load_tile<T::BK, T::PM, T::THREADS, T::LDAT>(As, A, lda, m, m,
                                                          k0, prow0, vec);
    } else if (k0 + T::BK <= prow0 + 1) {
      // every element stored: sym(A)[r, k] = A[r, k], staged [PM][BK]
      bgemm::load_tile<T::PM, T::BK, T::THREADS, T::LDA>(As, A, lda, m, m,
                                                         prow0, k0, vec);
    } else {
      constexpr int CH = T::BK / 8;
      static_assert(T::PM * CH % T::THREADS == 0, "whole chunks a thread");
      // one chunk at a time: 8 loads in flight and no more, so that the
      // step's registers stay within the 128 x 256 tile's budget
#pragma unroll 1
      for (int it = 0; it < T::PM * CH / T::THREADS; ++it) {
        const int t = threadIdx.x + it * T::THREADS;
        const int r = t / CH, kc = (t % CH) * 8;
        const int gr = prow0 + r;
        unsigned v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int gk = k0 + kc + e;
          const bf16* src = gr >= gk ? A + gr * lda + gk : A + gk * lda + gr;
          v[e] = gr < m && gk < m
                     ? __ldg(reinterpret_cast<const unsigned short*>(src))
                     : 0u;
        }
        *reinterpret_cast<uint4*>(As + r * T::LDA + kc) =
            make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                       v[4] | v[5] << 16, v[6] | v[7] << 16);
      }
    }
    bgemm::load_tile<T::BK, T::PN, T::THREADS, T::LDB>(Bs, B, ldb, m, n, k0,
                                                       pcol0, vec);
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(bgemm::Tile<BM, BN, BK>::THREADS, 1)
symm_bf16_kernel(const Args p) {
  using T = bgemm::Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* smem = reinterpret_cast<bf16*>(smem_bytes);

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  const bf16* A = p.A + z * p.sAb;
  const bf16* B = p.B + z * p.sBb;
  const bf16* C = p.has_c ? p.C + z * p.sCb : p.C;
  bf16* O = p.O + z * p.sOb;

#pragma unroll 1
  for (int pm = 0; pm < T::PASSES_M; ++pm) {
#pragma unroll 1
    for (int pn = 0; pn < T::PASSES_N; ++pn) {
      const int prow0 = row0 + pm * T::PM, pcol0 = col0 + pn * T::PN;
      if (prow0 >= p.m || pcol0 >= p.n) continue;  // uniform in the block
      const SymmProducer<T> prod{A, B, p.lda, p.ldb, p.m, p.n,
                                 prow0, pcol0, bool(p.vec)};
      float acc[T::MT][T::NT][4];
      bgemm::mainloop<T>(smem, prod, 0, p.m,
                         bgemm::live_tiles<T>(prow0, p.m), acc);
      bgemm::for_each_acc<T>(
          acc, prow0, pcol0, p.m, p.n, [&](int r, int c, float v) {
            float o = __fmul_rn(p.alpha, v);
            if (p.has_c)
              o = __fadd_rn(o, __fmul_rn(p.beta,
                                         __bfloat162float(C[r * p.ldc + c])));
            O[r * p.ldo + c] = __float2bfloat16_rn(o);
          });
    }
  }
}

template <int BM, int BN>
void config(int* out) {
  using T = bgemm::Tile<BM, BN, BK>;
  out[0] = T::THREADS;
  out[1] = T::STAGES;
  out[2] = T::SMEM;
  out[3] = T::PASSES_M * T::PASSES_N;
  out[4] = T::WARPS_M;
  out[5] = T::WARPS_N;
}

template <int BM, int BN>
cudaError_t launch(const Args& p, cudaStream_t stream, int* launched) {
  using T = bgemm::Tile<BM, BN, BK>;
  const cudaError_t e = cudaFuncSetAttribute(
      symm_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.batch);
  set_grid(launched, grid);
  symm_bf16_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// symm.cu's tiles: the Hopper symm knob space
#define REPRO_SYMM_BF16_TILES(X)                                     \
  X(64, 64) X(64, 128) X(64, 256) X(128, 64) X(128, 128) X(128, 256) \
  X(256, 64) X(256, 128)

// One launcher for every instantiated output tile, with repro_symm_f32's
// arguments (A, B, C and O bf16).  Returns the cudaError_t of the launch (0
// on success); cudaErrorInvalidValue for a tile with no instantiation.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned.
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
               alpha, beta, has_c, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_SYMM_BF16_LAUNCH(BM, BN) \
  if (bm == BM && bn == BN) return int(launch<BM, BN>(p, s, launched));
  REPRO_SYMM_BF16_TILES(REPRO_SYMM_BF16_LAUNCH)
#undef REPRO_SYMM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes and the warp grid (m, n), to
// out[0..5].
extern "C" int repro_symm_bf16_config(int bm, int bn, int* out) {
#define REPRO_SYMM_BF16_CONFIG(BM, BN) \
  if (bm == BM && bn == BN) return config<BM, BN>(out), 0;
  REPRO_SYMM_BF16_TILES(REPRO_SYMM_BF16_CONFIG)
#undef REPRO_SYMM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}
