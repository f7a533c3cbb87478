// GEMM for Hopper (sm_90a) in bfloat16, the tiles of bn 256 (gemm_bf16.cu
// builds the others beside it, and the split plan): the kernel and its
// launcher are gemm_bf16.cuh's.
//
// Replaces the bf16 mode of the reference package's Pallas TPU kernel
// src/repro/kernels/gemm.py::_gemm_kernel / gemm_pallas.

#include "gemm_bf16.cuh"

using namespace gemm_bf16;

// the tiles of gemm.cu's REPRO_GEMM_TILES with bn 256 (bm in 64, 128,
// 256; bk in 16, 32, 64)
#define REPRO_GEMM_BF16_TILES(X)                                  \
  X(64, 16, 256) X(64, 32, 256) X(64, 64, 256) X(128, 16, 256)    \
  X(128, 32, 256) X(128, 64, 256) X(256, 16, 256) X(256, 32, 256) \
  X(256, 64, 256)

// One launcher for every instantiated tile, with repro_gemm_f32's
// arguments (A, B, C and O bf16; the workspace float32).  Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for a
// tile with no instantiation or a split other than split_plan's;
// wgemm::kEncodeFailed + the CUresult when a tensor map cannot be encoded.
// Writes the grid it launched (x, y, z) to launched[0..2].  Does not
// synchronise.  vec says that A, B, their leading strides and batch
// strides are 16-byte aligned (TMA reads them).
extern "C" int repro_gemm_bf16_n256(
    int bm, int bk, int bn, const void* a, const void* b, const void* c,
    void* o, void* ws, void* tickets, int m, int n, int k, int batch,
    long long sAb, long long lda, long long sBb, long long ldb, long long sCb,
    long long ldc, long long sOb, long long ldo, float alpha, float beta,
    int has_c, int vec, int slices, int slice_len, void* stream,
    void* ev_start, void* ev_end, int* launched) {
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
               static_cast<const bf16*>(c), static_cast<bf16*>(o),
               static_cast<float*>(ws), static_cast<int*>(tickets),
               m, n, k, batch, sAb, lda, sBb, ldb, sCb, ldc, sOb, ldo,
               alpha, beta, has_c, slices, slice_len, 0, -1, -1, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TimedLaunch timed(ev_start, ev_end, s);
#define REPRO_GEMM_BF16_LAUNCH(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN)    \
    return launch<BM, BK, BN>(p, vec != 0, s, launched);
  REPRO_GEMM_BF16_TILES(REPRO_GEMM_BF16_LAUNCH)
#undef REPRO_GEMM_BF16_LAUNCH
  return int(cudaErrorInvalidValue);
}

// The launch parameters the kernel of a tile was built with: threads,
// stages, dynamic shared bytes, passes, warpgroups and A's
// swizzle bytes, to out[0..5].
extern "C" int repro_gemm_bf16_n256_config(int bm, int bk, int bn, int* out) {
#define REPRO_GEMM_BF16_CONFIG(BM, BK, BN) \
  if (bm == BM && bk == BK && bn == BN) return config<BM, BK, BN>(out), 0;
  REPRO_GEMM_BF16_TILES(REPRO_GEMM_BF16_CONFIG)
#undef REPRO_GEMM_BF16_CONFIG
  return int(cudaErrorInvalidValue);
}
