// The bfloat16 mainloop on Hopper's asynchronous tensor cores: one block
// computes its BM x BN tile of float32 accumulators over a range of the
// contraction from bfloat16 A and B with wgmma.mma_async (m64nNk16, bf16
// in, f32 accumulate), both operands read from shared memory, fed by TMA
// (cp.async.bulk.tensor) through a ring of stages guarded by mbarriers.
// gemm_bf16.cu, symm_bf16.cu, the rank-k kernels (rank_k_tile_bf16.cuh)
// and the trmm kernels (trmm_tile_bf16.cuh) run it; what fills a stage is
// a producer (GemmProducer below; symm_bf16.cu's SymmProducer stitches
// sym(A) from the stored triangle; rank-k's stages rows of A or B on both
// sides; trmm's TrmmProducer stages tril(A)), and a step plan says which
// steps each pass runs.  trsm_bf16.cu's substitution runs its ring, its
// stages' layouts and its products with a consumer of its own, whose
// refills wait for rows of X the block has yet to store.
//
// Replaces, with the float32 loop, the reference package's Pallas dot
// src/repro/kernels/gemm.py::_gemm_kernel (jnp.dot(...,
// preferred_element_type=jnp.float32) into a float32 VMEM accumulator): the
// bf16 operands meet in the tensor cores and every sum is float32.
//
// Roles.  A block is WARPGROUPS = PM / 64 warpgroups (one or two).
// Warpgroup c owns rows 64c .. 64c + 63 of a pass and all PN columns: for
// each contraction step it waits on the stage's `full` mbarrier and
// issues BK / 16 wgmma of m64nPNk16 on it; a group of steps (64
// contraction indices) is committed as one, and once the group before has
// retired (wgmma.wait_group 1) each warp releases that group's stages.
// The producer is not a warp of its own but one elected lane a stage: the
// lanes of warp 0 fill every stage before the first step, and the last
// warp to release a stage (a count in shared memory; no warp waits for
// another) refills it at once: it arms the stage's `full` barrier with the
// bytes of the step STAGES ahead (mbarrier.arrive.expect_tx) and issues
// that step's TMA copies.  So STAGES - 1 steps are in flight while one is
// multiplied, the copies run on the TMA unit beside the wgmma, and no step
// has a block-wide barrier.  The steps run on across a block's passes, so
// the next pass's first copies overlap this one's last products and its
// epilogue.  The ring has STAGES stages, derived from the tile: as many
// as fit the shared memory of the blocks an SM is meant to hold (BLOCKS,
// below), 2 to 16 (a stage of the default 64x16x64 tile holds 4 KB: 13 of
// them, three groups of 64 contraction indices, and four such blocks an
// SM).
//
// Layouts, the ones wgmma reads.  A stage holds A's PM x BK tile K-major,
// rows of 2 BK bytes swizzled over 2 BK bytes (32, 64 or 128: TMA's
// SWIZZLE_32B/64B/128B and the descriptor's layout 3/2/1), and B's BK x
// PN tile as it lies, (k, n) with n contiguous, which is MN-major for
// wgmma (its transpose flag): PN / 64 slabs of BK rows of 128 bytes, each
// swizzled over 128 bytes.  A producer may stage a step's A MN-major too,
// the (k, rows) window as it is stored, in slabs of 64 rows (symm above
// the diagonal), and read it with the transpose flag for A.  A tile whose
// B_KMAJOR is true stages B's PN x BK tile K-major, laid out as A's
// (rank-k: both sides are rows of a row-major (n, k) matrix), and reads it
// without the transpose flag for B; gemm and symm compile with it false.
// Descriptors: K-major, 8-row groups SBO = 16 BK bytes apart; MN-major,
// 8-row (k) groups 1024 bytes apart and 64-column slabs LBO = 128 BK bytes
// apart.  A k16 step advances the start address by 32 bytes (K-major) or
// 16 rows (2048 bytes, MN-major).  Every stage and slab starts on a
// 1024-byte boundary, the swizzle's repeat, so the swizzle is a function
// of the offset.
//
// Thread-written stages.  An operand TMA cannot take (the wrapper's `vec`
// false: an odd pointer, leading or batch stride) and symm's steps across
// the diagonal are written by the block's threads themselves, after the
// step's `full` barrier (which then guards the TMA parts alone): 2-byte
// loads, zero past an edge, into the same swizzled layout with 16-byte
// shared stores, then fence.proxy.async (the generic proxy's stores
// before the async proxy's reads) and __syncthreads.  trmm's steps across
// the diagonal go the same way, the threads zeroing what lies above the
// diagonal in the stage that TMA filled.
// Both paths put the same values in the same places and feed identical
// wgmma instructions, so odd strides == aligned copies bit for bit.
//
// Order.  The sums inside one wgmma are the tensor core's own; across
// wgmma they add in increasing k, from zeroed accumulators.  Whatever the
// copy path and wherever a tile lies in the grid, an output element sees
// the same inputs in the same wgmma, so unaligned == aligned, stacked ==
// per-item and masked == zero-padded hold bit for bit (TMA fills what lies
// past a tensor's edge with zeros: the reference's masks).  A box wholly
// past m or n is not copied, A's box holds no more rows than m rounded up
// to 8 (TMA's work goes by rows: a decode's one row a stack item would
// otherwise cost 64), and a warpgroup whose rows all lie past m
// multiplies whatever its stage holds there: those products meet only
// outputs that are dropped (a branch around wgmma that ptxas cannot prove
// uniform in the warpgroup would make it serialise every wgmma).
//
// Registers.  A thread holds PN / 2 accumulators (128 at PN = 256).  Each
// of an SM's four partitions holds 16,384 registers and one warp of each
// warpgroup, so a block of C warpgroups takes C warps of a partition and
// BLOCKS = 512 / (C (PN / 2 + 64)) blocks (1 to 4) leave a thread 64
// registers beside its accumulators; __launch_bounds__(THREADS, BLOCKS)
// holds ptxas to that and the ring to 1 / BLOCKS of the shared memory.  A
// tile of BM = 256 runs passes of 128 rows (and of 128 columns at BN =
// 256), one after the other, through the same ring.
//
// Bound on an H100 SXM: 989 TFLOP/s of dense bf16 against 3.35 TB/s, so a
// product with fewer than about 295 operations a byte (every decode GEMM
// and the thin prefill ones) is bound by its bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgemm {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// shared memory of an H100's SM, and what one block of it may use; the
// swizzle's repeat, which every stage and slab is aligned to; the deepest
// ring
constexpr int kSmemSM = 233472;
constexpr int kSmemMax = 232448;
constexpr int kAlign = 1024;
constexpr int kMaxStages = 16;
// columns of a slab of 128-byte swizzled rows
constexpr int kSlab = 64;
// clock cycles a barrier wait may last before the kernel traps: a
// protocol fault raises in the caller rather than hanging the card
constexpr long long kWaitTrap = 1LL << 32;

// The launch parameters of a BM x BN tile with contraction step BK, all
// derived from the tile (kernels/gemm.py::mainloop_params with
// dtype=torch.bfloat16 mirrors them), and B's layout in a stage: MN-major
// slabs, or K-major as A (B_KMAJOR; the same bytes).
template <int BM_, int BN_, int BK_, bool B_KMAJOR_ = false>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr bool B_KMAJOR = B_KMAJOR_;
  // a pass: at most 128 rows (two warpgroups), and every column but in
  // the tile of 256 x 256, which runs four passes of 128 x 128 (as two of
  // 128 x 256, ptxas serialised its wgmma for want of registers)
  static constexpr int PM = cmin(BM, 128);
  static constexpr int PN = BM > 128 && BN > 128 ? 128 : BN;
  static constexpr int PASSES_M = BM / PM, PASSES_N = BN / PN;
  static constexpr int PASSES = PASSES_M * PASSES_N;
  static constexpr int WARPGROUPS = PM / 64;
  static constexpr int THREADS = 128 * WARPGROUPS;
  // accumulators of a thread, and the blocks an SM is meant to hold
  static constexpr int ACC = PN / 2;
  static constexpr int BLOCKS =
      cmax(1, cmin(4, 512 / (WARPGROUPS * (ACC + 64))));
  // A's (and a K-major B's) row bytes and swizzle span; its tile; a B
  // slab (K-major: PN x BK as A, the same bytes); a stage
  static constexpr int SWIZZLE = 2 * BK;
  static constexpr int A_BYTES = PM * BK * 2;
  static constexpr int SLAB_BYTES = BK * 2 * kSlab;
  static constexpr int B_BYTES = PN / kSlab * SLAB_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the SM's shared memory over BLOCKS blocks, less 4 KB a block: the
  // ring's alignment, its barriers, the kernel's static shared memory and
  // the 1 KB the card reserves a block
  static constexpr int RING_BUDGET = kSmemSM / BLOCKS - 4 * kAlign;
  static constexpr int STAGES =
      cmax(2, cmin(kMaxStages, RING_BUDGET / STAGE_BYTES));
  // the stages a group of products takes: 64 contraction indices
  static constexpr int GROUP = 64 / BK;
  // the ring, its full barriers and release counts, and the room to align
  // it
  static constexpr int SMEM = kAlign + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(BK == 16 || BK == 32 || BK == 64, "a swizzle of 2 BK bytes");
  static_assert(PN % kSlab == 0 && PN <= 256, "m64nNk16 with N <= 256");
  static_assert(PM % 64 == 0 && BM % PM == 0 && BN % PN == 0,
                "passes of 64-row groups");
  static_assert(A_BYTES % kAlign == 0 && SLAB_BYTES % kAlign == 0,
                "stages and slabs on the swizzle's repeat");
  static_assert(SMEM <= kSmemMax, "227 KB of shared memory per block");
  static_assert(STAGES >= 2 * GROUP, "a group in flight beside the next");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitTrap) __trap();
}

// -- TMA ---------------------------------------------------------------------

// the box at (c0, c1) of a 2-D map, or at (c0, c1, z) of a 3-D one (z >= 0),
// into shared memory at dst, completing bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int z) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (z < 0)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(z)
        : "memory");
}

// the generic proxy's shared stores before the async proxy's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma -------------------------------------------------------------------

// a shared memory matrix descriptor: start address, leading and stride
// byte offsets, layout (1: 128-byte swizzle, 2: 64, 3: 32)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32 | uint64_t(layout) << 62;
}

__host__ __device__ constexpr uint32_t swizzle_layout(int bytes) {
  return bytes == 128 ? 1u : bytes == 64 ? 2u : 3u;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulators above a wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A @ B on one m64nNk16, A K-major (TA = 0) or MN-major (TA = 1), B
// K-major (TB = 0) or MN-major (TB = 1, wgmma's transpose flag), both from
// shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB)
      : "memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63,\n"
      "%64, %65, %66, %67, %68, %69, %70, %71,\n"
      "%72, %73, %74, %75, %76, %77, %78, %79,\n"
      "%80, %81, %82, %83, %84, %85, %86, %87,\n"
      "%88, %89, %90, %91, %92, %93, %94, %95,\n"
      "%96, %97, %98, %99, %100, %101, %102, %103,\n"
      "%104, %105, %106, %107, %108, %109, %110, %111,\n"
      "%112, %113, %114, %115, %116, %117, %118, %119,\n"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB)
      : "memory");
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else if constexpr (N == 128)
    wgmma_n128<TA, TB>(d, da, db);
  else
    wgmma_n256<TA, TB>(d, da, db);
}

// -- the ring ----------------------------------------------------------------

template <class T>
struct Ring {
  unsigned char* base;  // the first stage, on a 1024-byte boundary
  uint32_t base_s;      // its shared address
  uint32_t bars_s;      // full[0 .. STAGES)
  int* released;        // [STAGES]: the warps done with the stage's step
  __device__ unsigned char* stage(int s) const {
    return base + s * T::STAGE_BYTES;
  }
  __device__ uint32_t stage_s(int s) const {
    return base_s + s * T::STAGE_BYTES;
  }
  __device__ uint32_t full(int s) const { return bars_s + 8 * s; }
};

// The ring in the block's dynamic shared memory (T::SMEM bytes): aligned
// up to 1024 bytes, its full barriers initialised (one arrival: the
// filler's) and its release counts zeroed.  Every thread of the block
// calls it.
template <class T>
__device__ __forceinline__ Ring<T> make_ring(unsigned char* raw) {
  const uint32_t raw_s = smem_u32(raw);
  const uint32_t pad = (kAlign - (raw_s & (kAlign - 1))) & (kAlign - 1);
  const int ring = T::STAGES * T::STAGE_BYTES;
  Ring<T> r{raw + pad, raw_s + pad, raw_s + pad + ring,
            reinterpret_cast<int*>(raw + pad + ring + 8 * T::STAGES)};
  if (threadIdx.x < T::STAGES) {
    bar_init(r.full(threadIdx.x), 1);
    r.released[threadIdx.x] = 0;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  return r;
}

// -- the producer and the products -------------------------------------------
//
// Where a step reads: the pass's first row and column and the step's
// first contraction index.
struct Where {
  int prow0, pcol0, k0;
};

// A producer P supplies, for the step at w:
//   int tma_bytes(Where w)           bytes its TMA copies deliver (0: none);
//   void issue(uint32_t a, uint32_t b, uint32_t bar, Where w)
//                                    issue them into the stage's A and B
//                                    regions (shared addresses), completing
//                                    on bar (from one lane);
//   bool threads_write(Where w)      whether the threads write parts of the
//                                    stage themselves;
//   void write(unsigned char* a, unsigned char* b, Where w)
//                                    those parts, from every thread;
//   bool trans_a(Where w)            A staged MN-major (a constant false
//                                    folds the transposed step away).

// A step plan S gives a block's passes and their contraction steps, one
// sequence through the ring (step g is the ring's stage g % STAGES in its
// phase g / STAGES):
//   int total()                      the steps of every pass;
//   int first(int pass), count(int pass)
//                                    the pass's first step and its steps;
//   Where origin(int pass)           its first row, column and index;
//   Where at(int g)                  where step g reads.
// Steps below is the plan of gemm, symm and rank-k, the same steps in every
// pass; trmm_tile_bf16.cuh's TrmmSteps ends each pass where its rows do.

// The block's steps: `steps` contraction steps of BK from kbeg in each of
// its `passes` passes, `passes_n` of them across the columns from col0 and
// the rest down the rows from row0.
template <class T>
struct Steps {
  int row0, col0, kbeg, steps, passes, passes_n;
  __device__ int total() const { return steps * passes; }
  __device__ int first(int pass) const { return pass * steps; }
  __device__ int count(int) const { return steps; }
  __device__ Where origin(int pass) const {
    // passes_n is 1, or 2 with PASSES_N 2
    const int pm = T::PASSES_N == 1 ? pass : pass / passes_n;
    const int pn = T::PASSES_N == 1 ? 0 : pass % passes_n;
    return {row0 + pm * T::PM, col0 + pn * T::PN, kbeg};
  }
  // (no division: a step lies at most PASSES passes in)
  __device__ Where at(int g) const {
    int pass = 0;
    for (; g >= steps; g -= steps) ++pass;
    Where w = origin(pass);
    w.k0 += g * T::BK;
    return w;
  }
};

// The passes of a block's BM x BN tile at (row0, col0) that hold an
// output inside m x n, over the contraction [kbeg, kend).
template <class T>
__device__ __forceinline__ Steps<T> block_steps(int row0, int col0, int m,
                                                int n, int kbeg, int kend) {
  const int pm = cmin(T::PASSES_M, (m - row0 + T::PM - 1) / T::PM);
  const int pn = cmin(T::PASSES_N, (n - col0 + T::PN - 1) / T::PN);
  return {row0, col0, kbeg,
          kend > kbeg ? (kend - kbeg + T::BK - 1) / T::BK : 0, pm * pn, pn};
}

// Step g's copies into its stage, which no warp reads any more.
template <class T, class P, class S>
__device__ __forceinline__ void fill(const Ring<T>& ring, const P& prod,
                                     const S& st, int g) {
  const int s = g % T::STAGES;
  const Where w = st.at(g);
  const int bytes = prod.tma_bytes(w);
  if (bytes) {
    bar_arrive_tx(ring.full(s), bytes);
    const uint32_t a = ring.stage_s(s);
    prod.issue(a, a + T::A_BYTES, ring.full(s), w);
  } else {
    bar_arrive(ring.full(s));
  }
}

// Before the first pass: the first STAGES steps' copies, lane g of warp 0
// issuing step g.
template <class T, class P, class S>
__device__ __forceinline__ void prime(const Ring<T>& ring, const P& prod,
                                      const S& st) {
  static_assert(T::STAGES <= 32, "a lane a stage");
  if (threadIdx.x < cmin(T::STAGES, st.total()))
    fill(ring, prod, st, threadIdx.x);
  __syncwarp();
}

// The m64 x PN x BK products of one stage for warpgroup wg.
template <class T, int TA>
__device__ __forceinline__ void stage_mma(uint32_t a, uint32_t b, int wg,
                                          float (&acc)[T::ACC]) {
#pragma unroll
  for (int j = 0; j < T::BK / 16; ++j) {
    const uint64_t db =
        T::B_KMAJOR ? make_desc(b + j * 32, 16, 8 * T::SWIZZLE,
                                swizzle_layout(T::SWIZZLE))
                    : make_desc(b + j * 16 * 128, T::SLAB_BYTES, 1024, 1);
    const uint64_t da =
        TA ? make_desc(a + wg * T::SLAB_BYTES + j * 16 * 128, T::SLAB_BYTES,
                       1024, 1)
           : make_desc(a + wg * 64 * T::SWIZZLE + j * 32, 16,
                       8 * T::SWIZZLE, swizzle_layout(T::SWIZZLE));
    wgmma<T::PN, TA, T::B_KMAJOR ? 0 : 1>(acc, da, db);
  }
}

// A warpgroup's accumulators of pass `pass` (after prime; every thread of
// the block calls it for every pass in turn), zero when the contraction is
// empty.  A warpgroup whose rows all lie past m multiplies what its stage
// holds there like any other (zeros, or what a box past the edge left):
// a branch around wgmma that ptxas cannot prove uniform in the warpgroup
// makes it serialise every wgmma.  The products run in groups of GROUP
// stages, 64 contraction indices (the last group may hold fewer): each
// stage's wgmma is issued as its `full` barrier completes, the group is
// committed as one, and once the group before has retired its stages are
// released together, a lane a stage.  So a small BK costs a barrier wait
// a stage but one commit and wait a group.  Leaves no wgmma in flight.
template <class T, class P, class S>
__device__ __forceinline__ void consume(const Ring<T>& ring, const P& prod,
                                        const S& st, int pass,
                                        float (&acc)[T::ACC]) {
  const int tid = threadIdx.x, wg = tid / 128;
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;
  fence_acc(acc);
  // lane i releases the stage of step h + i for its warp (its wgmma have
  // retired); the last of the block's warps to do so refills the stage
  // with the step STAGES ahead.  The warp then runs on together.
  const int lane = tid % 32;
  auto release = [&](int h, int n) {
    if (lane < n) {
      const int s = (h + lane) % T::STAGES;
      __threadfence_block();
      if (atomicAdd(ring.released + s, 1) == 4 * T::WARPGROUPS - 1) {
        ring.released[s] = 0;
        __threadfence_block();
        if (h + lane + T::STAGES < st.total())
          fill(ring, prod, st, h + lane + T::STAGES);
      }
    }
    __syncwarp();
  };
  const int g0 = st.first(pass), g1 = g0 + st.count(pass);
  const Where o = st.origin(pass);
  int held = g0, n_held = 0;  // the group in flight
  for (int g = g0; g < g1; g += T::GROUP) {
    const int n = cmin(T::GROUP, g1 - g);
    for (int i = 0; i < n; ++i) {
      const int s = (g + i) % T::STAGES;
      const Where w{o.prow0, o.pcol0, o.k0 + (g + i - g0) * T::BK};
      bar_wait(ring.full(s), ((g + i) / T::STAGES) & 1);
      if (prod.threads_write(w)) {
        prod.write(ring.stage(s), ring.stage(s) + T::A_BYTES, w);
        fence_proxy_async();
        __syncthreads();
      }
      const uint32_t a = ring.stage_s(s);
      wgmma_fence();
      if (prod.trans_a(w))
        stage_mma<T, 1>(a, a + T::A_BYTES, wg, acc);
      else
        stage_mma<T, 0>(a, a + T::A_BYTES, wg, acc);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (n_held) release(held, n_held);
    held = g;
    n_held = n;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (n_held) release(held, n_held);
}

// -- thread-written stages ---------------------------------------------------

// 8 elements (16 bytes) into row r, 16-byte chunk c of a region of rows of
// ROWB bytes swizzled over ROWB bytes (the region on a 1024-byte boundary)
template <int ROWB>
__device__ __forceinline__ void put8(unsigned char* region, int r, int c,
                                     uint4 v) {
  const int off = r * ROWB + c * 16;
  *reinterpret_cast<uint4*>(region +
                            (off ^ (((off >> 7) & (ROWB / 16 - 1)) << 4))) =
      v;
}

__device__ __forceinline__ uint4 pack8(const unsigned (&v)[8]) {
  return make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                    v[6] | v[7] << 16);
}

// Stages the R x C window at (i0, j0) of the row-major bf16 matrix p
// (leading stride ld, rows x cols stored; zero past them) as TMA would
// with boxes of min(C, 64) columns: slabs of min(C, 64) columns, each R
// rows of 2 min(C, 64) bytes swizzled over as many.  2-byte loads, from
// the NT threads of the block.
template <int R, int C, int NT>
__device__ __forceinline__ void stage_window(unsigned char* dst,
                                             const bf16* p, long long ld,
                                             int rows, int cols, int i0,
                                             int j0) {
  constexpr int W = cmin(C, kSlab), CH = C / 8, N = R * CH;
#pragma unroll 1
  for (int t = threadIdx.x; t < N; t += NT) {
    const int i = t / CH, j = (t % CH) * 8;
    const int gi = i0 + i, gj = j0 + j;
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(p + gi * ld + gj);
    unsigned v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = gi < rows && gj + e < cols ? __ldg(src + e) : 0u;
    put8<2 * W>(dst + (j / W) * R * 2 * W, i, (j % W) / 8, pack8(v));
  }
}

// -- the epilogue ------------------------------------------------------------

// Calls f(r, c, v0, v1, two) for every pair of a thread's accumulators
// whose first output element (prow0 + r, pcol0 + c) lies inside m x n:
// v0 is element (r, c), v1 element (r, c + 1), which `two` says lies
// inside n too (so that the caller may store both at once).  wgmma's
// accumulator layout: warp w of the block holds rows 16 w .. 16 w + 15 of
// the pass; lane l rows l / 4 and l / 4 + 8 of those, and of each n8
// group j columns 8 j + (l % 4) * 2 and the one after, acc[4 j .. 4 j + 3].
template <class T, class F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[T::ACC],
                                             int prow0, int pcol0, int m,
                                             int n, F f) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = prow0 + 16 * warp + lane / 4;
  const int c0 = pcol0 + (lane % 4) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < T::PN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c < n)
        f(r, c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], c + 1 < n);
    }
  }
}

// Stores two adjacent bf16 outputs (the second when `two`), as one 4-byte
// store where the address allows.
__device__ __forceinline__ void store2(bf16* o, float v0, float v1,
                                       bool two) {
  if (two && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = __float2bfloat16_rn(v0);
    if (two) o[1] = __float2bfloat16_rn(v1);
  }
}

// -- the row-major producer --------------------------------------------------

// the boxes of `width` columns (rows) from `at` that hold one inside
// `extent`, at most `most`: a box wholly past an edge is not copied (what
// it would hold meets only outputs past m or n, which are dropped)
__device__ __forceinline__ int boxes_inside(int extent, int at, int width,
                                            int most) {
  return cmin(most, (extent - at + width - 1) / width);
}

// The GEMM's stages: the PM x BK window of A at (w.prow0, w.k0) and the BK
// x PN window of B at (w.k0, w.pcol0), A (m, k) and B (k, n) row-major.  With
// use_tma, A's map reads one box of BK x a_rows (swizzle 2 BK; a_rows =
// PM, or m rounded up to 8 where m is smaller: a decode's few rows) and
// B's boxes of 64 x BK (swizzle 128), at batch coordinates za and zb (-1:
// a 2-D map); else the threads stage both from A and B, which point at
// this item.
template <class T>
struct GemmProducer {
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int za, zb;
  const bf16* A;
  const bf16* B;
  long long lda, ldb;
  int m, n, k, a_rows;
  bool use_tma;
  __device__ int slabs(Where w) const {
    return boxes_inside(n, w.pcol0, kSlab, T::PN / kSlab);
  }
  __device__ int tma_bytes(Where w) const {
    return use_tma ? a_rows * T::BK * 2 + slabs(w) * T::SLAB_BYTES : 0;
  }
  __device__ void issue(uint32_t a, uint32_t b, uint32_t bar, Where w) const {
    tma_load(a, ma, bar, w.k0, w.prow0, za);
    const int nb = slabs(w);
    for (int j = 0; j < nb; ++j)
      tma_load(b + j * T::SLAB_BYTES, mb, bar, w.pcol0 + j * kSlab, w.k0,
               zb);
  }
  __device__ bool threads_write(Where) const { return !use_tma; }
  __device__ void write(unsigned char* a, unsigned char* b, Where w) const {
    stage_window<T::PM, T::BK, T::THREADS>(a, A, lda, m, k, w.prow0, w.k0);
    stage_window<T::BK, T::PN, T::THREADS>(b, B, ldb, k, n, w.k0, w.pcol0);
  }
  __device__ bool trans_a(Where) const { return false; }
};

// -- tensor maps (host) ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (no -lcuda),
// looked up once; null if the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// launcher return codes above the CUDA runtime's: a tensor map that could
// not be encoded (kEncodeFailed + the CUresult), or no encoder at all
constexpr int kEncodeFailed = 100000;
constexpr int kNoEncoder = 200000;

// Whether TMA may read a row-major bf16 operand of rows x cols, leading
// stride ld and batch stride sb (elements) of a stack of batch: 16-byte
// aligned (vec), rows that do not overlap, items that do not overlap (or
// one item shared by the stack, sb = 0).
inline bool tma_layout(bool vec, int rows, int cols, int batch, long long ld,
                       long long sb) {
  return vec && ld >= cols &&
         (batch == 1 || sb == 0 || sb >= ld * (long long)rows);
}

// The map of such an operand, read in boxes of box_c x box_r elements with
// a swizzle of swz bytes (32, 64, 128): 2-D when the stack has one item or
// shares it (batch stride 0; *z = -1), else 3-D with the batch outermost
// (*z = 0: the kernel passes its item).  Elements past the edges read
// zero.  Returns 0 or a launcher error code.
inline int encode_map(CUtensorMap* map, int* z, const void* p, int rows,
                      int cols, int batch, long long ld, long long sb,
                      int box_c, int box_r, int swz) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const bool stacked = batch > 1 && sb != 0;
  *z = stacked ? 0 : -1;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(ld) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[3] = {cuuint32_t(box_c), cuuint32_t(box_r), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      swz == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, stacked ? 3 : 2,
      const_cast<void*>(p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + int(r);
}

}  // namespace wgemm
