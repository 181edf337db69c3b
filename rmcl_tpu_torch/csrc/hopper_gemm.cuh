// The bf16 GEMM mainloop under ln_gemm and gemm_tn on Hopper (sm_90a): TMA
// loads into a ring of shared-memory stages, one producer warp, two consumer
// warpgroups on wgmma.mma_async with fp32 accumulators in registers, a
// persistent loop over output tiles, and the epilogue applied to the
// accumulator registers by a functor the kernel supplies.
//
// Tile: BM = 128 rows (64 per consumer warpgroup) by BN = 128 or 192 columns,
// BK = 64 deep per stage.  Every operand tile arrives by TMA with the
// 128-byte swizzle, in boxes of 64 bf16 along the contiguous dimension:
//   K-major operand (A of ln_gemm, W stored (N, K)): one box of (rows, 64 k),
//     rows 128 bytes apart, 8-row atoms 1024 bytes apart (SBO); a k16 step
//     moves the descriptor's start by 32 bytes.
//   MN-major operand (W stored (K, N), both operands of gemm_tn): boxes of
//     (64 k, 64 mn), one per 64 columns, 8 KB apart (LBO); 8-k atoms 1024
//     bytes apart (SBO); a k16 step moves the start by 2048 bytes.  The
//     wgmma transpose bit reads it as it lies: no operand is ever transposed
//     in memory.
// Out-of-bounds rows and columns arrive as zeros (TMA's fill), so ragged M,
// N and K need no padding; the epilogue masks its stores.  Each work item is
// one output tile and, for gemm_tn, one slice of the contraction: the item's
// accumulator is summed by wgmma in a fixed order, and slices go to separate
// scratch slabs that a second pass adds in order, so results are
// reproducible bit for bit.
//
// Pipeline: full[s] completes when the stage's TMA bytes have landed
// (arrive.expect_tx by the producer), empty[s] when both consumer
// warpgroups have finished the wgmma that read it.  A consumer keeps one
// wgmma group in flight (wait_group 1) and releases the previous stage.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from libcuda at run time
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace hg {

constexpr int BM = 128, BK = 64;
constexpr int CONSUMERS = 2;                        // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;       // + one producer warp
constexpr int BOX = 64;                             // bf16 in one 128-byte swizzled row
constexpr int BOX_BYTES = BOX * BK * 2;             // one (64, 64) box: 8 KB
// The epilogue goes through shared memory, 32 columns at a time: each
// consumer warp stages the 16 rows it holds as fp32 rows of EPI_LD floats
// (padded so that both the fragment's stores and the row reads are free of
// bank conflicts), then walks them two rows per step with a rolled loop, so
// the epilogue's code exists once, not once per accumulator pair, and every
// global access covers a run of 64 or 128 contiguous bytes.
constexpr int EPI_COLS = 32, EPI_LD = 40;
constexpr int EPI_BYTES = CONSUMERS * 4 * 16 * EPI_LD * 4;

template <int BN>
struct Tile {
  static_assert(BN == 128 || BN == 192, "tile widths with a wgmma instance below");
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 192 ? 5 : 6;
  // 1024 bytes of slack to align the ring to the swizzle's 1024-byte period;
  // the ring, each consumer warp's epilogue buffer, the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + 2 * STAGES * 8;
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.  A wait that
// lasts about ten seconds can only be a broken pipeline: it traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// 2-D TMA load of one box at (inner, outer) element coordinates
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int inner,
                                         int outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
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

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)1 << 62;
}

// D[64 x N] += A[64 x 16] . B[16 x N], bf16 in, fp32 accumulate; TA / TB = 1:
// the operand is MN-major (transposed), 0: K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


// The shapes of the attention backward (hopper_attention.cuh): m64n64 with
// both operands in shared memory (scale_d = 0 overwrites D instead of adding
// to it), and m64n64 / m64n128 with A in registers, four .b32 of bf16
// pairs per thread in the layout of an m64 accumulator's k16 slice.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k16<TA, TB>(d, da, db);
  else
    wgmma_m64n192k16<TA, TB>(d, da, db);
}

// Writes columns [32 c, 32 c + 32) of a consumer thread's fragment into its
// warp's buffer (16 rows x EPI_LD); c is a run-time value, every register
// index a compile-time one.
template <int BN, int C = 0>
__device__ __forceinline__ void stage_chunk(const float (&acc)[BN / 2], int c, float* buf,
                                            int lane) {
  if constexpr (C < BN / EPI_COLS) {
    if (c == C) {
#pragma unroll
      for (int jj = 0; jj < EPI_COLS / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = C * (EPI_COLS / 8) + jj;
          *reinterpret_cast<float2*>(buf + (lane / 4 + 8 * h) * EPI_LD + 8 * jj +
                                     2 * (lane % 4)) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    } else {
      stage_chunk<BN, C + 1>(acc, c, buf, lane);
    }
  }
}

// The epilogue of one consumer warp's 16 rows, 32 columns at a time: lane l
// owns the column pair n = col0 + 32 c + 2 (l % 16) of rows row0 + l / 16 +
// 2 i, i < 8, and epi.rows(r0, n, v) gets those 8 pairs at once (v[i] for
// row r0 + 2 i), so that it can load what they need together.
template <int BN, class Epi>
__device__ __forceinline__ void staged_epilogue(const float (&acc)[BN / 2], int row0, int col0,
                                                float* buf, const Epi& epi) {
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int c = 0; c < BN / EPI_COLS; ++c) {
    stage_chunk<BN>(acc, c, buf, lane);
    __syncwarp();
    float2 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = *reinterpret_cast<const float2*>(buf + (lane / 16 + 2 * i) * EPI_LD +
                                              2 * (lane % 16));
    __syncwarp();
    epi.rows(row0 + lane / 16, col0 + c * EPI_COLS + 2 * (lane % 16), v);
  }
}

// ------------------------------------------------------------- mainloop
// C[rows, cols] = A . B over `depth`, as tiles_m x tiles_n output tiles, each
// cut into `splits` contiguous slices of the nkb k-blocks: work item
// (tile, slice), slices fastest.  A_MN / B_MN: the operand is MN-major (see
// the head of the file).  epi(acc, row0, col0, slice, buf) is called by each
// consumer thread with its warp's 16 rows of the tile (row0 = the first)
// and that warp's epilogue buffer, for staged_epilogue; the accumulator
// fragment of lane l holds, for j < BN / 8, rows row0 + l / 4 (+ 8 for
// h = 1) and columns col0 + 8 j + 2 (l % 4) + {0, 1} at acc[4 j + 2 h + {0, 1}].
template <int BN, bool A_MN, bool B_MN, class Epi>
__device__ __forceinline__ void persistent_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                                                int tiles_m, int tiles_n, int nkb, int splits,
                                                const Epi& epi) {
  using L = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t epi0 = ring + L::STAGES * L::STAGE_BYTES;
  const uint32_t full0 = epi0 + EPI_BYTES, empty0 = full0 + 8 * L::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kps = (nkb + splits - 1) / splits;   // k-blocks per slice
  const int items = tiles_m * tiles_n * splits;

  if (warp == CONSUMERS * 4) {   // the producer warp: one thread issues every load
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int tile = it / splits, slice = it % splits;
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        const int kb1 = min(nkb, (slice + 1) * kps);
        for (int kb = slice * kps; kb < kb1; ++kb) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = ring + stage * L::STAGE_BYTES, b = a + L::A_BYTES;
          const int k0 = kb * BK;
          mbar_expect_tx(full, L::STAGE_BYTES);
          if constexpr (A_MN) {
            tma_load(a, &ta, m0, k0, full);
            tma_load(a + BOX_BYTES, &ta, m0 + BOX, k0, full);
          } else {
            tma_load(a, &ta, k0, m0, full);
          }
          if constexpr (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / BOX; ++j) tma_load(b + j * BOX_BYTES, &tb, n0 + j * BOX, k0, full);
          } else {
            tma_load(b, &tb, k0, n0, full);
          }
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups
  const int wg = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / splits, slice = it % splits;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const int kb1 = min(nkb, (slice + 1) * kps);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    int prev = -1;
    for (int kb = slice * kps; kb < kb1; ++kb) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = ring + stage * L::STAGE_BYTES + wg * BOX_BYTES;
      const uint32_t b = ring + stage * L::STAGE_BYTES + L::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = A_MN ? make_desc(a + kk * 2048, BOX_BYTES, 1024)
                                 : make_desc(a + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? make_desc(b + kk * 2048, BOX_BYTES, 1024)
                                 : make_desc(b + kk * 32, 16, 1024);
        wgmma<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous k-block's group is done: release its stage
      if (prev >= 0 && leader) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && leader) mbar_arrive(empty0 + 8 * prev);
    float* buf = reinterpret_cast<float*>(smem_raw + (epi0 - raw)) + warp * 16 * EPI_LD;
    epi(acc, m0 + 16 * warp, n0, slice, buf);
  }
}

// ------------------------------------------------------------------ host
// Host work per launch is kept small: a host-bound step pays it on every
// GEMM.  The SM count is read once per device.
constexpr int MAX_DEVICES = 64;

inline int sm_count() {
  static std::atomic<int> counts[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < MAX_DEVICES ? counts[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    n = n > 0 ? n : 1;
    if (dev < MAX_DEVICES) counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// A kernel needs its dynamic shared memory granted above 48 KB before its
// first launch on each device.  One instance per kernel function.
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<uint64_t> granted{0};   // one bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  const uint64_t bit = dev < MAX_DEVICES ? uint64_t{1} << dev : 0;
  if (bit != 0 && (granted.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the runtime has already
// loaded, so that the library links against nothing but the runtime
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return h != nullptr ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
                        : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) bf16 matrix read as boxes of box_rows x 64
// columns with the 128-byte swizzle; out-of-bounds elements read as zero.
// Needs cols % 8 == 0 and a 16-byte aligned base (TMA's stride rule).
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                              int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tile width, slices and grid for C[rows, cols] over depth: the width whose
// persistent schedule (rounds of the SMs over the work items, each item's
// k-blocks) takes least time, and for a split contraction (allow_split,
// fewer than half a wave of tiles) the scratch traffic and second pass
// counted against it.  Rates: about 5 TFLOP/s per SM of wgmma, 3 TB/s.
struct Plan {
  int bn, tiles_m, tiles_n, nkb, splits, grid;
};

inline Plan plan(int rows, int cols, int depth, bool allow_split) {
  const int P = sm_count();
  const int nkb = (depth + BK - 1) / BK;
  Plan best{};
  double best_s = 0;
  for (int bn : {192, 128}) {
    Plan p{bn, (rows + BM - 1) / BM, (cols + bn - 1) / bn, nkb, 1, 0};
    const int tiles = p.tiles_m * p.tiles_n;
    if (allow_split && 2 * tiles <= P) {
      const int s = std::max(1, std::min({8, P / tiles, nkb / 4}));
      const int kps = (nkb + s - 1) / s;
      p.splits = (nkb + kps - 1) / kps;
    }
    const int kps = (nkb + p.splits - 1) / p.splits;
    const int items = tiles * p.splits;
    p.grid = std::min(items, P);
    double t = (double)((items + P - 1) / P) * kps * (2.0 * BM * bn * BK) / 5e12;
    if (p.splits > 1) t += p.splits * (double)rows * cols * 8 / 3e12 + 3e-6;
    if (best.bn == 0 || t < best_s) {
      best = p;
      best_s = t;
    }
  }
  return best;
}

}  // namespace hg
