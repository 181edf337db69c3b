// The fp32 GEMM mainloop under ln_gemm and gemm_tn on Hopper (sm_90a): IEEE
// fp32 products and fp32 sums on the CUDA cores' FMA units (no TF32: the
// fp32 path exists so that the card and the CPU differ in summation order
// only), register-tiled, with a multi-stage shared-memory pipeline.
//
// Bound.  At the step's shapes (M = 3,856 rows, widths 768 to 3,072) an
// fp32 product does 2 K FLOP per output element against 4 (M + N) K bytes
// of operands: hundreds of FLOP per byte, so the 67 TFLOP/s of fp32 FMA
// bound it, not the 3.35 TB/s of memory.  The FMA units of an SM issue 128
// lanes a clock; what keeps them fed is how few shared-memory reads and
// instructions each FMA needs, and how many SMs have work.
//
// Tile: BM = 128 rows by BN = 128 or 64 columns, BK = 16 deep per stage.
// Warps of 32 x 64 outputs, 4 x (BN / 64) of them (256 or 128 threads);
// lane l of a warp owns the rows 4 (l / 8) + [0, 4) and 16 + 4 (l / 8) +
// [0, 4) and the columns 4 (l % 8) + [0, 4) and 32 + 4 (l % 8) + [0, 4) of
// its warp's tile: an 8 x 8 accumulator as 2 x 2 blocks of 4 x 4.  Both
// operands lie k-major in shared memory ([BK][BM + 4], [BK][BN + 4]), so a
// thread's fragments for one k are four 16-byte reads, free of bank
// conflicts (the A reads are broadcasts): 4 reads per 64 FMAs, where a 4 x
// 4 tile of scalars read 8 per 16.  An SM holds 16 warps (two 128-column
// CTAs, or four 64-column ones, within its 64 K registers).  Shared memory
// serves 128 bytes a clock, so those reads ask as many cycles of it as the
// FMAs ask of the FMA units: with one barrier a slab and the register
// route's stores on top, the kernels read 50-61% of the fp32 rate at the
// step's shapes on an H100, a little under cuBLAS's fp32 GEMMs there
// (PERF.md section 6 has the times).
//
// Operands reach shared memory by one of two routes:
//   k-major in memory (both operands of gemm_tn, (M, width) row-major with
//     M the contraction; ln_gemm's weight stored (K, N)): 16-byte cp.async
//     straight into a ring of STAGES stages, STAGES - 1 slabs in flight;
//   k-contiguous in memory (ln_gemm's A (M, K) and its weight stored (N,
//     K)): 16-byte loads into registers issued for slab t + 1 before the
//     FMAs of slab t, then the LayerNorm applied in registers (A only) and
//     the four k values stored transposed into the next stage (see Rows).
// One __syncthreads per slab.  Out-of-range rows, columns and depths are
// zero-filled (cp.async's source size 0, or zeros in registers), so ragged
// shapes need no padding; the epilogue masks its stores.
//
// Each output element has one owner thread, which adds its products in k
// order with fmaf: the same bits on every call, no atomics.  The epilogue
// stages the accumulators through the operand ring as a [BM][BN + 4] fp32
// tile, then walks it 4 columns a thread, so every global access is a
// 16-byte vector and a warp covers whole rows.
//
// The host plan picks ln_gemm's tile width, and gemm_tn's number of
// contraction slices (at BN = 128), per shape from a model of rounds of CTAs
// over the SMs; the plan depends only on the shape and the SM count.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_gemm.cuh"   // hg::sm_count, hg::allow_smem

namespace sg {

constexpr int BM = 128, BK = 16, STAGES = 4, PAD = 4;
constexpr int LDA = BM + PAD;

template <int BN>
struct Tile {
  static_assert(BN == 128 || BN == 64, "tile widths with a thread layout below");
  static constexpr int THREADS = 2 * BN;                  // 4 x BN / 64 warps
  static constexpr int MIN_CTAS = 256 / BN;               // 16 warps per SM
  static constexpr int LDB = BN + PAD;
  static constexpr int A_FLOATS = BK * LDA, STAGE = A_FLOATS + BK * LDB;
  static constexpr int LDC = BN + PAD;                    // the epilogue's staged tile
  static constexpr int FLOATS = STAGES * STAGE > BM * LDC ? STAGES * STAGE : BM * LDC;
  static constexpr int SMEM = 4 * FLOATS;
};

// A thread's first row and column in the CTA tile (see above)
__device__ __forceinline__ int2 thread_origin() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return make_int2(32 * (warp % 4) + 4 * (lane / 8), 64 * (warp / 4) + 4 * (lane % 8));
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ operands
// An operand of R rows of the output tile (R = BM for A, BN for B), read
// either k-major (element (k, r) at p[k ld + r0 + r]) or k-contiguous
// (element (r, k) at p[(r0 + r) ld + k]); rows at or past ``rows`` and
// depths at or past ``depth`` read as zero.  Offsets are 32-bit: the
// wrappers keep every operand under 2^31 elements.
struct Operand {
  const float* p;
  int ld, rows;
};

// One slab (BK deep) of a k-major operand by cp.async into dst [BK][R + PAD],
// by THREADS threads: a warp copies 128 contiguous floats of one k.
template <int R, int THREADS>
__device__ __forceinline__ void copy_kmajor(float* dst, const Operand& op, int r0, int k0,
                                            int depth) {
  constexpr int PER = BK * R / 4 / THREADS;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int kr = idx / (R / 4), c = idx % (R / 4) * 4;
    const bool ok = k0 + kr < depth && r0 + c < op.rows;
    cp_async16(dst + kr * (R + PAD) + c, op.p + (ok ? (k0 + kr) * op.ld + r0 + c : 0), ok);
  }
}

// One slab of a k-contiguous operand, in registers: chunk i of this thread is
// row (tid + i THREADS) / Q at depths 4 ((tid + i THREADS) % Q) + [0, 4), Q =
// BK / 4 chunks a row, so a warp's loads read 8 rows' 64 contiguous bytes
// each (whole sectors, few lines); its transposed stores of one k are at most
// 2-way bank conflicted (rows padded by 4).
template <int R, int THREADS>
struct Rows {
  static constexpr int PER = BK * R / 4 / THREADS, Q = BK / 4;
  float4 v[PER];

  __device__ __forceinline__ void load(const Operand& op, int r0, int k0, int depth) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / Q, k = k0 + idx % Q * 4;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < op.rows && k < depth)
        v[i] = *reinterpret_cast<const float4*>(op.p + (r0 + r) * op.ld + k);
    }
  }

  // stored transposed into dst [BK][R + PAD]; with ln_w, x -> ((x - mean)
  // rstd) ln_w + ln_b on the in-range elements, stats[i] the (mean, rstd) of
  // chunk i's row
  __device__ __forceinline__ void store(float* dst, int r0, int k0, int depth, const float* ln_w,
                                        const float* ln_b, const float2 (&stats)[PER],
                                        int rows) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / Q, kc = idx % Q * 4;
      float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      if (ln_w != nullptr && r0 + r < rows && k0 + kc < depth) {
        const float4 w = *reinterpret_cast<const float4*>(ln_w + k0 + kc);
        const float4 b = *reinterpret_cast<const float4*>(ln_b + k0 + kc);
        const float wv[4] = {w.x, w.y, w.z, w.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = ((x[q] - stats[i].x) * stats[i].y) * wv[q] + bv[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[(kc + q) * (R + PAD) + r] = x[q];
    }
  }
};

// ------------------------------------------------------------------ mainloop
// acc[i][j] += sum over the slabs [kb0, kb1) of A(row_i, k) B(k, col_j) for
// this thread's rows and columns (see the layout above), m0 / n0 the tile's
// first row / column, depth the contraction's extent.  A_KM / B_KM: the
// operand is k-major (cp.async) rather than k-contiguous (registers).  With
// ln_w (A k-contiguous only), A's rows go through the LayerNorm with
// stats[m] = (mean, rstd).  Leaves the ring free for the epilogue.
template <int BN, bool A_KM, bool B_KM>
__device__ __forceinline__ void mainloop(const Operand& a, const Operand& b, int m0, int n0,
                                         int kb0, int kb1, int depth, const float* ln_w,
                                         const float* ln_b, const float2* stats, float* smem,
                                         float (&acc)[8][8]) {
  using T = Tile<BN>;
  constexpr int THREADS = T::THREADS;
  using RowsA = Rows<BM, THREADS>;
  using RowsB = Rows<BN, THREADS>;
  const int2 o = thread_origin();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  RowsA ra;
  RowsB rb;
  float2 st[RowsA::PER];   // the LayerNorm statistics of this thread's A rows
#pragma unroll
  for (int i = 0; i < RowsA::PER; ++i) {
    const int m = m0 + (threadIdx.x + i * THREADS) / RowsA::Q;
    st[i] = !A_KM && ln_w != nullptr && m < a.rows ? stats[m] : make_float2(0.f, 0.f);
  }
  const float2 none[RowsB::PER] = {};
  auto stage = [&](int t) { return smem + (t % STAGES) * T::STAGE; };
  auto copy = [&](int t) {   // slab kb0 + t of the k-major operands, into its stage
    if constexpr (A_KM) copy_kmajor<BM, THREADS>(stage(t), a, m0, (kb0 + t) * BK, depth);
    if constexpr (B_KM)
      copy_kmajor<BN, THREADS>(stage(t) + T::A_FLOATS, b, n0, (kb0 + t) * BK, depth);
  };
  auto load = [&](int t) {   // slab kb0 + t of the k-contiguous operands, into registers
    if constexpr (!A_KM) ra.load(a, m0, (kb0 + t) * BK, depth);
    if constexpr (!B_KM) rb.load(b, n0, (kb0 + t) * BK, depth);
  };
  auto store = [&](int t) {
    if constexpr (!A_KM)
      ra.store(stage(t), m0, (kb0 + t) * BK, depth, ln_w, ln_b, st, a.rows);
    if constexpr (!B_KM)
      rb.store(stage(t) + T::A_FLOATS, n0, (kb0 + t) * BK, depth, nullptr, nullptr, none,
               b.rows);
  };

  const int nk = kb1 - kb0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) copy(s);
    cp_async_commit();
  }
  if ((!A_KM || !B_KM) && nk > 0) {
    load(0);
    store(0);
  }
#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();   // slab t's copies (this thread's) have landed
    __syncthreads();               // everyone's, and slab t - 1's reads are done
    if (t + STAGES - 1 < nk) copy(t + STAGES - 1);
    cp_async_commit();
    const bool next = t + 1 < nk;
    if ((!A_KM || !B_KM) && next) load(t + 1);
    const float* As = stage(t) + o.x;
    const float* Bs = stage(t) + T::A_FLOATS + o.y;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDA);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * LDA + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * T::LDB);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * T::LDB + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if ((!A_KM || !B_KM) && next) store(t + 1);   // stage t + 1: last read in slab t + 1 - STAGES
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The accumulators into the ring as a [BM][LDC] fp32 tile; then walk(r, c)
// for each 4-column chunk (r, c) of the tile, a warp taking whole rows.
template <int BN, typename Walk>
__device__ __forceinline__ void epilogue(const float (&acc)[8][8], float* smem, Walk&& walk) {
  using T = Tile<BN>;
  const int2 o = thread_origin();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(smem + (o.x + i % 4 + 16 * (i / 4)) * T::LDC + o.y + 32 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  __syncthreads();
#pragma unroll 1
  for (int idx = threadIdx.x; idx < BM * BN / 4; idx += T::THREADS) {
    const int r = idx / (BN / 4), c = idx % (BN / 4) * 4;
    walk(r, c, *reinterpret_cast<const float4*>(smem + r * T::LDC + c));
  }
}

// ------------------------------------------------------------------ host
// Tile width and contraction slices for C[rows, cols] over depth.  Each CTA
// takes BM x bn outputs over its slabs; several CTAs share an SM, and the
// busiest SM's CTAs set the time: ceil(items / SMs) of them, each at a
// share of the SM's FMA rate (0.254 TFMA/s at 1.98 GHz): EFF_128 for the
// 128-column tile, as gemm_tn's FMA kernel reached it on an H100, and 5%
// less for the 64-column one, whose CTAs read more operand bytes per FMA.
// A split contraction (allow_split: gemm_tn) adds its slabs, written once and
// added by split_sum_kernel, at 3 TB/s, and that launch; it keeps the
// 128-column tile, since slices fill the SMs at less cost than narrower
// tiles (and a 64-column gemm_tn CTA would spill at four CTAs an SM).
// Fitted to the step's shapes on an H100.
struct Plan {
  int bn, tiles_m, tiles_n, nkb, splits, kps;
};

constexpr double SM_FMA_S = 128 * 1.98e9;
constexpr double EFF_128 = 0.69, EFF_64 = 0.95 * EFF_128;
constexpr int MAX_SPLITS = 8;

inline Plan plan(int rows, int cols, int depth, bool allow_split) {
  const int P = hg::sm_count();
  const int nkb = std::max(1, (depth + BK - 1) / BK);
  Plan best{};
  double best_s = 0;
  for (int bn : {128, 64}) {
    if (allow_split && bn != 128) continue;
    const int tiles_m = (rows + BM - 1) / BM, tiles_n = (cols + bn - 1) / bn;
    const int tiles = tiles_m * tiles_n;
    for (int s = 1; s <= (allow_split ? MAX_SPLITS : 1); ++s) {
      const int kps = (nkb + s - 1) / s, splits = (nkb + kps - 1) / kps;
      if (splits != s) continue;   // the same slices as a smaller s
      const int per_sm = (tiles * splits + P - 1) / P;
      const double eff = bn == 128 ? EFF_128 : EFF_64;
      double t = per_sm * (double)BM * bn * kps * BK / (SM_FMA_S * eff);
      if (splits > 1) t += (splits + 1.0) * rows * (double)cols * 4 / 3e12 + 3e-6;
      if (best.bn == 0 || t < best_s) {
        best = Plan{bn, tiles_m, tiles_n, nkb, splits, kps};
        best_s = t;
      }
    }
  }
  return best;
}

}  // namespace sg
