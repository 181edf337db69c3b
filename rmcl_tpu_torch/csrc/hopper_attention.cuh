// The bf16 masked attention on Hopper (sm_90a): the forward (fwd_kernel) and
// the backward (bwd_dq_kernel, bwd_dkv_kernel) on wgmma.mma_async, bf16
// operands and fp32 accumulators in registers.
//
// Replaces (JAX package, Pallas on the TPU) the attention math of
//   rmcl_tpu/ops/pallas_block.py:_attn_fwd_math, inside _half_block_kernel and
//     _attn_train_kernel (forward), and _attn_bwd_math, inside
//     _half_block_dx_kernel, _bwd_impl and _attn_train_bwd_impl (kRound =
//     true: the block halves)
//   rmcl_tpu/ops/pallas_attention.py:_attn_kernel (forward) and
//     _attn_bwd_kernel (kRound = false: the attention core of the unfused
//     block)
// Given q, k, v (B, H, S, D) through (b, h, s) element strides shared by the
// three, the key mask (B, S) and, for the backward, g (the gradient at the
// attention output), with s = q.k^T scale + key bias (0, -1e30 for a masked
// key, -inf past S) and p = softmax(s) in fp32:
//   forward  o = bf16(bf16(p) . v), P.V summed in fp32 (both layouts round P
//            at the same point)
//   dp = g . v^T (fp32)     delta = sum_t dp p
//   kRound   ds = bf16(p (dp - delta) scale)   pb = bf16(p)
//            dq = bf16(ds . k)   dk = bf16(ds^T . q)   dv = bf16(pb^T . g)
//   !kRound  ds = p (dp - delta), fp32 and unscaled
//            dq = bf16(scale (ds . k))   dk = bf16(scale (ds^T . q))   dv = bf16(p^T . g)
//
// What bounds them on an H100.  At the step's B=16, S=241, H=12, D=64 every
// (B, H, S, D) bf16 operand is 5.9 MB.  The forward moves q, k, v and o:
// 7.1 us at 3.35 TB/s, against 1.9 us for its two S x S x D products (3.2
// GFLOP on 64-padded tiles) at 989 TFLOP/s, and it takes some 12.6 M
// exponentials.  The backward moves q, k, v, g, dq, dk, dv: 12.4 us, against
// 1.9 us for its 5 products; this design recomputes (9 products, about 14.5
// GFLOP, some 38 M exponentials), so it sits on the tensor cores and the
// MUFU, not on the bytes.  Both are bound by bytes at their least.
//
// The forward, one warpgroup per (64-query tile, head, sample): the Q tile is
// loaded once; the kernel walks the key tiles with K, V and the key bias
// double-buffered.  Per tile: S = Q.K^T, the online row max m and sum l on
// the accumulator rows, e = exp(s - m) rounded to bf16 as the A fragments of
// O = alpha O + E.V; the store multiplies each row by 1 / l.  These are the
// fp32 forward's steps (simt_attention.cuh: l summed from the fp32 e, o
// divided by l at the end) with e rounded before P.V, where the Pallas
// kernels round the normalised p: both sit within one bf16 rounding of the
// plain version.
//
// The backward, two kernels, so that every output element has one owner and
// nothing is accumulated across blocks (no atomics; every sum in a fixed
// order, so two calls give the same bits):
//   bwd_dq   one warpgroup per (64-query tile, head, sample).  The Q and g
//            tiles are loaded once; the kernel walks the key tiles twice.
//            Pass 0: S = Q.K^T and dP = g.V^T, the online row statistics
//            m, l and sum_t e^(s - m) dp (rescaled as in the forward).
//            Pass 1: S and dP again, ds in registers, dQ += dS.K.  m, l and
//            delta go to the (B, H, S, 3) fp32 stats scratch.  The forward
//            cannot hand over m and l to save pass 0: delta needs g, and
//            FlashAttention's delta = rowsum(g o) would take the forward's
//            bf16-rounded o in place of sum p v in fp32, moving the Pallas
//            kernels' rounding points.
//   bwd_dkv  one warpgroup per (64-key tile, head, sample), launched after
//            it: K and V loaded once; for each query tile S^T = K.Q^T and
//            dP^T = V.g^T, p and ds from stats, dV += P^T.g and dK += dS^T.Q.
// s and dp come from m64n64k16 wgmma with both operands in shared memory,
// K-major.  Their fp32 accumulator fragments become the A operand of the
// next product in registers (FlashAttention-3's layout identity: the n8
// column blocks 2 kk and 2 kk + 1 of an m64 accumulator hold exactly the A
// fragment of its k16 slice kk), and the B operand of those products is the
// same shared tile read MN-major through the transpose bit: no operand is
// transposed in memory and no S x S tile passes through shared memory.
//
// Rounding.  The forward's and kRound's products take bf16 operands only (e,
// ds and pb are rounded where the kernels they replace round them), so wgmma
// with fp32 accumulation meets those rounding points exactly; only the order
// of the fp32 sums differs.  !kRound's A operands (ds and p) are fp32: each
// is fed as a pair hi = bf16(x), lo = bf16(x - hi), two wgmma into one fp32
// accumulator.  The pair carries 16 significant bits (relative error about
// 2^-17), far below the bf16 rounding of the outputs (2^-9); TF32 (10 bits)
// would not be.
//
// Tiles.  Every operand tile is 64 rows by D, padded with zeros to DP = 64 or
// 128 columns, stored as boxes of 64 columns: 128-byte rows with the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), 8 KB a box, the
// layout of hopper_gemm.cuh's K-major and MN-major descriptors.  They arrive
// by cp.async, 16 bytes a thread, zero-filled past S and past D, double-
// buffered over the walked tiles so that the next tile's copy overlaps this
// tile's products.  cp.async rather than TMA: any strides that q, k and v
// share, D = 8, ragged S, and no host-side tensor maps on a host-bound path.
// It needs 16-byte aligned bases and strides, and D a multiple of 8: the
// launchers refuse anything else.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace hattn {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                 // queries or keys of a tile: the m64 of wgmma
constexpr int THREADS = 128;             // one warpgroup
constexpr int BOX_BYTES = TILE * 128;    // 64 rows of one 64-column box
constexpr float NEG_BIAS = -1e30f;

struct Strides {   // element strides (b, h, s) of a (B, H, S, D) operand, d contiguous
  long long b, h, s;
};

template <int DP>
struct Smem {
  static constexpr int TILE_BYTES = DP / 64 * BOX_BYTES;
  // 1024 bytes of slack to align to the swizzle's period; the operand tiles
  // (fwd: Q, then K and V twice; dq: Q, g, then K and V twice; dkv: K, V,
  // then Q and g twice); the key bias (fwd, dq) or the query statistics
  // (dkv) of both buffers
  static constexpr int FWD = 1024 + 5 * TILE_BYTES + 2 * TILE * 4;
  static constexpr int DQ = 1024 + 6 * TILE_BYTES + 2 * TILE * 4;
  static constexpr int DKV = 1024 + 6 * TILE_BYTES + 2 * TILE * 3 * 4;
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the threads' copies into shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps A fragments live and unmoved until the wgmma that reads them is waited for
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- operands
// Rows [row0, row0 + 64) of a (S, D) bf16 operand (row stride ld elements)
// into a (64, DP) tile at dst; rows past S and columns past D read as zero.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long ld, int row0,
                                          int S, int D) {
  constexpr int CPR = DP / 8;   // 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < TILE * CPR / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / CPR, cc = i % CPR;
    const bool ok = row0 + r < S && cc * 8 < D;
    const bf16* p = ok ? src + (long long)(row0 + r) * ld + cc * 8 : src;
    cp_async16(dst + (cc / 8) * BOX_BYTES + r * 128 + (((cc % 8) ^ (r % 8)) << 4), p, ok);
  }
}

// k16 step kk of a (64, DP) tile read K-major (the contraction along its
// columns): box kk / 4, 32 bytes a step within it, 8-row atoms 1024 apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return hg::make_desc(tile + (kk / 4) * BOX_BYTES + (kk % 4) * 32, 16, 1024);
}
// k16 step kk of the same tile read MN-major (the contraction along its
// rows, N along its columns): 16 rows a step, boxes BOX_BYTES apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return hg::make_desc(tile + kk * 2048, BOX_BYTES, 1024);
}

// acc (64 x 64) = A . B^T over DP, A and B both (64, DP) tiles, K-major
template <int DP>
__device__ __forceinline__ void mma_nt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    hg::wgmma_m64n64k16_ss<0, 0>(acc, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// acc (64 x DP) += A . B over 64, A the four k16 fragments in registers, B a
// (64, DP) tile read MN-major
template <int DP>
__device__ __forceinline__ void mma_rn(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DP == 64)
      hg::wgmma_m64n64k16_rs<1>(acc, a[kk], desc_mn(b, kk));
    else
      hg::wgmma_m64n128k16_rs<1>(acc, a[kk], desc_mn(b, kk));
  }
}

// The A fragments of a 64 x 64 fp32 fragment x: bf16(x), and for an fp32
// operand also lo = bf16(x - bf16(x)).  Register 2i of k16 slice kk holds
// elements 8 kk + 2i and 8 kk + 2i + 1 of the fragment.
template <bool kLo>
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[8 * kk + 2 * i], x1 = x[8 * kk + 2 * i + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      hi[kk][i] = *reinterpret_cast<uint32_t*>(&h);
      if constexpr (kLo) {
        const float2 hf = __bfloat1622float2(h);
        lo[kk][i] = pack_bf16(x0 - hf.x, x1 - hf.y);
      }
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows 16 warp + lane / 4 + 8 hh (hh < 2) of an m64 accumulator belong to a
// thread, with columns 8 j + 2 (lane % 4) + e of n8 block j at element
// 4 j + 2 hh + e.  Writes those rows (< S) and columns (< D) of out, row hh
// times mul[hh].
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], bf16* out, long long ld,
                                           int row0, int S, int D, const float (&mul)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 16 * warp + lane / 4 + 8 * hh;
    if (r >= S) continue;
    bf16* row = out + (long long)r * ld;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      if (c < D)
        *reinterpret_cast<uint32_t*>(row + c) =
            pack_bf16(acc[4 * j + 2 * hh] * mul[hh], acc[4 * j + 2 * hh + 1] * mul[hh]);
    }
  }
}
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], bf16* out, long long ld,
                                           int row0, int S, int D, float mul) {
  const float both[2] = {mul, mul};
  store_rows(acc, out, ld, row0, S, D, both);
}

// ------------------------------------------------------------- kernels
template <int DP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           Strides in, const int32_t* __restrict__ mask, bf16* __restrict__ out, Strides os,
           int S, int D, float scale) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sKV = sQ + L::TILE_BYTES;   // K then V of buffer i at sKV + 2 i TILE_BYTES
  float* kbias = reinterpret_cast<float*>(smem_raw + (sQ - raw) + 5 * L::TILE_BYTES);

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const bf16* kh = k + b * in.b + h * in.h;
  const bf16* vh = v + b * in.b + h * in.h;
  const int nk = (S + TILE - 1) / TILE;

  auto load_keys = [&](int t, int buf) {
    const uint32_t kt = sKV + 2 * buf * L::TILE_BYTES;
    load_tile<DP>(kt, kh, in.s, t * TILE, S, D);
    load_tile<DP>(kt + L::TILE_BYTES, vh, in.s, t * TILE, S, D);
    if (tid < TILE) {   // keys past S take no weight at all; masked keys the -1e30 bias
      const int s = t * TILE + tid;
      kbias[buf * TILE + tid] =
          s < S ? (mask[(long long)b * S + s] > 0 ? 0.f : NEG_BIAS) : -INFINITY;
    }
  };
  load_tile<DP>(sQ, q + b * in.b + h * in.h, in.s, q0, S, D);
  load_keys(0, 0);
  cp_async_commit();

  // per row hh of this thread: running max and sum of e^(s - m)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    if (it + 1 < nk) {
      load_keys(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sK = sKV + 2 * buf * L::TILE_BYTES, sV = sK + L::TILE_BYTES;
    const float* kb = kbias + buf * TILE;

    float s[32];
    hg::wgmma_fence();
    mma_nt<DP>(s, sQ, sK);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(s);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m_run[hh];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = x * scale + kb[8 * j + 2 * (lane % 4) + e];
          mx = fmaxf(mx, x);
        }
      // a tile whose keys are all masked gives a max near -1e30; a later
      // valid key rescales everything gathered so far by exp(-1e30) = 0
      mx = quad_max(mx);
      const float alpha = expf(m_run[hh] - mx);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = expf(x - mx);
          ls += x;
        }
      l_run[hh] = l_run[hh] * alpha + quad_sum(ls);
      m_run[hh] = mx;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 2 * hh] *= alpha;
        acc[4 * j + 2 * hh + 1] *= alpha;
      }
    }
    // O += bf16(e) . V: the e of this tile as A fragments, V read MN-major
    uint32_t pe[4][4], unused[4][4];
    to_frags<false>(s, pe, unused);
    fence_frag(pe);
    hg::fence_acc(acc);
    hg::wgmma_fence();
    mma_rn<DP>(acc, pe, sV);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(acc);
    fence_frag(pe);
    __syncthreads();   // this buffer is consumed: the next step's copy may overwrite it
  }

  const float inv_l[2] = {1.f / l_run[0], 1.f / l_run[1]};
  store_rows(acc, out + b * os.b + h * os.h, os.s, q0, S, D, inv_l);
}

template <int DP, bool kRound>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, Strides in, const int32_t* __restrict__ mask,
              const bf16* __restrict__ g, Strides gs, bf16* __restrict__ dq, Strides os,
              float* __restrict__ stats, int S, int D, float scale) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u, sG = sQ + L::TILE_BYTES;
  const uint32_t sKV = sQ + 2 * L::TILE_BYTES;   // K then V of buffer i at sKV + 2 i TILE_BYTES
  float* kbias = reinterpret_cast<float*>(smem_raw + (sQ - raw) + 6 * L::TILE_BYTES);

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* kh = k + b * in.b + h * in.h;
  const bf16* vh = v + b * in.b + h * in.h;
  const int nk = (S + TILE - 1) / TILE, steps = 2 * nk;

  auto load_keys = [&](int t, int buf) {
    const uint32_t kt = sKV + 2 * buf * L::TILE_BYTES;
    load_tile<DP>(kt, kh, in.s, t * TILE, S, D);
    load_tile<DP>(kt + L::TILE_BYTES, vh, in.s, t * TILE, S, D);
    if (tid < TILE) {   // keys past S take no weight at all; masked keys the -1e30 bias
      const int s = t * TILE + tid;
      kbias[buf * TILE + tid] =
          s < S ? (mask[(long long)b * S + s] > 0 ? 0.f : NEG_BIAS) : -INFINITY;
    }
  };
  load_tile<DP>(sQ, q + b * in.b + h * in.h, in.s, q0, S, D);
  load_tile<DP>(sG, g + b * gs.b + h * gs.h, gs.s, q0, S, D);
  load_keys(0, 0);
  cp_async_commit();

  // per row hh of this thread: running max, sum of e^(s - m), sum of e^(s - m) dp
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, a_run[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < steps) {
      load_keys((it + 1) % nk, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sK = sKV + 2 * buf * L::TILE_BYTES, sV = sK + L::TILE_BYTES;
    const float* kb = kbias + buf * TILE;

    float s[32], dp[32];
    hg::wgmma_fence();
    mma_nt<DP>(s, sQ, sK);
    mma_nt<DP>(dp, sG, sV);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(s);
    hg::fence_acc(dp);

    if (it < nk) {   // pass 0: the row statistics
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m_run[hh];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hh + e];
            x = x * scale + kb[8 * j + 2 * (lane % 4) + e];
            mx = fmaxf(mx, x);
          }
        // a tile whose keys are all masked gives a max near -1e30; a later
        // valid key rescales everything gathered so far by exp(-1e30) = 0
        mx = quad_max(mx);
        const float alpha = expf(m_run[hh] - mx);
        float ls = 0.f, as = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const float p = expf(s[i] - mx);
            ls += p;
            as += p * dp[i];
          }
        l_run[hh] = l_run[hh] * alpha + quad_sum(ls);
        a_run[hh] = a_run[hh] * alpha + quad_sum(as);
        m_run[hh] = mx;
      }
    } else {         // pass 1: ds, dQ += dS . K
      if (it == nk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          inv_l[hh] = 1.f / l_run[hh];
          delta[hh] = a_run[hh] / l_run[hh];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const float p =
                expf(s[i] * scale + kb[8 * j + 2 * (lane % 4) + e] - m_run[hh]) * inv_l[hh];
            const float x = p * (dp[i] - delta[hh]);
            s[i] = kRound ? x * scale : x;
          }
      uint32_t hi[4][4], lo[4][4];
      to_frags<!kRound>(s, hi, lo);
      fence_frag(hi);
      if constexpr (!kRound) fence_frag(lo);
      hg::fence_acc(acc);
      hg::wgmma_fence();
      mma_rn<DP>(acc, hi, sK);
      if constexpr (!kRound) mma_rn<DP>(acc, lo, sK);
      hg::wgmma_commit();
      hg::wgmma_wait<0>();
      hg::fence_acc(acc);
      fence_frag(hi);
      if constexpr (!kRound) fence_frag(lo);
    }
    __syncthreads();   // this buffer is consumed: the next step's copy may overwrite it
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + 16 * warp + lane / 4 + 8 * hh;
    if (r < S && lane % 4 == 0) {
      float* st = stats + (((long long)b * gridDim.y + h) * S + r) * 3;
      st[0] = m_run[hh];
      st[1] = l_run[hh];
      st[2] = delta[hh];
    }
  }
  store_rows(acc, dq + b * os.b + h * os.h, os.s, q0, S, D, kRound ? 1.f : scale);
}

template <int DP, bool kRound>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, Strides in, const int32_t* __restrict__ mask,
               const bf16* __restrict__ g, Strides gs, const float* __restrict__ stats,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Strides os, int S, int D,
               float scale) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u, sV = sK + L::TILE_BYTES;
  const uint32_t sQG = sK + 2 * L::TILE_BYTES;   // Q then g of buffer i at sQG + 2 i TILE_BYTES
  const uint32_t sSt = sK + 6 * L::TILE_BYTES;   // (64, 3) fp32 statistics of buffer i at + 768 i
  const float* st_all = reinterpret_cast<const float*>(smem_raw + (sSt - raw));

  const int t0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* qh = q + b * in.b + h * in.h;
  const bf16* gh = g + b * gs.b + h * gs.h;
  const float* sbase = stats + ((long long)b * gridDim.y + h) * S * 3;
  const int nq = (S + TILE - 1) / TILE;

  auto load_queries = [&](int t, int buf) {
    const uint32_t qt = sQG + 2 * buf * L::TILE_BYTES;
    load_tile<DP>(qt, qh, in.s, t * TILE, S, D);
    load_tile<DP>(qt + L::TILE_BYTES, gh, gs.s, t * TILE, S, D);
    for (int i = tid; i < TILE * 3; i += THREADS)   // rows past S read as zero
      cp_async4(sSt + buf * TILE * 12 + 4 * i, sbase + (long long)t * TILE * 3 + i,
                t * TILE + i / 3 < S);
  };
  load_tile<DP>(sK, k + b * in.b + h * in.h, in.s, t0, S, D);
  load_tile<DP>(sV, v + b * in.b + h * in.h, in.s, t0, S, D);
  load_queries(0, 0);
  cp_async_commit();

  // this thread's keys (rows of S^T): t0 + 16 warp + lane / 4 + 8 hh
  float kb[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + 16 * warp + lane / 4 + 8 * hh;
    kb[hh] = t < S ? (mask[(long long)b * S + t] > 0 ? 0.f : NEG_BIAS) : -INFINITY;
  }
  float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

#pragma unroll 1
  for (int it = 0; it < nq; ++it) {
    const int buf = it & 1;
    if (it + 1 < nq) {
      load_queries(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sQ = sQG + 2 * buf * L::TILE_BYTES, sG = sQ + L::TILE_BYTES;
    const float* st = st_all + buf * TILE * 3;

    float s[32], dp[32];
    hg::wgmma_fence();
    mma_nt<DP>(s, sK, sQ);
    mma_nt<DP>(dp, sV, sG);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(s);
    hg::fence_acc(dp);

    // p and ds from the statistics of each query (a column of S^T); a query
    // past S gets p = ds = 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + e;
        const bool valid = it * TILE + c < S;
        const float m = st[3 * c], inv_l = 1.f / st[3 * c + 1], dl = st[3 * c + 2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float p = valid ? expf(s[i] * scale + kb[hh] - m) * inv_l : 0.f;
          const float x = p * (dp[i] - dl);
          s[i] = p;
          dp[i] = kRound ? x * scale : x;
        }
      }
    uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
    to_frags<!kRound>(s, p_hi, p_lo);
    to_frags<!kRound>(dp, d_hi, d_lo);
    fence_frag(p_hi);
    fence_frag(d_hi);
    if constexpr (!kRound) {
      fence_frag(p_lo);
      fence_frag(d_lo);
    }
    hg::fence_acc(acc_k);
    hg::fence_acc(acc_v);
    hg::wgmma_fence();
    mma_rn<DP>(acc_v, p_hi, sG);
    if constexpr (!kRound) mma_rn<DP>(acc_v, p_lo, sG);
    mma_rn<DP>(acc_k, d_hi, sQ);
    if constexpr (!kRound) mma_rn<DP>(acc_k, d_lo, sQ);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_acc(acc_k);
    hg::fence_acc(acc_v);
    fence_frag(p_hi);
    fence_frag(d_hi);
    if constexpr (!kRound) {
      fence_frag(p_lo);
      fence_frag(d_lo);
    }
    __syncthreads();   // this buffer is consumed: the next step's copy may overwrite it
  }

  store_rows(acc_k, dk + b * os.b + h * os.h, os.s, t0, S, D, kRound ? 1.f : scale);
  store_rows(acc_v, dv + b * os.b + h * os.h, os.s, t0, S, D, 1.f);
}

// ------------------------------------------------------------------ host
template <int DP>
cudaError_t launch_fwd_tiles(const bf16* q, const bf16* k, const bf16* v, Strides in,
                             const int32_t* mask, bf16* out, Strides os, int B, int S, int H,
                             int D, float scale, cudaStream_t stream) {
  using L = Smem<DP>;
  const cudaError_t err = hg::allow_smem<fwd_kernel<DP>>(L::FWD);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TILE - 1) / TILE, H, B);
  fwd_kernel<DP><<<grid, THREADS, L::FWD, stream>>>(q, k, v, in, mask, out, os, S, D, scale);
  return cudaGetLastError();
}

template <int DP, bool kRound>
cudaError_t launch_tiles(const bf16* q, const bf16* k, const bf16* v, Strides in,
                         const int32_t* mask, const bf16* g, Strides gs, bf16* dq, bf16* dk,
                         bf16* dv, Strides os, float* stats, int B, int S, int H, int D,
                         float scale, cudaStream_t stream) {
  using L = Smem<DP>;
  cudaError_t err = hg::allow_smem<bwd_dq_kernel<DP, kRound>>(L::DQ);
  if (err == cudaSuccess) err = hg::allow_smem<bwd_dkv_kernel<DP, kRound>>(L::DKV);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TILE - 1) / TILE, H, B);
  bwd_dq_kernel<DP, kRound><<<grid, THREADS, L::DQ, stream>>>(q, k, v, in, mask, g, gs, dq, os,
                                                              stats, S, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<DP, kRound><<<grid, THREADS, L::DKV, stream>>>(q, k, v, in, mask, g, gs, stats,
                                                                dk, dv, os, S, D, scale);
  return cudaGetLastError();
}

// What cp.async and the paired stores need: D a multiple of 8 up to 128;
// every base 16-byte aligned and every (b, h, s) stride a multiple of 8
// elements (16 bytes).
inline bool layout_ok(const void* const* ptrs, int n, const Strides* strides, int ns, int D) {
  if (D <= 0 || D > 128 || D % 8 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < ns; ++i)
    if (strides[i].b % 8 != 0 || strides[i].h % 8 != 0 || strides[i].s % 8 != 0) return false;
  return true;
}

// out (strides os) from q, k, v (strides in) and the (B, S) int32 key mask.
// Returns cudaErrorInvalidValue for a layout the kernel does not take.
inline cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, Strides in,
                              const int32_t* mask, bf16* out, Strides os, int B, int S, int H,
                              int D, float scale, cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, out};
  const Strides strides[] = {in, os};
  if (!layout_ok(ptrs, 4, strides, 2, D)) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  return D <= 64 ? launch_fwd_tiles<64>(q, k, v, in, mask, out, os, B, S, H, D, scale, stream)
                 : launch_fwd_tiles<128>(q, k, v, in, mask, out, os, B, S, H, D, scale, stream);
}

// dq, dk, dv (strides os) and the (B, H, S, 3) fp32 stats scratch from q, k,
// v (strides in), the (B, S) int32 key mask and g (strides gs).  Returns
// cudaErrorInvalidValue for a layout the kernels do not take.
template <bool kRound>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, Strides in,
                       const int32_t* mask, const bf16* g, Strides gs, bf16* dq, bf16* dk,
                       bf16* dv, Strides os, float* stats, int B, int S, int H, int D,
                       float scale, cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, g, dq, dk, dv};
  const Strides strides[] = {in, gs, os};
  if (!layout_ok(ptrs, 7, strides, 3, D)) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  return D <= 64 ? launch_tiles<64, kRound>(q, k, v, in, mask, g, gs, dq, dk, dv, os, stats, B,
                                            S, H, D, scale, stream)
                 : launch_tiles<128, kRound>(q, k, v, in, mask, g, gs, dq, dk, dv, os, stats,
                                             B, S, H, D, scale, stream);
}

}  // namespace hattn
