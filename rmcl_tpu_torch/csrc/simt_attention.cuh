// The fp32 masked attention on Hopper (sm_90a): the forward (fwd_kernel) and
// the backward (bwd_dq_kernel, then bwd_dkv_kernel) as register-tiled FMA
// products on the CUDA cores: IEEE fp32 products and sums, no TF32, so that
// the card and the CPU differ in summation order only.
//
// Replaces (JAX package, Pallas on the TPU), in fp32 (compute_dtype="float32"),
// the attention math of
//   rmcl_tpu/ops/pallas_attention.py:_attn_kernel :53 (forward) and
//     _attn_bwd_kernel :119 (kRound = false: the attention core of the
//     unfused block, rows 10 and 11 of the kernel table)
//   rmcl_tpu/ops/pallas_block.py:_half_block_kernel :112 (its attention core,
//     _attn_fwd_math; also inside _attn_train_kernel) and _attn_bwd_math :221
//     (kRound = true: the block halves' backward, rows 3, 9 and 2)
// bf16 runs hopper_attention.cuh with the same two-kernel scheme on wgmma.
// Given q, k, v (B, H, S, D) through (b, h, s) element strides shared by the
// three, the key mask (B, S) and, for the backward, g, with s = q.k^T scale +
// key bias (0, -1e30 for a masked key, -inf past S) and p = softmax(s):
//   forward  o = (sum_t e_t v_t) / l, e = exp(s - m) in fp32, l = sum_t e_t
//   dp = g . v^T        delta = sum_t dp p (the Pallas bodies' delta, not
//                       rowsum(g o))
//   kRound   ds = p (dp - delta) scale   dq = ds . k   dk = ds^T . q
//   !kRound  ds = p (dp - delta)         dq = scale (ds . k)   dk = scale (ds^T . q)
//   dv = p^T . g
// In fp32 the two rounding sets differ only in where scale multiplies.
//
// Bound.  At the step's B = 16, S = 241, H = 12, D = 64 the forward's two
// S x S x D products are 2.86 GFLOP and the backward's five 7.14 GFLOP: at
// the 67 TFLOP/s of fp32 FMA on an H100 (128 lanes x 132 SMs x 1.98 GHz)
// 0.0427 and 0.107 ms, against 0.014 and 0.025 ms for their bytes at 3.35
// TB/s: operations bound them.  The FMA units issue one warp instruction a
// clock per SM sub-partition; what keeps them fed is how few shared-memory
// reads and other instructions each FMA needs.
//
// Shared memory is what runs out first: an LDS.128 delivers 512 bytes to a
// warp in four of the SM's 128-byte clocks, broadcast or not, so a product
// is FMA-bound only where a thread reads at most a quarter of a float per
// FMA.
//
// Design.  A CTA of 128 threads owns BR = 64 rows of one (sample, head):
// queries in fwd_kernel and bwd_dq_kernel, keys in bwd_dkv_kernel.  It keeps
// their operands in shared memory and walks the other side in tiles of BC =
// 32 rows (keys; queries for bwd_dkv), double-buffered by cp.async: tile t +
// 1 is in flight while tile t is multiplied, one barrier a tile.  Thread
// (ty, tx) = (tid / 8, tid % 8) owns the rows ty + 16 i (i < 4) and, of a
// tile, the columns tx + 8 c (c < 4): a 4 x 4 block of the score tile.  The
// scores are dot products of two d-contiguous rows, so both operands stay in
// their memory layout ([row][D + 4] fp32, 16-byte cp.async, no transpose):
// for four d a thread reads 8 float4 (LDS.128) for 64 FMAs (half a float an
// FMA), free of bank conflicts (the pad of 4 spreads the 8 column rows of a
// warp over the 32 banks; its row reads are broadcasts).  Every score is one
// fmaf chain over d = 0 ... D - 1 from 0, in all three kernels (fmaf(q, k, .)
// and fmaf(k, q, .) are the same number), so the backward's s are the
// forward's, bit for bit, then fmaf(acc, scale, bias).  The row statistics
// (max, sum of e, sum of e dp) reduce a thread's four values in order, then
// across the 8 lanes that share the row (shuffles).  The second product
// (P.V, dS.K, P^T.g, dS^T.q) takes the 4 x 32 block of p or ds through a
// scratch ([64][32], each row's columns swizzled by (row % 4) 8, no pad; only
// the warp that wrote a row reads it, so __syncwarp suffices) against the
// tile's rows: the thread owns its 4 rows times the columns 32 u + 4 tx +
// [0, 4) of D, reading 4 + D / 8 float4 per 2 D FMAs (3 / 8 of a float an
// FMA at D = 64), summed over the tile's rows in order.  p multiplies e by
// 1 / l, once per row, in place of a division per element.
// The kernels are compiled for the head dimension DP in {32, 64, 128}: the
// dispatcher rounds D up and the loads zero-fill the columns past D, so at
// ViLT's D = 64 no FMA multiplies a pad.  Rows past S are zero-filled, and
// keys past S take the -inf bias: S = 241 runs a ragged last tile, masked,
// with no padding of the inputs.  Operands whose base and strides are
// multiples of 16 bytes (every layout of the port at D % 4 == 0) are copied
// 16 bytes at a time; any other strides 4 bytes at a time, through the same
// kernels.
// The backward keeps one owner per output and no atomics: bwd_dq walks the
// key tiles twice (pass 0: s and dp for the online m, l and sum e dp; pass
// 1: s and dp again, ds, dq += ds.k) and writes m, l, delta to the (B, H, S,
// 3) stats scratch; bwd_dkv then walks the query tiles with them (s^T and
// dp^T, p and ds, dv += p^T.g, dk += ds^T.q).  The pair computes 9 S x S x D
// products where the function needs 5: keeping pass 0's s or dp for pass 1
// would take 64 KB a CTA at S = 241.  Pass 1 writes ds over the tile's V,
// which its dp has read (a barrier), so bwd_dq needs 70 KB and an SM holds
// three CTAs (12 warps) where it held two; bwd_dkv holds two (its dk and dv
// take 220 registers a thread).
// Tiles, by measurement at S = 241 and 217 on an H100 (PERF.md section 6,
// PR 16): 4 x 4 blocks of 128-thread CTAs for all three kernels, against
// 2 x 4, 4 x 8, 8 x 4 and 2 x 8 blocks and 256-thread CTAs.  The narrower
// blocks read more floats per FMA; the wider ones double a tile's shared
// memory or a CTA's rows, so an SM holds fewer warps, and 64-column tiles
// pad S = 217 to 256.  A 256-thread 4 x 4 CTA ran the forward and bwd_dkv a
// few percent faster and bwd_dq slower; its forward is not taken because at
// DP = 32 its shared memory lets three CTAs share an SM, whose launch bound
// caps a thread at under 86 registers (65,536 / 768) where the 128-thread forward
// takes 122: a spill.  bwd_dkv keeps dk and dv (2 RT DP / 8 accumulators):
// at DP = 128 it takes two key rows a thread, so that they fit the
// registers without a spill.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "simt_gemm.cuh"   // sg::cp_async16, cp_async_commit, cp_async_wait

namespace sa {

constexpr int MAX_D = 128;
// A CTA of THREADS = 8 TY threads, thread (ty, tx) = (tid / 8, tid % 8); its
// rows (BR = TY RT) and a streamed tile's rows (BC = 8 CT).  The p / ds
// scratch is [BR][BC] with the columns of row r swizzled by (r % 4) 8
// (``at``): a warp's stores (4 rows x 8 lanes) and its float4 reads (4 rows)
// meet no bank twice, without a pad.
template <int TY_, int RT_, int CT_>
struct Tiles {
  static constexpr int TY = TY_, RT = RT_, CT = CT_, THREADS = 8 * TY;
  static constexpr int BR = TY * RT, BC = 8 * CT;
  __device__ static __forceinline__ int at(int r, int j) { return r * BC + (j ^ ((r & 3) << 3)); }
};
using FwdTiles = Tiles<16, 4, 4>;
using DqTiles = Tiles<16, 4, 4>;
template <int DP>
using DkvTiles = Tiles<16, DP == 128 ? 2 : 4, 4>;

// CTAs an SM holds with ``bytes`` of shared memory each (at most 3: the
// register cap of the launch bounds then stays at 170)
constexpr int ctas_for(int bytes) {
  return 232448 / (bytes + 1024) < 1 ? 1 : 232448 / (bytes + 1024) > 3 ? 3
                                                                        : 232448 / (bytes + 1024);
}
constexpr float NEG_BIAS = -1e30f;

struct Strides {   // element strides of a (B, H, S, D) operand, d contiguous
  long long b, h, s;
  __host__ __device__ __forceinline__ long long at(int bb, int hh, int ss) const {
    return bb * b + hh * h + ss * s;
  }
};

// 4-byte cp.async (the .ca form: .cg takes 16 bytes only); ok = false writes 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// R rows of an operand, rows row0 + [0, R) of one (sample, head) at base with
// row stride rs, into dst [R][DP + 4]: rows at or past S and columns at or
// past D read as zero.  vec: 16-byte copies (base, rs and D multiples of 4
// floats), else 4-byte ones.
template <int R, int DP, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* base, long long rs, int row0,
                                          int S, int D, bool vec) {
  constexpr int CH = DP / 4, LD = DP + 4, PER = R * CH / THREADS;
  static_assert(R * CH % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CH, c = idx % CH * 4, s = row0 + r;
    float* d = dst + r * LD + c;
    const float* src = base + (long long)s * rs + c;
    if (vec) {
      const bool ok = s < S && c < D;
      sg::cp_async16(d, ok ? src : base, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = s < S && c + e < D;
        cp_async4(d + e, ok ? src + e : base, ok);
      }
    }
  }
}

// acc[i][c] += sum over d of A[ty + TY i][d] B[tx + 8 c][d], one fmaf chain per
// element in d order; A and B [rows][DP + 4]
template <typename T, int DP>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, int ty, int tx,
                                         float (&acc)[T::RT][T::CT]) {
  constexpr int LD = DP + 4, RT = T::RT, CT = T::CT, TY = T::TY;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 a[RT], b[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + TY * i) * LD + d);
#pragma unroll
    for (int c = 0; c < CT; ++c) b[c] = *reinterpret_cast<const float4*>(B + (tx + 8 * c) * LD + d);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        acc[i][c] = fmaf(a[i].x, b[c].x, acc[i][c]);
        acc[i][c] = fmaf(a[i].y, b[c].y, acc[i][c]);
        acc[i][c] = fmaf(a[i].z, b[c].z, acc[i][c]);
        acc[i][c] = fmaf(a[i].w, b[c].w, acc[i][c]);
      }
  }
}

// o[i][4 u + e] += sum over j < BC of P[ty + TY i][j] V[j][32 u + 4 tx + e], in
// j order; P the scratch (T::at; this warp's rows), V [BC][DP + 4]
template <typename T, int DP>
__device__ __forceinline__ void pv_tile(const float* P, const float* V, int ty, int tx,
                                        float (&o)[T::RT][DP / 8]) {
  constexpr int LD = DP + 4, U = DP / 32, RT = T::RT, TY = T::TY;
#pragma unroll 2
  for (int j = 0; j < T::BC; j += 4) {
    float4 p[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + T::at(ty + TY * i, j));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = *reinterpret_cast<const float4*>(V + (j + jj) * LD + 32 * u + 4 * tx);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float pj = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          o[i][4 * u] = fmaf(pj, v[u].x, o[i][4 * u]);
          o[i][4 * u + 1] = fmaf(pj, v[u].y, o[i][4 * u + 1]);
          o[i][4 * u + 2] = fmaf(pj, v[u].z, o[i][4 * u + 2]);
          o[i][4 * u + 3] = fmaf(pj, v[u].w, o[i][4 * u + 3]);
        }
      }
    }
  }
}

// over the 8 lanes that share a row (lanes 8 (lane / 8) + [0, 8))
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// a thread's values of a row: their max, and their sum in order
template <int CT>
__device__ __forceinline__ float max_of(const float (&x)[CT]) {
  float m = x[0];
#pragma unroll
  for (int c = 1; c < CT; ++c) m = fmaxf(m, x[c]);
  return m;
}
template <int CT>
__device__ __forceinline__ float sum_of(const float (&x)[CT]) {
  float t = x[0];
#pragma unroll
  for (int c = 1; c < CT; ++c) t += x[c];
  return t;
}

// the key bias of key t: 0 valid, -1e30 masked, -inf past S
__device__ __forceinline__ float key_bias(int t, int S, int m) {
  return t < S ? (m > 0 ? 0.f : NEG_BIAS) : -INFINITY;
}

// The key mask of a streamed key tile, n ints into dst
__device__ __forceinline__ void copy_mask(int* dst, const int32_t* mrow, int c0, int n, int S) {
  if (threadIdx.x < n) {
    const int c = c0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, c < S ? mrow + c : mrow, c < S);
  }
}

// a row's DP / 8 values (columns 32 u + 4 tx + [0, 4)) times f into row[0, D);
// vec: 16-byte stores
template <int DP>
__device__ __forceinline__ void store_row(float* row, const float* o, float f, int tx, int D,
                                          bool vec) {
#pragma unroll
  for (int u = 0; u < DP / 32; ++u) {
    const int d = 32 * u + 4 * tx;
    const float4 w = make_float4(o[4 * u] * f, o[4 * u + 1] * f, o[4 * u + 2] * f,
                                 o[4 * u + 3] * f);
    if (vec) {
      if (d < D) *reinterpret_cast<float4*>(row + d) = w;
    } else {
      const float e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d + q < D) row[d + q] = e[q];
    }
  }
}

// ------------------------------------------------------------------ forward
template <int DP, typename T>
struct FwdSmem : T {
  static constexpr int LD = DP + 4;
  static constexpr int Q = 0, KV = Q + T::BR * LD, P = KV + 2 * 2 * T::BC * LD,
                       M = P + T::BR * T::BC;
  static constexpr int BYTES = 4 * (M + 2 * T::BC), MIN_CTAS = ctas_for(BYTES);
};

template <int DP, typename T>
__global__ void __launch_bounds__(T::THREADS, FwdSmem<DP, T>::MIN_CTAS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           Strides in, const int32_t* __restrict__ mask, float* __restrict__ out, Strides os,
           int S, int D, float scale, int vec) {
  using L = FwdSmem<DP, T>;
  constexpr int LD = L::LD, BR = L::BR, BC = L::BC, NO = DP / 8;
  constexpr int RT = T::RT, CT = T::CT, TY = T::TY, THREADS = T::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + L::Q;
  float* Ps = smem + L::P;
  int* Ms = reinterpret_cast<int*>(smem + L::M);
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* kh = k + in.at(b, h, 0);
  const float* vh = v + in.at(b, h, 0);
  const int32_t* mrow = mask + (long long)b * S;
  const int nt = (S + BC - 1) / BC;
  auto kv = [&](int t) { return smem + L::KV + (t & 1) * 2 * BC * LD; };
  auto issue = [&](int t) {   // key tile t: K, V and the mask into stage t % 2
    copy_rows<BC, DP, THREADS>(kv(t), kh, in.s, t * BC, S, D, vec);
    copy_rows<BC, DP, THREADS>(kv(t) + BC * LD, vh, in.s, t * BC, S, D, vec);
    copy_mask(Ms + (t & 1) * BC, mrow, t * BC, BC, S);
  };
  copy_rows<BR, DP, THREADS>(Qs, q + in.at(b, h, 0), in.s, q0, S, D, vec);
  issue(0);
  sg::cp_async_commit();

  float m[RT], l[RT], o[RT][NO];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] = 0.f;
  }
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    sg::cp_async_wait<0>();   // tile t (and Q) landed, for this thread
    __syncthreads();          // for every thread; tile t - 1's stage is free
    if (t + 1 < nt) issue(t + 1);
    sg::cp_async_commit();
    const float* Ks = kv(t);
    const int* mk = Ms + (t & 1) * BC;
    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) s[i][c] = 0.f;
    dot_tile<T, DP>(Qs, Ks, ty, tx, s);
    float kb[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) kb[c] = key_bias(t * BC + tx + 8 * c, S, mk[tx + 8 * c]);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float x[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) x[c] = fmaf(s[i][c], scale, kb[c]);
      // a tile whose keys are all masked gives a max near -1e30; a later
      // valid key rescales everything gathered so far by exp(-1e30) = 0
      const float m_new = fmaxf(m[i], row_max(max_of(x)));
      const float alpha = expf(m[i] - m_new);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        x[c] = expf(x[c] - m_new);
        Ps[T::at(ty + TY * i, tx + 8 * c)] = x[c];
      }
      l[i] = l[i] * alpha + row_sum(sum_of(x));
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) o[i][n] *= alpha;
    }
    __syncwarp();
    pv_tile<T, DP>(Ps, Ks + BC * LD, ty, tx, o);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int s = q0 + ty + TY * i;
    if (s >= S) continue;
    float w[NO];
#pragma unroll
    for (int n = 0; n < NO; ++n) w[n] = o[i][n] / l[i];
    store_row<DP>(out + os.at(b, h, s), w, 1.f, tx, D, vec);
  }
}

// ----------------------------------------------------------------- backward
template <int DP, typename T>
struct DqSmem : T {
  static constexpr int LD = DP + 4;
  // pass 1 writes ds over the tile's V, which dp has consumed, when it fits
  // (BR rows of BC against BC rows of LD): a CTA less of shared memory
  static constexpr bool DS_IN_V = T::BR <= LD;
  static constexpr int Q = 0, G = Q + T::BR * LD, KV = G + T::BR * LD,
                       P = KV + 2 * 2 * T::BC * LD, M = P + (DS_IN_V ? 0 : T::BR * T::BC);
  static constexpr int BYTES = 4 * (M + 2 * T::BC), MIN_CTAS = ctas_for(BYTES);
};

template <int DP, typename T, bool kRound>
__global__ void __launch_bounds__(T::THREADS, DqSmem<DP, T>::MIN_CTAS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, Strides in, const int32_t* __restrict__ mask,
              const float* __restrict__ g, Strides gs, float* __restrict__ dq_out, Strides ds_,
              float* __restrict__ stats, int S, int D, float scale, int vec) {
  using L = DqSmem<DP, T>;
  constexpr int LD = L::LD, BR = L::BR, BC = L::BC, NO = DP / 8;
  constexpr int RT = T::RT, CT = T::CT, TY = T::TY, THREADS = T::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + L::Q;
  float* Gs = smem + L::G;
  int* Ms = reinterpret_cast<int*>(smem + L::M);
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* kh = k + in.at(b, h, 0);
  const float* vh = v + in.at(b, h, 0);
  const int32_t* mrow = mask + (long long)b * S;
  const int nt = (S + BC - 1) / BC;
  auto kv = [&](int t) { return smem + L::KV + (t & 1) * 2 * BC * LD; };
  auto issue = [&](int t) {   // step t: key tile t % nt into stage t % 2
    const int c0 = (t % nt) * BC;
    copy_rows<BC, DP, THREADS>(kv(t), kh, in.s, c0, S, D, vec);
    copy_rows<BC, DP, THREADS>(kv(t) + BC * LD, vh, in.s, c0, S, D, vec);
    copy_mask(Ms + (t & 1) * BC, mrow, c0, BC, S);
  };
  copy_rows<BR, DP, THREADS>(Qs, q + in.at(b, h, 0), in.s, q0, S, D, vec);
  copy_rows<BR, DP, THREADS>(Gs, g + gs.at(b, h, 0), gs.s, q0, S, D, vec);
  issue(0);
  sg::cp_async_commit();

  float m[RT], l[RT], a[RT], il[RT], dq[RT][NO];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = a[i] = il[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) dq[i][n] = 0.f;
  }
#pragma unroll 1
  for (int t = 0; t < 2 * nt; ++t) {   // pass 0: t < nt; pass 1: t >= nt
    sg::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < 2 * nt) issue(t + 1);
    sg::cp_async_commit();
    const float* Ks = kv(t);
    const int* mk = Ms + (t & 1) * BC;
    const int c0 = (t % nt) * BC;
    float s[RT][CT], dp[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) s[i][c] = dp[i][c] = 0.f;
    dot_tile<T, DP>(Qs, Ks, ty, tx, s);
    dot_tile<T, DP>(Gs, Ks + BC * LD, ty, tx, dp);
    float kb[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) kb[c] = key_bias(c0 + tx + 8 * c, S, mk[tx + 8 * c]);
    if (t < nt) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float x[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c) x[c] = fmaf(s[i][c], scale, kb[c]);
        const float m_new = fmaxf(m[i], row_max(max_of(x)));
        const float alpha = expf(m[i] - m_new);
        float ed[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          x[c] = expf(x[c] - m_new);
          ed[c] = x[c] * dp[i][c];
        }
        l[i] = l[i] * alpha + row_sum(sum_of(x));
        a[i] = a[i] * alpha + row_sum(sum_of(ed));
        m[i] = m_new;
      }
      if (t == nt - 1) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          a[i] /= l[i];   // delta = sum_t p dp
          il[i] = 1.f / l[i];
        }
      }
    } else {
      float* Ds = smem + L::P;
      if constexpr (L::DS_IN_V) {
        Ds = kv(t) + BC * LD;
        __syncthreads();   // every warp's dp has read this V
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float p = expf(fmaf(s[i][c], scale, kb[c]) - m[i]) * il[i];
          const float d = p * (dp[i][c] - a[i]);
          Ds[T::at(ty + TY * i, tx + 8 * c)] = kRound ? d * scale : d;
        }
      __syncwarp();
      pv_tile<T, DP>(Ds, Ks, ty, tx, dq);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int s = q0 + ty + TY * i;
    if (s >= S) continue;
    if (tx == 0) {
      float* st = stats + (((long long)b * gridDim.y + h) * S + s) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = a[i];
    }
    store_row<DP>(dq_out + ds_.at(b, h, s), dq[i], kRound ? 1.f : scale, tx, D, vec);
  }
}

template <int DP, typename T>
struct DkvSmem : T {
  static constexpr int LD = DP + 4;
  static constexpr int STAGE = 2 * T::BC * LD + 3 * T::BC;   // Q, g, stats of a query tile
  static constexpr int K = 0, V = K + T::BR * LD, QG = V + T::BR * LD, P = QG + 2 * STAGE,
                       DS = P + T::BR * T::BC;
  static constexpr int BYTES = 4 * (DS + T::BR * T::BC), MIN_CTAS = ctas_for(BYTES);
};

template <int DP, typename T, bool kRound>
__global__ void __launch_bounds__(T::THREADS, DkvSmem<DP, T>::MIN_CTAS)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, Strides in, const int32_t* __restrict__ mask,
               const float* __restrict__ g, Strides gs, const float* __restrict__ stats,
               float* __restrict__ dk_out, float* __restrict__ dv_out, Strides ds_, int S, int D,
               float scale, int vec) {
  using L = DkvSmem<DP, T>;
  constexpr int LD = L::LD, BR = L::BR, BC = L::BC, NO = DP / 8;
  constexpr int RT = T::RT, CT = T::CT, TY = T::TY, THREADS = T::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem + L::K;
  float* Vs = smem + L::V;
  float* Ps = smem + L::P;
  float* Ds = smem + L::DS;
  const int t0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* qh = q + in.at(b, h, 0);
  const float* gh = g + gs.at(b, h, 0);
  const float* sbase = stats + ((long long)b * gridDim.y + h) * S * 3;
  const int nt = (S + BC - 1) / BC;
  auto qg = [&](int t) { return smem + L::QG + (t & 1) * L::STAGE; };
  auto issue = [&](int t) {   // query tile t: Q, g and their rows' stats into stage t % 2
    float* st = qg(t);
    copy_rows<BC, DP, THREADS>(st, qh, in.s, t * BC, S, D, vec);
    copy_rows<BC, DP, THREADS>(st + BC * LD, gh, gs.s, t * BC, S, D, vec);
    for (int e = threadIdx.x; e < 3 * BC; e += THREADS) {
      const bool ok = t * BC + e / 3 < S;
      cp_async4(st + 2 * BC * LD + e, ok ? sbase + t * BC * 3 + e : sbase, ok);
    }
  };
  copy_rows<BR, DP, THREADS>(Ks, k + in.at(b, h, 0), in.s, t0, S, D, vec);
  copy_rows<BR, DP, THREADS>(Vs, v + in.at(b, h, 0), in.s, t0, S, D, vec);
  issue(0);
  sg::cp_async_commit();

  // this thread's keys: rows ty + TY i of the tile
  float kb[RT], dk[RT][NO], dv[RT][NO];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int t = t0 + ty + TY * i;
    kb[i] = key_bias(t, S, t < S ? mask[(long long)b * S + t] : 0);
#pragma unroll
    for (int n = 0; n < NO; ++n) dk[i][n] = dv[i][n] = 0.f;
  }
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    sg::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < nt) issue(t + 1);
    sg::cp_async_commit();
    const float* Qt = qg(t);
    const float* Gt = Qt + BC * LD;
    const float* St = Gt + BC * LD;
    float s[RT][CT], dp[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) s[i][c] = dp[i][c] = 0.f;
    dot_tile<T, DP>(Ks, Qt, ty, tx, s);
    dot_tile<T, DP>(Vs, Gt, ty, tx, dp);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int j = tx + 8 * c;
      const bool live = t * BC + j < S;   // query rows past S: p = ds = 0
      const float sm = St[3 * j], sil = 1.f / St[3 * j + 1], sd = St[3 * j + 2];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float p = 0.f, d = 0.f;
        if (live) {
          p = expf(fmaf(s[i][c], scale, kb[i]) - sm) * sil;
          d = p * (dp[i][c] - sd);
          if (kRound) d *= scale;
        }
        Ps[T::at(ty + TY * i, j)] = p;
        Ds[T::at(ty + TY * i, j)] = d;
      }
    }
    __syncwarp();
    pv_tile<T, DP>(Ps, Gt, ty, tx, dv);
    pv_tile<T, DP>(Ds, Qt, ty, tx, dk);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int t = t0 + ty + TY * i;
    if (t >= S) continue;
    store_row<DP>(dk_out + ds_.at(b, h, t), dk[i], kRound ? 1.f : scale, tx, D, vec);
    store_row<DP>(dv_out + ds_.at(b, h, t), dv[i], 1.f, tx, D, vec);
  }
}

// ------------------------------------------------------------------ host
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
inline bool strides4(Strides s) { return s.b % 4 == 0 && s.h % 4 == 0 && s.s % 4 == 0; }

template <typename K>
inline cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
cudaError_t launch_fwd_dp(const float* q, const float* k, const float* v, Strides in,
                          const int32_t* mask, float* out, Strides os, int B, int S, int H, int D,
                          float scale, int vec, cudaStream_t stream) {
  using L = FwdSmem<DP, FwdTiles>;
  const auto kernel = fwd_kernel<DP, FwdTiles>;
  cudaError_t err = allow(kernel, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + L::BR - 1) / L::BR, H, B);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(q, k, v, in, mask, out, os, S, D, scale, vec);
  return cudaGetLastError();
}

// The forward on (B, H, S, D) operands; D <= MAX_D
inline cudaError_t launch_fwd(const float* q, const float* k, const float* v, Strides in,
                              const int32_t* mask, float* out, Strides os, int B, int S, int H,
                              int D, float scale, cudaStream_t stream) {
  if (D <= 0 || D > MAX_D || S <= 0) return cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && strides4(in) && strides4(os) && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(out);
  if (D <= 32) return launch_fwd_dp<32>(q, k, v, in, mask, out, os, B, S, H, D, scale, vec, stream);
  if (D <= 64) return launch_fwd_dp<64>(q, k, v, in, mask, out, os, B, S, H, D, scale, vec, stream);
  return launch_fwd_dp<128>(q, k, v, in, mask, out, os, B, S, H, D, scale, vec, stream);
}

template <int DP, bool kRound>
cudaError_t launch_bwd_dp(const float* q, const float* k, const float* v, Strides in,
                          const int32_t* mask, const float* g, Strides gs, float* dq, float* dk,
                          float* dv, Strides ds_, float* stats, int B, int S, int H, int D,
                          float scale, int vec, cudaStream_t stream) {
  using Lq = DqSmem<DP, DqTiles>;
  using Lk = DkvSmem<DP, DkvTiles<DP>>;
  const auto kq = bwd_dq_kernel<DP, DqTiles, kRound>;
  const auto kkv = bwd_dkv_kernel<DP, DkvTiles<DP>, kRound>;
  cudaError_t err = allow(kq, Lq::BYTES);
  if (err == cudaSuccess) err = allow(kkv, Lk::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((S + Lq::BR - 1) / Lq::BR, H, B), grid_kv((S + Lk::BR - 1) / Lk::BR, H, B);
  kq<<<grid_q, Lq::THREADS, Lq::BYTES, stream>>>(q, k, v, in, mask, g, gs, dq, ds_, stats, S, D,
                                              scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid_kv, Lk::THREADS, Lk::BYTES, stream>>>(q, k, v, in, mask, g, gs, stats, dk, dv, ds_, S, D,
                                                scale, vec);
  return cudaGetLastError();
}

// The backward pair: dq, dk, dv (strides ds_) and the (B, H, S, 3) stats
// scratch (m, l, delta of every query row); D <= MAX_D
template <bool kRound>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, Strides in,
                       const int32_t* mask, const float* g, Strides gs, float* dq, float* dk,
                       float* dv, Strides ds_, float* stats, int B, int S, int H, int D,
                       float scale, cudaStream_t stream) {
  if (D <= 0 || D > MAX_D || S <= 0) return cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && strides4(in) && strides4(gs) && strides4(ds_) && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(g) && aligned16(dq) &&
                  aligned16(dk) && aligned16(dv);
  if (D <= 32)
    return launch_bwd_dp<32, kRound>(q, k, v, in, mask, g, gs, dq, dk, dv, ds_, stats, B, S, H, D,
                                     scale, vec, stream);
  if (D <= 64)
    return launch_bwd_dp<64, kRound>(q, k, v, in, mask, g, gs, dq, dk, dv, ds_, stats, B, S, H, D,
                                     scale, vec, stream);
  return launch_bwd_dp<128, kRound>(q, k, v, in, mask, g, gs, dq, dk, dv, ds_, stats, B, S, H, D,
                                    scale, vec, stream);
}

}  // namespace sa
