// Hand-written Hopper kernels for the ViLT block halves: the deterministic
// forwards and their dx-only backwards, and the training forwards (dropout
// inside the kernels) with their full backwards (dx and every weight, bias
// and LayerNorm gradient).
//
// Replaces (JAX package, Pallas on the TPU):
//   rmcl_tpu/ops/pallas_block.py:_fwd_impl / _half_block_kernel / _attn_fwd_math
//     (fused_attn_half_det: x + proj(MHA(qkv(LN1 x))))
//   rmcl_tpu/ops/pallas_block.py:_mlp_fwd_impl / _mlp_half_kernel
//     (fused_mlp_half: x + fc2(gelu_erf(fc1(LN2 x))))
//   rmcl_tpu/ops/pallas_block.py:_dx_bwd_impl / _half_block_dx[_saved]_kernel /
//     _attn_bwd_math (dx of the attention half, weights frozen)
//   rmcl_tpu/ops/pallas_block.py:_mlp_dx_impl / _mlp_dx[_saved]_kernel
//     (dx of the MLP half, weights frozen)
//   rmcl_tpu/ops/pallas_block.py:_attn_train_fwd_impl / _attn_train_kernel
//     (fused_attn_half_train: x + drop_p(proj(MHA(qkv(LN1 x)))))
//   rmcl_tpu/ops/pallas_block.py:_attn_train_bwd_impl / _attn_train_bwd_kernel
//     (its backward: dx + g, dLN1, dWqkv, dbqkv, dWproj, dbproj)
//   rmcl_tpu/ops/pallas_block.py:_mlp_train_fwd_impl / _mlp_train_kernel
//     (fused_mlp_half_train: x + drop_p(fc2(drop_p(gelu(fc1(LN2 x))))))
//   rmcl_tpu/ops/pallas_block.py:_mlp_train_bwd_impl / _mlp_train_bwd_kernel
//     (its backward: dx + g, dLN2, dW1, db1, dW2, db2)
//   rmcl_tpu/ops/pallas_block.py:_bwd_impl / _half_block_bwd_kernel / _attn_bwd_math
//     (fused_attn_half's backward: dx, dLN1, dWqkv, dbqkv, dWproj, dbproj)
//   rmcl_tpu/ops/pallas_attention.py:_fwd_impl / _attn_kernel and
//     _bwd_impl / _attn_bwd_kernel (flash_masked_attention: the attention
//     core of the unfused block on (B, H, S, D) operands, and dq, dk, dv)
//
// The TPU kernels run one sample per grid step with every block weight
// resident in VMEM.  That does not carry over: wqkv alone is 3.5 MB in
// bf16 against the 227 KB of shared memory one block can use.  Here each
// half is a chain of kernels, launched by rmcl_tpu_torch/ops/fused_block.py and
// rmcl_tpu_torch/ops/fused_block_train.py:
//   attention half = ln_gemm(LN1 -> qkv + bias) -> masked_attention_fwd
//                    -> ln_gemm(proj + bias + residual)
//   MLP half       = ln_gemm(LN2 -> fc1 + bias -> GELU)
//                    -> ln_gemm(fc2 + bias + residual)
//   attention dx   = [ln_gemm(LN1 -> qkv + bias), unless qkv was saved]
//                    -> gemm(dattn = g . Wproj) -> masked_attention_bwd_dq
//                    -> masked_attention_bwd_dkv -> gemm(dy = dqkv . Wqkv, fp32)
//                    -> ln_bwd (dx + g)
//   MLP dx         = [ln_gemm(LN2 -> fc1 + bias), unless h was saved]
//                    -> gemm(dh = (g . W2) * gelu'(h)) -> gemm(dy = dh . W1, fp32)
//                    -> ln_bwd (dx + g)
//   attention train = the attention half with a dropout epilogue on the proj
//                    GEMM (bias, round, keep / scale, round, + x); qkv and
//                    the attention output are kept for the backward
//   MLP train       = the MLP half with dropout after GELU in the fc1
//                    epilogue and after the bias in the fc2 epilogue; the
//                    pre-GELU h and the dropped activation a_d are kept
//   attention train backward
//                   = drop_scale(gm = keep g / (1 - p)) -> the attention dx
//                    chain on gm, its ln_bwd in the training form (dx + g,
//                    y = LN1 x, dLN1 w and b in the same launch)
//                    -> gemm_tn(dWqkv = dqkv^T . y) -> colsum(dbqkv)
//                    -> gemm_tn(dWproj = gm^T . attn) -> colsum(dbproj)
//   MLP train backward
//                   = drop_scale(gf = keep2 g / (1 - p)) -> gemm(dh = keep
//                    (gf . W2) / (1 - p) * gelu'(h)) -> gemm(dy = dh . W1,
//                    fp32) -> ln_bwd (dx + g, y, dLN2 w and b)
//                    -> gemm_tn(dW1 = dh^T . y) -> colsum(db1)
//                    -> gemm_tn(dW2 = gf^T . a_d) -> colsum(db2)
//   fused_attn_half backward (ops/fused_block.py:attn_half_full_bwd)
//                   = the attention train backward on g itself: no
//                    drop_scale, and no + g (the residual is outside)
//   attention core  = masked_attention_fwd, and masked_attention_bwd_dq ->
//                    _dkv, on (B, H, S, D) operands through their strides
//                    (ops/attention.py); the dropout outside the kernels is
//                    drop_scale (ops/dropout.py)
// The TPU training backwards accumulate the weight gradients in on-chip
// memory across a sequential batch grid.  Blocks here run in no order, so
// the weight gradients are GEMMs that contract over all M = B S rows at once
// (gemm_tn: each output tile and contraction slice has one owner, slices are
// added in a fixed order, no atomics), and the column sums (ln_bwd's
// LayerNorm gradients, colsum's bias gradients) add their partials across
// CTAs in a fixed order inside one launch (thread-block clusters, shared
// memory across the cluster): every gradient is reproducible bit for bit.
// The dropout bits are Philox-4x32-10 words that depend only on (per-sample
// seed, draw, row within the sample, column): rmcl_tpu_torch/ops/philox.py is
// the same function in plain torch.  The backward regenerates the masks from
// the seeds, as the TPU kernels do; no mask reaches device memory unless a
// caller asks for it (mask_out, for tests).
// The TPU backward bodies hold every weight and three fp32 (H, S, S)
// tensors per sample on chip; no SM can, so the backward is the same kind
// of chain.  The weights are stored (out, in), so a backward product
// g . W contracts over W's rows: the GEMM takes that operand layout as a
// layout flag and no weight is ever transposed.
//
// What bounds them on an H100.  A layer's bf16 weights are 14 MB.  At the
// step's M = B S = 3,856 rows (16 pairs, S = 241; serving: 2,152) the GEMMs
// do about 1,500 FLOP per weight byte, five times the card's 295 FLOP/byte
// line: ln_gemm and gemm_tn are bound by the tensor cores.  At batch 1
// (M = 269) they sit near the line.  The attention core is bound by bytes at
// every batch (D = 64 contractions).
//
// What the design does about it:
//   * ln_gemm and gemm_tn carry every product of the block halves: the qkv,
//     proj, fc1 and fc2 forwards (Queue B rows 1, 4, 8, 6 and row 2's
//     forward), the g . W products of the dx and training backwards (rows 3,
//     5, 9, 7, 2) and the weight gradients (rows 9, 7, 2); row 14's shard
//     shapes run rows 1 and 4 at half width.  In bf16 both run one mainloop
//     (hopper_gemm.cuh): TMA brings 128 x 64 and BN x 64 tiles (BN = 128 or
//     192, whichever fills the 132 SMs better) into a ring of 5-6 shared-memory
//     stages with mbarriers, one producer warp keeps the loads in flight, and
//     two consumer warpgroups run wgmma.mma_async with the fp32 accumulators
//     in registers.  The CTAs are persistent (one per SM, a loop over output
//     tiles), so a tile's loads overlap the previous tile's epilogue.  The
//     (K, N) weight of the backward products is read MN-major through the
//     wgmma transpose bit, as are both row-major operands of gemm_tn.
//   * ln_gemm's epilogue (bias, exact-erf GELU keeping the pre-GELU value,
//     Philox dropout, residual; gelu'; fp32 dy) works on the accumulator
//     registers, two columns per access.  Its LayerNorm runs as a separate
//     pass in bf16 (ln_rows_kernel: the statistics once per row, the rounded
//     y into a scratch the wrapper passes, the A operand the GEMM then loads
//     by TMA); in fp32 a statistics pass (ln_stats_kernel, (mean, rstd) per
//     row) and the LayerNorm applied in the FMA kernel's registers.
//   * gemm_tn cuts the contraction into a few fixed slices where its output
//     tiles are too few for the SMs (dWproj: 768 x 768), each slice into its
//     own fp32 slab, added in order by a second pass.
//   * fp32 stays on the CUDA cores' FMA units (simt_gemm.cuh: 128 x 128 or
//     128 x 64 tiles, 8 x 8 accumulators a thread, a 4-stage cp.async ring):
//     wgmma's fp32 input would be TF32 (about 3 digits), and the fp32 slices
//     are held to the CPU within 1e-3 to 2e-4 of their largest value.
//   * masked_attention_fwd reads q, k and v straight from the (B, S, 3C)
//     qkv buffer (column order (3, H, D)), keeps K/V tiles in shared
//     memory and runs an online softmax, so no S x S tensor reaches device
//     memory.  The attention kernels take explicit (batch, head, row)
//     strides: the packed buffer and the (B, H, S, D) operands of the
//     attention core are two stride sets of one body.  In bf16 it runs on
//     wgmma with cp.async double buffering (hopper_attention.cuh:
//     fwd_kernel); in fp32 on register-tiled FMA products with a cp.async
//     ring (simt_attention.cuh: fwd_kernel).
//   * The attention backward recomputes P tile by tile from q, k and the
//     key mask in two kernels, so no S x S tensor reaches device memory and
//     no atomics are needed: masked_attention_bwd_dq owns a query tile
//     (pass 1 over the keys: row max, row sum and sum_t dp.p; pass 2: ds
//     and dq), masked_attention_bwd_dkv owns a key tile and walks the
//     queries with the row statistics the first kernel left.  In bf16 both
//     run on wgmma with cp.async double buffering (hopper_attention.cuh);
//     in fp32 on register-tiled FMA products (simt_attention.cuh).
//   * Not yet done (left for later work): the qkv buffer, the attention
//     output, the (S, 4C) MLP hidden and the backward's dattn, dqkv, dh and
//     fp32 dy pass through device memory, which the TPU kernels kept on
//     chip.
//
// The attention core's backward (pallas_attention.py:_attn_bwd_kernel) has
// other rounding points than the block halves' (_attn_bwd_math): ds stays
// fp32 and unscaled, scale multiplies the fp32 products ds . k and ds^T . q,
// and dv takes the fp32 p.  The backward kernels take which as a template
// flag (kRound); in fp32 the two coincide.
//
// Numerics follow the Pallas kernels: LayerNorm, softmax and every
// accumulation in fp32; activations rounded to the activation type at the
// same points (matmul output, + bias, GELU, + residual, P before P.V);
// key bias -1e30 on masked keys; scores scaled by D**-0.5.  Backward:
// dattn rounded; dp fp32; ds = p (dp - sum dp.p) scale from the fp32 p, then
// rounded; dv from the rounded p; dq, dk, dv rounded; g . W2 stays fp32
// into the GELU derivative, whose product is rounded; dy fp32, never
// rounded; the LayerNorm backward and + g in fp32, one final cast.
// Training: GELU stays fp32 into the dropout, whose product is rounded; the
// output dropout acts on the rounded, biased product and rounds again before
// + x; gm and gf are computed in fp32 and rounded; every weight, bias and
// LayerNorm gradient is accumulated and stored in fp32.
//
// Interface: plain C, loaded with ctypes.  Every entry point takes device
// pointers, sizes and the CUDA stream, launches on that stream, allocates
// nothing, and returns cudaGetLastError().  dtype 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include <cooperative_groups.h>

#include "hopper_attention.cuh"
#include "hopper_gemm.cuh"
#include "simt_attention.cuh"
#include "simt_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// round to the activation type and back
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f<T>(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------ dropout
// Word 0 of Philox-4x32-10 with counter (col, row, draw, 0) and key (seed, 0):
// the random word of element (row, col) of a sample's draw.
__device__ __forceinline__ uint32_t philox_word(uint32_t seed, uint32_t draw, uint32_t row,
                                                uint32_t col) {
  uint32_t c0 = col, c1 = row, c2 = draw, c3 = 0u, k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// Inverted dropout over an (M, N) array whose row m belongs to sample
// m / rows at row m % rows.  seeds == nullptr: no dropout.  Column n of the
// array is column col0 + n of the mask: a tensor-parallel shard of the MLP's
// hidden columns draws the words of its global columns, so that the shards'
// masks are the columns of the unsharded mask.
struct Drop {
  const int32_t* seeds;   // (B,) one stream per sample
  int rows;               // rows per sample
  uint32_t draw;          // which mask of the stream
  uint32_t threshold;     // keep iff word >= threshold
  float inv_keep;         // 1 / (1 - p)
  void* mask_out;         // (M, N) 0/1 in the activation type, or nullptr
  uint32_t col0;          // the mask column of the array's column 0
};

__device__ __forceinline__ bool drop_keep(const Drop& d, int m, int n) {
  const int b = m / d.rows;
  return philox_word((uint32_t)d.seeds[b], d.draw, (uint32_t)(m - b * d.rows),
                     d.col0 + (uint32_t)n) >= d.threshold;
}

// ------------------------------------------------------------------ ln_gemm
// out[M, N] = epi(LN?(A)[M, K] . B + bias[N]), B[k][n] = W[n][k] when W is
// stored (N, K) (forward: the weight's own (out, in) layout), or
// B[k][n] = W[k][n] when W is stored (K, N) (WKN; backward: g . W against
// the same stored weight).
//   LN (when ln_w != nullptr): fp32 mean and variance per row over K, then
//   (x - mean) * rsqrt(var + eps) * ln_w + ln_b, rounded to T.
//   epi EPI_BIAS:  round to T, [+ bias rounded to T], [keep a copy in aux,
//                  then exact-erf GELU], [dropout], [+ residual]; out is T.
//                  With dropout the GELU value stays fp32 into the keep /
//                  scale and is rounded once; without GELU the dropout acts
//                  on the rounded value and rounds again.
//   epi EPI_DGELU: [dropout of acc, fp32] * gelu'(aux[m][n]) in fp32, rounded
//                  once; out is T.
//   epi EPI_F32:   the fp32 accumulator as it is; out is float.
// A, W, residual and aux are T; ln_w, ln_b and bias are fp32.
// Needs K % 8 == 0, for WKN also N % 8 == 0, and 16-byte aligned A, W, out,
// bias, residual, aux and the LayerNorm parameters (the wrapper checks).
// Two routes by type.  float: ln_stats_kernel when there is a LayerNorm (each
// row's (mean, rstd) into a scratch the wrapper passes), then
// ln_gemm_f32_kernel (simt_gemm.cuh: register-tiled FMA, a cp.async ring, the
// LayerNorm applied to A in registers on its way into shared memory).  bf16:
// ln_rows_kernel when there is a LayerNorm (the rounded LN(A) into a scratch
// the wrapper passes), then ln_gemm_bf16_kernel (TMA + wgmma,
// hopper_gemm.cuh).  Both apply the epilogue below element by element.

constexpr int EPI_BIAS = 0, EPI_DGELU = 1, EPI_F32 = 2;

// EPI_DGELU of one element: exact-erf gelu'(h) = Phi(h) + h phi(h), in fp32
__device__ __forceinline__ float epi_dgelu(float acc, float h, bool dropping, bool keep,
                                           float inv_keep) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  const float pdf = expf(-0.5f * h * h) * 0.3989422804014327f;
  const float da = dropping ? (keep ? acc * inv_keep : 0.f) : acc;
  return da * (cdf + h * pdf);
}

// EPI_BIAS of one element up to the residual, b its column's bias if
// has_bias; pre gets the pre-GELU value
template <typename T>
__device__ __forceinline__ float epi_bias(float acc, bool has_bias, float b, int gelu,
                                          bool dropping, bool keep, float inv_keep,
                                          float& pre) {
  float v = rnd<T>(acc);
  if (has_bias) v = rnd<T>(v + rnd<T>(b));
  pre = v;
  if (gelu) {
    const float a = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    v = dropping ? (keep ? rnd<T>(a * inv_keep) : 0.f) : rnd<T>(a);
  } else if (dropping) {
    v = keep ? rnd<T>(v * inv_keep) : 0.f;
  }
  return v;
}

// The LayerNorm statistics of row m of x (M, K), by the warp that owns it:
// the lane sums in k order, then the warp's butterfly, two passes over the
// row; (mean, rstd = 1 / sqrt(var + eps)).
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* __restrict__ row, int K, float eps,
                                            int lane) {
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += to_f<T>(row[k]);
  const float mean = warp_sum(s) / (float)K;
  float ss = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f<T>(row[k]) - mean;
    ss += d * d;
  }
  return make_float2(mean, 1.f / sqrtf(warp_sum(ss) / (float)K + eps));
}

// (mean, rstd) of each row of the fp32 ln_gemm's A: its LayerNorm statistics,
// once per row rather than once per CTA of a row block; one warp per row.
constexpr int LNR_THREADS = 256;

__global__ void __launch_bounds__(LNR_THREADS)
ln_stats_kernel(const float* __restrict__ x, float eps, float2* __restrict__ stats, int M,
                int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * (LNR_THREADS / 32) + warp;
  if (m >= M) return;
  const float2 st = row_stats(x + (size_t)m * K, K, eps, lane);
  if (lane == 0) stats[m] = st;
}

// The fp32 ln_gemm: simt_gemm.cuh's mainloop (A k-contiguous through
// registers with the LayerNorm from ln_stats_kernel's statistics; W (N, K)
// likewise, or (K, N) by cp.async), then the epilogue on 4 columns a thread.
template <bool WKN, int TBN>
__global__ void __launch_bounds__(sg::Tile<TBN>::THREADS, sg::Tile<TBN>::MIN_CTAS)
ln_gemm_f32_kernel(const float* __restrict__ A, const float2* __restrict__ ln_stats,
                   const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                   const float* __restrict__ W, const float* __restrict__ bias,
                   const float* __restrict__ residual, float* __restrict__ aux,
                   float* __restrict__ out, int M, int N, int K, int gelu, int epi, Drop drop) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * sg::BM, n0 = blockIdx.x * TBN;
  float acc[8][8];
  sg::mainloop<TBN, false, WKN>(sg::Operand{A, K, M}, sg::Operand{W, WKN ? N : K, N}, m0, n0, 0,
                                (K + sg::BK - 1) / sg::BK, K, ln_w, ln_b, ln_stats, smem, acc);
  const bool dropping = drop.seeds != nullptr;
  sg::epilogue<TBN>(acc, smem, [&](int r, int c, float4 a4) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) return;
    const size_t o = (size_t)m * N + n;
    if (epi == EPI_F32) {
      *reinterpret_cast<float4*>(out + o) = a4;
      return;
    }
    const float acc4[4] = {a4.x, a4.y, a4.z, a4.w};
    bool keep[4] = {true, true, true, true};
    if (dropping) {
#pragma unroll
      for (int q = 0; q < 4; ++q) keep[q] = drop_keep(drop, m, n + q);
      if (drop.mask_out != nullptr)
        *reinterpret_cast<float4*>(static_cast<float*>(drop.mask_out) + o) = make_float4(
            keep[0] ? 1.f : 0.f, keep[1] ? 1.f : 0.f, keep[2] ? 1.f : 0.f, keep[3] ? 1.f : 0.f);
    }
    float v[4];
    if (epi == EPI_DGELU) {
      const float4 h = *reinterpret_cast<const float4*>(aux + o);
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = epi_dgelu(acc4[q], hv[q], dropping, keep[q], drop.inv_keep);
    } else {
      const bool has_bias = bias != nullptr;
      const float4 b = has_bias ? *reinterpret_cast<const float4*>(bias + n)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      const float bv[4] = {b.x, b.y, b.z, b.w};
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = epi_bias<float>(acc4[q], has_bias, bv[q], gelu, dropping, keep[q], drop.inv_keep,
                               pre[q]);
      if (gelu && aux != nullptr)   // pre-GELU h, kept for the backward
        *reinterpret_cast<float4*>(aux + o) = make_float4(pre[0], pre[1], pre[2], pre[3]);
      if (residual != nullptr) {
        const float4 res = *reinterpret_cast<const float4*>(residual + o);
        v[0] += res.x, v[1] += res.y, v[2] += res.z, v[3] += res.w;
      }
    }
    *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
  });
}

// The LayerNorm of the bf16 path: y[m] = round((x[m] - mean) rstd ln_w + ln_b),
// with row_stats and the fp32 kernel's formula; one warp per row.

__global__ void __launch_bounds__(LNR_THREADS)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, float eps, bf16* __restrict__ y, int M, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * (LNR_THREADS / 32) + warp;
  if (m >= M) return;
  const bf16* row = x + (size_t)m * K;
  const float2 st = row_stats(row, K, eps, lane);
  for (int k = lane; k < K; k += 32)
    y[(size_t)m * K + k] = from_f<bf16>(((to_f<bf16>(row[k]) - st.x) * st.y) * ln_w[k] + ln_b[k]);
}

// The bf16 epilogue, through hg::staged_epilogue: rows(m0, n, v) takes the
// column pair (n, n + 1) of rows m0 + 2 i, i < 8 (both columns in range
// since N is even), loads the column's bias once and the rows' operands
// together, and stores each pair as one 4-byte (8-byte for EPI_F32) access.
template <int TBN>
struct LnGemmEpi {
  const float* bias;
  const bf16* residual;
  bf16* aux;
  void* out;
  int M, N, gelu, epi;
  Drop drop;

  __device__ __forceinline__ void operator()(const float (&acc)[TBN / 2], int m0, int n0, int,
                                             float* buf) const {
    hg::staged_epilogue<TBN>(acc, m0, n0, buf, *this);
  }

  __device__ __forceinline__ void rows(int m0, int n, const float2 (&v)[8]) const {
    if (n >= N) return;
    const int rows_in = min(8, (M - m0 + 1) / 2);   // rows m0 + 2 i < M
    if (rows_in <= 0) return;
    const size_t o0 = (size_t)m0 * N + n, step = 2 * (size_t)N;
    if (epi == EPI_F32) {
      float* o = static_cast<float*>(out) + o0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < rows_in) *reinterpret_cast<float2*>(o + i * step) = v[i];
      return;
    }
    const bool dropping = drop.seeds != nullptr;
    bool k0[8], k1[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k0[i] = k1[i] = true;
      if (dropping && i < rows_in) {
        k0[i] = drop_keep(drop, m0 + 2 * i, n);
        k1[i] = drop_keep(drop, m0 + 2 * i, n + 1);
        if (drop.mask_out != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(drop.mask_out) + o0 + i * step) =
              __floats2bfloat162_rn(k0[i] ? 1.f : 0.f, k1[i] ? 1.f : 0.f);
      }
    }
    bf16* outp = static_cast<bf16*>(out) + o0;
    if (epi == EPI_DGELU) {
      __nv_bfloat162 h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < rows_in) h[i] = *reinterpret_cast<const __nv_bfloat162*>(aux + o0 + i * step);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < rows_in)
          *reinterpret_cast<__nv_bfloat162*>(outp + i * step) = __floats2bfloat162_rn(
              epi_dgelu(v[i].x, __low2float(h[i]), dropping, k0[i], drop.inv_keep),
              epi_dgelu(v[i].y, __high2float(h[i]), dropping, k1[i], drop.inv_keep));
      return;
    }
    __nv_bfloat162 res[8];
    if (residual != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < rows_in)
          res[i] = *reinterpret_cast<const __nv_bfloat162*>(residual + o0 + i * step);
    }
    const bool has_bias = bias != nullptr;
    const float b0 = has_bias ? bias[n] : 0.f, b1 = has_bias ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i >= rows_in) break;
      float p0, p1;
      float v0 = epi_bias<bf16>(v[i].x, has_bias, b0, gelu, dropping, k0[i], drop.inv_keep, p0);
      float v1 = epi_bias<bf16>(v[i].y, has_bias, b1, gelu, dropping, k1[i], drop.inv_keep, p1);
      if (gelu && aux != nullptr)   // pre-GELU h, kept for the backward
        *reinterpret_cast<__nv_bfloat162*>(aux + o0 + i * step) = __floats2bfloat162_rn(p0, p1);
      if (residual != nullptr) {
        v0 = rnd<bf16>(v0 + __low2float(res[i]));
        v1 = rnd<bf16>(v1 + __high2float(res[i]));
      }
      *reinterpret_cast<__nv_bfloat162*>(outp + i * step) = __floats2bfloat162_rn(v0, v1);
    }
  }
};

template <bool WKN, int TBN>
__global__ void __launch_bounds__(hg::THREADS, 1)
ln_gemm_bf16_kernel(__grid_constant__ const CUtensorMap tm_a,
                    __grid_constant__ const CUtensorMap tm_w, const LnGemmEpi<TBN> epi,
                    int tiles_m, int tiles_n, int nkb) {
  hg::persistent_gemm<TBN, false, WKN>(tm_a, tm_w, tiles_m, tiles_n, nkb, 1, epi);
}

// ------------------------------------------------------------------ ln_bwd
// The LayerNorm backward of every dx and training backward, in one launch:
//   dx[m] = rstd (dyh - mean(dyh) - xhat mean(dyh xhat)) [+ g[m]], dyh = dy ln_w,
// with mean, rstd and xhat of row m of x recomputed in fp32; and in the
// training form also y[m] = round(xhat ln_w + ln_b) (the rounded LayerNorm
// output, the operand of the weight-gradient GEMM) and
// dln = (sum_m dy xhat, sum_m dy), the LayerNorm weight and bias gradients.
// x, g, dx and y are T; dy, ln_w, ln_b and dln are fp32.  C % 8 == 0 and
// C <= LN_MAX_C (the wrapper checks).
//
// Replaces the LayerNorm backward inside the Pallas bodies: the end of
// pallas_block.py:_half_block_dx_kernel :336 (row 3), _mlp_dx_kernel :626,
// :672-674 (row 5), and in training _attn_train_bwd_kernel :1280 (row 9),
// _mlp_train_bwd_kernel :864-889 (row 7) and _attn_bwd_math :305-313 (row
// 2), whose bodies add dLN into their accumulators beside dx.
//
// Bound: bytes.  At the step's M = 3,856 rows, C = 768: x, dy (fp32) and g
// read once and dx written, 29.6 MB, 8.84 us at 3.35 TB/s; the training
// form writes y too, 35.5 MB, 10.6 us.
//
// Design: one warp per row, the row held in registers.  Lane l owns the
// 8-element chunks at columns 8 l + 256 j (j < NJ = ceil(C / 256)), loaded
// and stored 16 bytes at a time (dy: two loads per chunk); ln_w and ln_b are
// read through the L1 cache, so no CTA waits on a staging pass.  The four
// row sums (mean, variance, sum dyh, sum dyh xhat) run on the registers,
// each a lane sum in chunk order and then a butterfly across the warp, so x,
// dy and g are read once.  A CTA of 8 warps owns 16 consecutive rows (warp
// w rows 2 w and 2 w + 1).
// In training each warp keeps its partials of dy xhat and dy over its rows
// in shared memory, each lane updating its own columns (in registers they
// spilled); the CTA adds its warps' partials in warp order; a cluster of 4
// CTAs adds its CTAs' in rank order through distributed shared memory, rank
// r taking the columns [r W, (r + 1) W), W = 2C / 4, of the (2C,) vector,
// into that cluster's slab of a static device scratch; the last cluster to
// arrive at a column range (one arrival counter per range, which that
// cluster resets to 0) adds the slabs in cluster order.  The grid is at most
// one wave of clusters (as many as the device runs at once, at most
// LN_MAX_CTAS CTAs), each CTA walking its row blocks b, b + grid, ...
// Clusters of 4 rather than 8: on an H100 SXM fewer 8-CTA clusters of this
// kernel fit at once than the 241 row blocks of M = 3,856 need, and the CTA
// that took a second block set the kernel's time; 4-CTA clusters cover them
// in one wave (244 CTAs).  One launch, no scratch from the caller, and one
// summation order for a given M on a given device: the same bits on every
// call.  The static
// scratch makes the training form one launch at a time per device (the port
// launches on one stream).

constexpr int LN_WARPS = 8, LN_THREADS = 32 * LN_WARPS, LN_RPW = 2;
constexpr int LN_ROWS = LN_WARPS * LN_RPW;   // rows of one row block
constexpr int LN_MAX_NJ = 4, LN_MAX_C = 256 * LN_MAX_NJ;
constexpr int LN_CLUSTER = 4, LN_MAX_CTAS = 256, LN_MAX_CLUSTERS = LN_MAX_CTAS / LN_CLUSTER;

__device__ float ln_slabs[LN_MAX_CLUSTERS * 2 * LN_MAX_C];
__device__ unsigned int ln_arrived[LN_CLUSTER];

// 8 elements of T as their raw 16 (bf16) or 32 (fp32) bytes
template <typename T> struct Raw8 { uint4 u[sizeof(T) / 2]; };

template <typename T>
__device__ __forceinline__ Raw8<T> load_raw8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

template <typename T>
__device__ __forceinline__ float raw_at(const Raw8<T>& r, int e) {
  return to_f<T>(reinterpret_cast<const T*>(r.u)[e]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  Raw8<T> r;
  T* t = reinterpret_cast<T*>(r.u);
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = from_f<T>(v[e]);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) reinterpret_cast<uint4*>(p)[i] = r.u[i];
}

// 8 consecutive fp32 values, 16-byte aligned, as two 16-byte accesses
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One row m: dx [and y] written.  In training, part[c] and part[C + c], the
// warp's partials of dy xhat and dy over its rows so far (in shared memory,
// each lane its own columns), gain this row's; the warp's first row writes
// them.  ln_w and ln_b are read through the L1 cache, 32 bytes a chunk.
template <typename T, int NJ, bool TRAIN>
__device__ __forceinline__ void ln_bwd_row(const T* __restrict__ x, const float* __restrict__ dy,
                                           const float* __restrict__ ln_w,
                                           const float* __restrict__ ln_b,
                                           const T* __restrict__ g, T* __restrict__ dx,
                                           T* __restrict__ y, float* part, bool first, int m,
                                           int C, float eps, int lane) {
  const size_t row = (size_t)m * C;
  Raw8<T> xr[NJ], gr[NJ];
  float d[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 8 * lane + 256 * j;
    if (c < C) {
      xr[j] = load_raw8<T>(x + row + c);
      load8(dy + row + c, d[j]);
      if (g != nullptr) gr[j] = load_raw8<T>(g + row + c);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (8 * lane + 256 * j < C)
#pragma unroll
      for (int e = 0; e < 8; ++e) s += raw_at<T>(xr[j], e);
  const float mean = warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (8 * lane + 256 * j < C)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = raw_at<T>(xr[j], e) - mean;
        ss += v * v;
      }
  const float rstd = 1.f / sqrtf(warp_sum(ss) / (float)C + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 8 * lane + 256 * j;
    if (c >= C) continue;
    float w[8];
    load8(ln_w + c, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xhat = (raw_at<T>(xr[j], e) - mean) * rstd;
      const float dyh = d[j][e] * w[e];
      s1 += dyh;
      s2 += dyh * xhat;
    }
  }
  const float m1 = warp_sum(s1) / (float)C, m2 = warp_sum(s2) / (float)C;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 8 * lane + 256 * j;
    if (c >= C) continue;
    float w[8], bv[8], pw[8], pb[8], o[8];
    load8(ln_w + c, w);
    if (TRAIN) {
      load8(ln_b + c, bv);
      if (!first) {
        load8(part + c, pw);
        load8(part + C + c, pb);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xhat = (raw_at<T>(xr[j], e) - mean) * rstd;
      const float dyh = d[j][e] * w[e];
      o[e] = rstd * (dyh - m1 - xhat * m2);
      if (g != nullptr) o[e] += raw_at<T>(gr[j], e);
      if (TRAIN) {
        bv[e] = xhat * w[e] + bv[e];   // y
        pw[e] = first ? d[j][e] * xhat : pw[e] + d[j][e] * xhat;
        pb[e] = first ? d[j][e] : pb[e] + d[j][e];
      }
    }
    store8<T>(dx + row + c, o);
    if (TRAIN) {
      store8<T>(y + row + c, bv);
      store8(part + c, pw);
      store8(part + C + c, pb);
    }
  }
}

// dx only (rows 3, 5): one row block of 16 rows per CTA.
template <typename T, int NJ>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                 const float* __restrict__ ln_w, const T* __restrict__ g, T* __restrict__ dx,
                 int M, int C, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < LN_RPW; ++i) {
    const int m = blockIdx.x * LN_ROWS + warp * LN_RPW + i;
    if (m < M)
      ln_bwd_row<T, NJ, false>(x, dy, ln_w, nullptr, g, dx, nullptr, nullptr, false, m, C,
                               eps, lane);
  }
}

// The training form (rows 9, 7, 2): dx, y and dln; gridDim.x a multiple of
// LN_CLUSTER and at most LN_MAX_CTAS.  Dynamic shared memory: the warps'
// partials, LN_WARPS x 2C floats, ln_bwd_train_smem(C).
inline size_t ln_bwd_train_smem(int C) { return sizeof(float) * 2 * LN_WARPS * C; }

template <typename T, int NJ>
__global__ void __cluster_dims__(LN_CLUSTER, 1, 1) __launch_bounds__(LN_THREADS)
ln_bwd_train_kernel(const T* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                    const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ y,
                    float* __restrict__ dln, int M, int C, float eps) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float red[];   // [LN_WARPS][2C]; red[0 .. 2C) ends as the CTA's sums
  const int C2 = 2 * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* part = red + (size_t)warp * C2;
  bool first = true;
  for (int b = blockIdx.x; b * LN_ROWS < M; b += gridDim.x)
#pragma unroll
    for (int i = 0; i < LN_RPW; ++i) {
      const int m = b * LN_ROWS + warp * LN_RPW + i;
      if (m < M) {
        ln_bwd_row<T, NJ, true>(x, dy, ln_w, ln_b, g, dx, y, part, first, m, C, eps, lane);
        first = false;
      }
    }
  if (first)   // a warp without rows
    for (int i = lane; i < C2; i += 32) part[i] = 0.f;
  // the warps' partials, added in warp order
  __syncthreads();
  for (int i = threadIdx.x; i < C2; i += LN_THREADS) {
    float v = red[i];
    for (int w = 1; w < LN_WARPS; ++w) v += red[(size_t)w * C2 + i];
    red[i] = v;
  }
  // the cluster's CTAs, added in rank order: rank r owns the columns
  // [r W, (r + 1) W) and writes them into the cluster's slab
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r = (int)cluster.block_rank(), W = C2 / LN_CLUSTER;
  const int k = blockIdx.x / LN_CLUSTER, clusters = gridDim.x / LN_CLUSTER;
  float* slab = ln_slabs + (size_t)k * C2;
  for (int i = threadIdx.x; i < W; i += LN_THREADS) {
    const int col = r * W + i;
    float v = cluster.map_shared_rank(red, 0)[col];
    for (int q = 1; q < LN_CLUSTER; ++q) v += cluster.map_shared_rank(red, q)[col];
    slab[col] = v;
  }
  // done with the peers' shared memory; wait for theirs to be done with ours at the end
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  // the last cluster to finish range r adds the slabs in cluster order
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&ln_arrived[r], 1u) == (unsigned)(clusters - 1);
  }
  __syncthreads();
  if (last) {
    __threadfence();
    for (int i = threadIdx.x; i < W; i += LN_THREADS) {
      const float* at = ln_slabs + r * W + i;
      float t[LN_MAX_CLUSTERS];   // every slab's load in flight, then added in order
#pragma unroll
      for (int q = 0; q < LN_MAX_CLUSTERS; ++q)
        if (q < clusters) t[q] = __ldcg(at + (size_t)q * C2);
      float v = t[0];
#pragma unroll
      for (int q = 1; q < LN_MAX_CLUSTERS; ++q)
        if (q < clusters) v += t[q];
      dln[r * W + i] = v;
    }
    if (threadIdx.x == 0) ln_arrived[r] = 0u;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// --------------------------------------------------------------- drop_scale
// out = keep ? round(g / (1 - p)) : 0 over an (M, N) array: the masked
// cotangent of a dropout, its mask regenerated from the seeds.

constexpr int EW_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
drop_scale_kernel(const T* __restrict__ g, T* __restrict__ out, int M, int N, Drop drop) {
  const size_t total = (size_t)M * N;
  for (size_t idx = (size_t)blockIdx.x * EW_THREADS + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * EW_THREADS) {
    const int m = (int)(idx / N), n = (int)(idx % N);
    const bool keep = drop_keep(drop, m, n);
    out[idx] = from_f<T>(keep ? to_f<T>(g[idx]) * drop.inv_keep : 0.f);
    if (drop.mask_out != nullptr)
      static_cast<T*>(drop.mask_out)[idx] = from_f<T>(keep ? 1.f : 0.f);
  }
}

// ------------------------------------------------------------------ gemm_tn
// out[Na, Nb] = A^T . B in fp32 for A (M, Na) and B (M, Nb) in T: the
// weight-gradient product, contracting over the M = B S rows.  Needs
// Na % 8 == 0 and Nb % 8 == 0 (the wrapper checks).  Each output element has
// one owner and one summation order, so the result is reproducible:
//   float: gemm_tn_f32_kernel (simt_gemm.cuh, register-tiled FMA on
//          128-column tiles, both operands by cp.async; sg::plan);
//   bf16:  gemm_tn_bf16_kernel (hopper_gemm.cuh, both operands MN-major;
//          hg::plan).
// Where the plan finds the output tiles too few for the SMs, the rows are
// cut into a fixed number of slices, each slice's product goes to its own
// fp32 slab of a scratch the wrapper allocates (rmcl_gemm_tn_slabs), and
// split_sum_kernel adds the slabs in order.

// The fp32 gemm_tn: simt_gemm.cuh's mainloop on a 128-column tile, both
// operands by cp.async, over the contraction slice blockIdx.z (kps slabs of
// BK rows), into slab blockIdx.z of out.
constexpr int TN_BN = 128;

__global__ void __launch_bounds__(sg::Tile<TN_BN>::THREADS, sg::Tile<TN_BN>::MIN_CTAS)
gemm_tn_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ out, int M, int Na, int Nb, int nkb, int kps) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * sg::BM, n0 = blockIdx.x * TN_BN, slice = blockIdx.z;
  float acc[8][8];
  sg::mainloop<TN_BN, true, true>(sg::Operand{A, Na, Na}, sg::Operand{B, Nb, Nb}, m0, n0,
                                  slice * kps, min(nkb, (slice + 1) * kps), M, nullptr,
                                  nullptr, nullptr, smem, acc);
  float* o = out + (size_t)slice * Na * Nb;
  sg::epilogue<TN_BN>(acc, smem, [&](int r, int c, float4 v) {
    if (m0 + r < Na && n0 + c < Nb)
      *reinterpret_cast<float4*>(o + (size_t)(m0 + r) * Nb + n0 + c) = v;
  });
}

// fp32 stores of the accumulators: slice s into slab s of out
template <int TBN>
struct TnEpi {
  float* out;
  int Na, Nb;

  __device__ __forceinline__ void operator()(const float (&acc)[TBN / 2], int m0, int n0,
                                             int slice, float* buf) const {
    hg::staged_epilogue<TBN>(acc, m0, n0, buf, Rows{out + (size_t)slice * Na * Nb, Na, Nb});
  }

  struct Rows {   // staged_epilogue's callback on one slab
    float* o;
    int Na, Nb;
    __device__ __forceinline__ void rows(int m0, int n, const float2 (&v)[8]) const {
      if (n >= Nb) return;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (m0 + 2 * i < Na)
          *reinterpret_cast<float2*>(o + (size_t)(m0 + 2 * i) * Nb + n) = v[i];
    }
  };
};

template <int TBN>
__global__ void __launch_bounds__(hg::THREADS, 1)
gemm_tn_bf16_kernel(__grid_constant__ const CUtensorMap tm_a,
                    __grid_constant__ const CUtensorMap tm_b, const TnEpi<TBN> epi,
                    int tiles_m, int tiles_n, int nkb, int splits) {
  hg::persistent_gemm<TBN, true, true>(tm_a, tm_b, tiles_m, tiles_n, nkb, splits, epi);
}

// out[i] = sum over s in order of partial[s][i]
__global__ void __launch_bounds__(EW_THREADS)
split_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, int splits,
                 size_t n) {
  for (size_t i = (size_t)blockIdx.x * EW_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * EW_THREADS) {
    float s = partial[i];
    for (int k = 1; k < splits; ++k) s += partial[(size_t)k * n + i];
    out[i] = s;
  }
}

// ------------------------------------------------------------------ colsum
// out[n] = sum_m a[m][n] in fp32 for a (M, N) in T: the bias gradients of the
// training backwards (dbqkv, dbproj, db1, db2), in one launch.  N % 8 == 0
// (the wrapper checks).
//
// Replaces the bias sums inside the Pallas training backwards: db1 and db2
// of pallas_block.py:_mlp_train_bwd_kernel :880-889 (row 7), dbqkv and
// dbproj of _attn_train_bwd_kernel :1280 (row 9) and of _bwd_impl :369
// (row 2).
//
// Bound: bytes, a read once: M N 2 bytes in bf16; at M = 3,856 rows 1.77 us
// for N = 768, 5.30 us for N = 2,304 and 7.07 us for N = 3,072.
//
// Design: one cluster of 8 CTAs per 64-column strip, rank r summing the rows
// [r R, (r + 1) R), R = ceil(M / 8).  A CTA is GROUPS = 64 / V column groups
// of V = 16 / sizeof(T) columns (one 16-byte load) by LANES = 256 / GROUPS
// row lanes: a warp reads four (bf16) or two (fp32) whole 128-byte lines of
// a row band at a time.  Row lane l adds the rows l, l + LANES, ... of its
// rank's share in order; the row lanes are added in shared memory in a fixed
// tree (lane l takes lane l + s, s = LANES / 2, ..., 1), and rank 0 adds the
// 8 CTAs' sums in rank order through distributed shared memory.  One launch,
// no scratch, one summation order: the same bits on every call.

constexpr int CS_THREADS = 256, CS_COLS = 64, CS_CLUSTER = 8;

template <typename T>
__global__ void __cluster_dims__(1, CS_CLUSTER, 1) __launch_bounds__(CS_THREADS)
colsum_kernel(const T* __restrict__ a, float* __restrict__ out, int M, int N) {
  namespace cg = cooperative_groups;
  constexpr int V = 16 / sizeof(T), GROUPS = CS_COLS / V, LANES = CS_THREADS / GROUPS;
  __shared__ __align__(16) float red[LANES][CS_COLS];
  const int grp = threadIdx.x % GROUPS, lane = threadIdx.x / GROUPS;
  const int n = blockIdx.x * CS_COLS + grp * V;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int R = (M + CS_CLUSTER - 1) / CS_CLUSTER;
  const int m1 = min(M, (r + 1) * R);
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int m = r * R + lane; m < m1; m += LANES) {
      const uint4 u = *reinterpret_cast<const uint4*>(a + (size_t)m * N + n);
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += to_f<T>(t[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) red[lane][grp * V + e] = acc[e];
  for (int s = LANES / 2; s > 0; s /= 2) {
    __syncthreads();
    if (lane < s)
#pragma unroll
      for (int e = 0; e < V; ++e) red[lane][grp * V + e] += red[lane + s][grp * V + e];
  }
  cluster.sync();
  const int col = blockIdx.x * CS_COLS + threadIdx.x;
  if (r == 0 && threadIdx.x < CS_COLS && col < N) {
    float v = cluster.map_shared_rank(&red[0][0], 0)[threadIdx.x];
    for (int q = 1; q < CS_CLUSTER; ++q) v += cluster.map_shared_rank(&red[0][0], q)[threadIdx.x];
    out[col] = v;
  }
  cluster.sync();   // no CTA leaves while rank 0 may still read its shared memory
}

// ------------------------------------------------------ masked attention
// q, k, v: (B, H, S, D), read through explicit element strides (b, h, s)
// with d contiguous, so that one body serves both layouts of the port:
//   packed  the (B, S, 3C) qkv buffer of the block halves, columns in
//           (3, H, D) order: q = qkv, k = qkv + C, v = qkv + 2C with strides
//           (3 S C, D, 3C); the attention output and dattn are (B, S, C),
//           strides (S C, D, C)
//   heads   the attention core of the unfused block (masked_attention):
//           q, k, v as (B, H, S, D) tensors or views of one qkv buffer, any
//           strides that q, k and v share
// mask: (B, S) int32, 1 = valid key.  bf16 runs the wgmma kernels of
// hopper_attention.cuh, fp32 the register-tiled FMA kernels of
// simt_attention.cuh (wgmma's fp32 input would be TF32): the same two-kernel
// backward, each output element one owner, stats (B, H, S, 3) fp32 scratch.
// The backward's rounding points (pallas_attention.py:_attn_bwd_kernel
// against the block halves' _attn_bwd_math) are the template flag kRound;
// in fp32 they differ only in where scale multiplies.  In fp32 the scores
// are summed over d in the same order in all three kernels, so each sees the
// same s, bit for bit.  In bf16 the backward's s come from the tensor cores,
// summed in their order: not the forward's bits, and bwd_dq's Q.K^T and
// bwd_dkv's K.Q^T need not be each other's either.

constexpr int MAX_D = sa::MAX_D;
using sa::Strides;

template <typename T>
cudaError_t launch_attention(const T* q, const T* k, const T* v, Strides in, const void* mask,
                             void* out, Strides os, int B, int S, int H, int D, float scale,
                             cudaStream_t stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  if constexpr (std::is_same<T, bf16>::value)
    return hattn::launch_fwd(q, k, v, {in.b, in.h, in.s}, m, static_cast<bf16*>(out),
                             {os.b, os.h, os.s}, B, S, H, D, scale, stream);
  else
    return sa::launch_fwd(q, k, v, in, m, static_cast<float*>(out), os, B, S, H, D, scale,
                          stream);
}

template <typename T, bool kRound>
cudaError_t launch_attention_bwd(const T* q, const T* k, const T* v, Strides in,
                                 const void* mask, const T* g, Strides gs, T* dq, T* dk, T* dv,
                                 Strides ds_, void* stats, int B, int S, int H, int D,
                                 float scale, cudaStream_t stream) {
  const int32_t* m = static_cast<const int32_t*>(mask);
  float* st = static_cast<float*>(stats);
  if constexpr (std::is_same<T, bf16>::value)
    return hattn::launch_bwd<kRound>(q, k, v, {in.b, in.h, in.s}, m, g, {gs.b, gs.h, gs.s}, dq,
                                     dk, dv, {ds_.b, ds_.h, ds_.s}, st, B, S, H, D, scale,
                                     stream);
  else
    return sa::launch_bwd<kRound>(q, k, v, in, m, g, gs, dq, dk, dv, ds_, st, B, S, H, D, scale,
                                  stream);
}

// the packed (B, S, 3C) layout of the block halves; row 3's rounding points
template <typename T>
cudaError_t launch_attention_packed(const void* qkv, const void* mask, void* out, int B,
                                    int S, int H, int D, float scale, cudaStream_t stream) {
  const long long C = (long long)H * D;
  const T* q = static_cast<const T*>(qkv);
  return launch_attention<T>(q, q + C, q + 2 * C, Strides{3 * S * C, D, 3 * C}, mask, out,
                             Strides{S * C, D, C}, B, S, H, D, scale, stream);
}

template <typename T>
cudaError_t launch_attention_packed_bwd(const void* qkv, const void* mask, const void* dattn,
                                        void* dqkv, void* stats, int B, int S, int H, int D,
                                        float scale, cudaStream_t stream) {
  const long long C = (long long)H * D;
  const T* q = static_cast<const T*>(qkv);
  T* dq = static_cast<T*>(dqkv);
  const Strides packed{3 * S * C, D, 3 * C};
  return launch_attention_bwd<T, true>(q, q + C, q + 2 * C, packed, mask,
                                       static_cast<const T*>(dattn), Strides{S * C, D, C}, dq,
                                       dq + C, dq + 2 * C, packed, stats, B, S, H, D, scale,
                                       stream);
}

template <bool WKN, int TBN>
cudaError_t launch_gemm_f32_tiles(const float* a, const float2* stats, const void* ln_w,
                                  const void* ln_b, const void* w, const void* bias,
                                  const void* residual, void* aux, void* out, int M, int N,
                                  int K, int gelu, int epi, Drop drop, const sg::Plan& p,
                                  cudaStream_t stream) {
  constexpr int smem = sg::Tile<TBN>::SMEM;
  const cudaError_t err = hg::allow_smem<ln_gemm_f32_kernel<WKN, TBN>>(smem);
  if (err != cudaSuccess) return err;
  ln_gemm_f32_kernel<WKN, TBN>
      <<<dim3(p.tiles_n, p.tiles_m), sg::Tile<TBN>::THREADS, smem, stream>>>(
      a, stats, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<float*>(aux), static_cast<float*>(out),
      M, N, K, gelu, epi, drop);
  return cudaGetLastError();
}

// ln_stats: (M,) float2 scratch for the LayerNorm's row statistics, needed
// with ln_w
template <bool WKN>
cudaError_t launch_gemm_f32(const void* a, const void* ln_w, const void* ln_b, float eps,
                            void* ln_stats, const void* w, const void* bias,
                            const void* residual, void* aux, void* out, int M, int N, int K,
                            int gelu, int epi, Drop drop, cudaStream_t stream) {
  const auto* af = static_cast<const float*>(a);
  auto* stats = static_cast<float2*>(ln_stats);
  if (ln_w != nullptr) {
    if (stats == nullptr || ln_b == nullptr) return cudaErrorInvalidValue;
    const int rows = LNR_THREADS / 32;
    ln_stats_kernel<<<(M + rows - 1) / rows, LNR_THREADS, 0, stream>>>(af, eps, stats, M, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const sg::Plan p = sg::plan(M, N, K, false);
  return p.bn == 128
             ? launch_gemm_f32_tiles<WKN, 128>(af, stats, ln_w, ln_b, w, bias, residual, aux,
                                               out, M, N, K, gelu, epi, drop, p, stream)
             : launch_gemm_f32_tiles<WKN, 64>(af, stats, ln_w, ln_b, w, bias, residual, aux,
                                              out, M, N, K, gelu, epi, drop, p, stream);
}

template <bool WKN, int TBN>
cudaError_t launch_ln_gemm_bf16_tiles(const CUtensorMap& ta, const void* w,
                                      const LnGemmEpi<TBN>& epi, int K, const hg::Plan& p,
                                      cudaStream_t stream) {
  CUtensorMap tw;
  // W (N, K): K-major boxes of (BN rows, 64 k); W (K, N): MN-major boxes of (64 k, 64 n)
  cudaError_t err = WKN ? hg::tensor_map(&tw, w, K, epi.N, hg::BK)
                        : hg::tensor_map(&tw, w, epi.N, K, TBN);
  if (err != cudaSuccess) return err;
  constexpr int smem = hg::Tile<TBN>::SMEM;
  err = hg::allow_smem<ln_gemm_bf16_kernel<WKN, TBN>>(smem);
  if (err != cudaSuccess) return err;
  ln_gemm_bf16_kernel<WKN, TBN><<<p.grid, hg::THREADS, smem, stream>>>(ta, tw, epi, p.tiles_m,
                                                                     p.tiles_n, p.nkb);
  return cudaGetLastError();
}

template <bool WKN>
cudaError_t launch_gemm_bf16(const void* a, const void* ln_w, const void* ln_b, float eps,
                             void* ln_y, const void* w, const void* bias, const void* residual,
                             void* aux, void* out, int M, int N, int K, int gelu, int epi,
                             Drop drop, cudaStream_t stream) {
  if (ln_w != nullptr) {   // the rounded LayerNorm output becomes the A operand
    if (ln_y == nullptr || ln_b == nullptr) return cudaErrorInvalidValue;
    const int rows = LNR_THREADS / 32;
    ln_rows_kernel<<<(M + rows - 1) / rows, LNR_THREADS, 0, stream>>>(
        static_cast<const bf16*>(a), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), eps, static_cast<bf16*>(ln_y), M, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a = ln_y;
  }
  CUtensorMap ta;
  const cudaError_t err = hg::tensor_map(&ta, a, M, K, hg::BM);
  if (err != cudaSuccess) return err;
  const hg::Plan p = hg::plan(M, N, K, false);
  const auto* bias_f = static_cast<const float*>(bias);
  const auto* res = static_cast<const bf16*>(residual);
  auto* aux_b = static_cast<bf16*>(aux);
  if (p.bn == 192)
    return launch_ln_gemm_bf16_tiles<WKN, 192>(
        ta, w, LnGemmEpi<192>{bias_f, res, aux_b, out, M, N, gelu, epi, drop}, K, p, stream);
  return launch_ln_gemm_bf16_tiles<WKN, 128>(
      ta, w, LnGemmEpi<128>{bias_f, res, aux_b, out, M, N, gelu, epi, drop}, K, p, stream);
}

// Clusters of the training form that run at once on this device (at most
// LN_MAX_CLUSTERS; 0 if its shared memory cannot be granted), read
// once per device, after the grant: the grid never exceeds
// one wave, and the CTAs walk the remaining row blocks.  The summation order
// follows from M and this count, so a device gives the same bits on every
// call.
template <typename T, int NJ>
int ln_bwd_clusters() {
  static std::atomic<int> counts[hg::MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < hg::MAX_DEVICES ? counts[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    // the shared memory grant first: the count depends on it
    if (hg::allow_smem<ln_bwd_train_kernel<T, NJ>>((int)ln_bwd_train_smem(LN_MAX_C)) !=
        cudaSuccess)
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(LN_MAX_CTAS);
    cfg.blockDim = dim3(LN_THREADS);
    cfg.dynamicSmemBytes = ln_bwd_train_smem(256 * NJ);
    if (cudaOccupancyMaxActiveClusters(&n, ln_bwd_train_kernel<T, NJ>, &cfg) != cudaSuccess) {
      cudaGetLastError();   // clear it: one cluster at a time still runs
      n = 1;
    }
    n = std::max(1, std::min(n, LN_MAX_CLUSTERS));
    if (dev < hg::MAX_DEVICES) counts[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T, int NJ>
cudaError_t launch_ln_bwd_nj(const void* x, const void* dy, const void* ln_w, const void* ln_b,
                             const void* g, void* dx, void* y, void* dln, int M, int C,
                             float eps, cudaStream_t stream) {
  const int blocks = (M + LN_ROWS - 1) / LN_ROWS;
  if (y == nullptr) {
    ln_bwd_dx_kernel<T, NJ><<<blocks, LN_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dy),
        static_cast<const float*>(ln_w), static_cast<const T*>(g), static_cast<T*>(dx), M, C,
        eps);
    return cudaGetLastError();
  }
  const int clusters = ln_bwd_clusters<T, NJ>();
  if (clusters == 0) return cudaErrorInvalidValue;
  const int grid = std::min((blocks + LN_CLUSTER - 1) / LN_CLUSTER, clusters) * LN_CLUSTER;
  ln_bwd_train_kernel<T, NJ><<<grid, LN_THREADS, ln_bwd_train_smem(C), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<T*>(y),
      static_cast<float*>(dln), M, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_bwd(const void* x, const void* dy, const void* ln_w, const void* ln_b,
                          const void* g, void* dx, void* y, void* dln, int M, int C, float eps,
                          cudaStream_t stream) {
  switch ((C + 255) / 256) {   // chunks per lane
    case 1: return launch_ln_bwd_nj<T, 1>(x, dy, ln_w, ln_b, g, dx, y, dln, M, C, eps, stream);
    case 2: return launch_ln_bwd_nj<T, 2>(x, dy, ln_w, ln_b, g, dx, y, dln, M, C, eps, stream);
    case 3: return launch_ln_bwd_nj<T, 3>(x, dy, ln_w, ln_b, g, dx, y, dln, M, C, eps, stream);
    case 4: return launch_ln_bwd_nj<T, 4>(x, dy, ln_w, ln_b, g, dx, y, dln, M, C, eps, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_drop_scale(const void* g, void* out, int M, int N, Drop drop,
                              cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + EW_THREADS - 1) / EW_THREADS);
  drop_scale_kernel<T><<<blocks, EW_THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(out), M, N, drop);
  return cudaGetLastError();
}

// the slabs of a split contraction, added in order into out
cudaError_t launch_split_sum(const float* partial, void* out, int splits, size_t n,
                             cudaStream_t stream) {
  const int blocks = (int)std::min<size_t>((n + EW_THREADS - 1) / EW_THREADS, 4096);
  split_sum_kernel<<<blocks, EW_THREADS, 0, stream>>>(partial, static_cast<float*>(out), splits,
                                                      n);
  return cudaGetLastError();
}

// partial: (plan.splits, Na, Nb) fp32 scratch when plan.splits > 1, else unused
cudaError_t launch_gemm_tn_f32(const void* a, const void* b, void* out, void* partial, int M,
                               int Na, int Nb, cudaStream_t stream) {
  const sg::Plan p = sg::plan(Na, Nb, M, true);   // p.bn == TN_BN
  if (p.splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  float* dst = static_cast<float*>(p.splits > 1 ? partial : out);
  constexpr int smem = sg::Tile<TN_BN>::SMEM;
  cudaError_t err = hg::allow_smem<gemm_tn_f32_kernel>(smem);
  if (err != cudaSuccess) return err;
  gemm_tn_f32_kernel<<<dim3(p.tiles_n, p.tiles_m, p.splits), sg::Tile<TN_BN>::THREADS, smem,
                       stream>>>(static_cast<const float*>(a), static_cast<const float*>(b), dst,
                                 M, Na, Nb, p.nkb, p.kps);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  return launch_split_sum(dst, out, p.splits, (size_t)Na * Nb, stream);
}

template <int TBN>
cudaError_t launch_gemm_tn_bf16_tiles(const void* a, const void* b, float* dst, int M, int Na,
                                      int Nb, const hg::Plan& p, cudaStream_t stream) {
  CUtensorMap ta, tb;   // both (M, width) row-major: MN-major boxes of (64 rows, 64 columns)
  cudaError_t err = hg::tensor_map(&ta, a, M, Na, hg::BK);
  if (err == cudaSuccess) err = hg::tensor_map(&tb, b, M, Nb, hg::BK);
  if (err != cudaSuccess) return err;
  constexpr int smem = hg::Tile<TBN>::SMEM;
  err = hg::allow_smem<gemm_tn_bf16_kernel<TBN>>(smem);
  if (err != cudaSuccess) return err;
  gemm_tn_bf16_kernel<TBN><<<p.grid, hg::THREADS, smem, stream>>>(
      ta, tb, TnEpi<TBN>{dst, Na, Nb}, p.tiles_m, p.tiles_n, p.nkb, p.splits);
  return cudaGetLastError();
}

// partial: (plan.splits, Na, Nb) fp32 scratch when plan.splits > 1, else unused
cudaError_t launch_gemm_tn_bf16(const void* a, const void* b, void* out, void* partial, int M,
                                int Na, int Nb, cudaStream_t stream) {
  const hg::Plan p = hg::plan(Na, Nb, M, true);
  if (p.splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  float* dst = static_cast<float*>(p.splits > 1 ? partial : out);
  cudaError_t err = p.bn == 192 ? launch_gemm_tn_bf16_tiles<192>(a, b, dst, M, Na, Nb, p, stream)
                                : launch_gemm_tn_bf16_tiles<128>(a, b, dst, M, Na, Nb, p, stream);
  if (err != cudaSuccess || p.splits == 1) return err;
  return launch_split_sum(dst, out, p.splits, (size_t)Na * Nb, stream);
}

template <typename T>
cudaError_t launch_colsum(const void* a, void* out, int M, int N, cudaStream_t stream) {
  const dim3 grid((N + CS_COLS - 1) / CS_COLS, CS_CLUSTER);
  colsum_kernel<T><<<grid, CS_THREADS, 0, stream>>>(static_cast<const T*>(a),
                                                    static_cast<float*>(out), M, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rmcl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// aux: with gelu, where the pre-GELU value is kept (or null); epi and w_kn
// as described at ln_gemm (w_kn = 1: W is stored (K, N)).  Dropout (see
// Drop) when seeds is not null: rows per sample, draw, keep threshold,
// 1 / (1 - p), an optional (M, N) mask output and the mask column of
// column 0.  ln_scratch: with ln_w, the LayerNorm pass's scratch: (M, 2)
// fp32 row statistics for dtype 0, the (M, K) bf16 LayerNorm output for
// dtype 1; else unused.  dtype 0 runs the statistics pass and the FMA
// kernel, dtype 1 the LayerNorm pass and the wgmma one.
int rmcl_ln_gemm(int dtype, const void* a, const void* ln_w, const void* ln_b, float eps,
                 void* ln_scratch, const void* w, const void* bias, const void* residual,
                 void* aux, void* out, int M, int N, int K, int gelu, int epi, int w_kn,
                 const void* seeds, int rows, unsigned draw, unsigned threshold,
                 float inv_keep, void* mask_out, unsigned col0, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi < EPI_BIAS || epi > EPI_F32 || (epi == EPI_DGELU && aux == nullptr) ||
      (seeds != nullptr && (rows <= 0 || epi == EPI_F32)))
    return (int)cudaErrorInvalidValue;
  const Drop drop{static_cast<const int32_t*>(seeds), rows, draw, threshold, inv_keep,
                  mask_out, col0};
  if (dtype == 0)
    return (int)(w_kn ? launch_gemm_f32<true>(a, ln_w, ln_b, eps, ln_scratch, w, bias,
                                              residual, aux, out, M, N, K, gelu, epi, drop, st)
                      : launch_gemm_f32<false>(a, ln_w, ln_b, eps, ln_scratch, w, bias,
                                               residual, aux, out, M, N, K, gelu, epi, drop,
                                               st));
  if (dtype == 1)
    return (int)(w_kn ? launch_gemm_bf16<true>(a, ln_w, ln_b, eps, ln_scratch, w, bias,
                                               residual, aux, out, M, N, K, gelu, epi, drop, st)
                      : launch_gemm_bf16<false>(a, ln_w, ln_b, eps, ln_scratch, w, bias,
                                                residual, aux, out, M, N, K, gelu, epi, drop,
                                                st));
  return (int)cudaErrorInvalidValue;
}

// The LayerNorm backward: dx = LN'(x)^T dy [+ g] (g null: no + g).  With y
// and dln (and then ln_b) the training form, which also writes y = LN(x)
// rounded and dln (2C,) fp32, the weight gradient then the bias gradient.
// Needs M > 0, C % 8 == 0, C <= rmcl_ln_bwd_max_width() and 16-byte aligned
// buffers.  The training form uses a static device scratch: one such launch
// at a time per device.
int rmcl_ln_bwd(int dtype, const void* x, const void* dy, const void* ln_w, const void* ln_b,
                const void* g, void* dx, void* y, void* dln, int M, int C, float eps,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0 || C % 8 || C > LN_MAX_C || (y == nullptr) != (dln == nullptr) ||
      (y != nullptr && ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_ln_bwd<float>(x, dy, ln_w, ln_b, g, dx, y, dln, M, C, eps, st);
  if (dtype == 1) return (int)launch_ln_bwd<bf16>(x, dy, ln_w, ln_b, g, dx, y, dln, M, C, eps, st);
  return (int)cudaErrorInvalidValue;
}

// the widest row rmcl_ln_bwd takes (not an error code)
int rmcl_ln_bwd_max_width() { return LN_MAX_C; }

// CTAs of rmcl_ln_bwd's training form for M rows of width C on the current
// device, which fixes its summation order (not an error code; 0 for sizes
// it refuses)
int rmcl_ln_bwd_grid(int dtype, int M, int C) {
  if (M <= 0 || C <= 0 || C % 8 || C > LN_MAX_C || (dtype != 0 && dtype != 1)) return 0;
  const int nj = (C + 255) / 256, blocks = (M + LN_ROWS - 1) / LN_ROWS;
  int clusters = 0;
  switch (nj * 2 + dtype) {
    case 2: clusters = ln_bwd_clusters<float, 1>(); break;
    case 3: clusters = ln_bwd_clusters<bf16, 1>(); break;
    case 4: clusters = ln_bwd_clusters<float, 2>(); break;
    case 5: clusters = ln_bwd_clusters<bf16, 2>(); break;
    case 6: clusters = ln_bwd_clusters<float, 3>(); break;
    case 7: clusters = ln_bwd_clusters<bf16, 3>(); break;
    case 8: clusters = ln_bwd_clusters<float, 4>(); break;
    case 9: clusters = ln_bwd_clusters<bf16, 4>(); break;
  }
  return std::min((blocks + LN_CLUSTER - 1) / LN_CLUSTER, clusters) * LN_CLUSTER;
}

int rmcl_drop_scale(int dtype, const void* g, void* out, int M, int N, const void* seeds,
                    int rows, unsigned draw, unsigned threshold, float inv_keep,
                    void* mask_out, unsigned col0, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seeds == nullptr || rows <= 0) return (int)cudaErrorInvalidValue;
  const Drop drop{static_cast<const int32_t*>(seeds), rows, draw, threshold, inv_keep,
                  mask_out, col0};
  if (dtype == 0) return (int)launch_drop_scale<float>(g, out, M, N, drop, st);
  if (dtype == 1) return (int)launch_drop_scale<bf16>(g, out, M, N, drop, st);
  return (int)cudaErrorInvalidValue;
}

// slabs of the (slabs, Na, Nb) fp32 scratch rmcl_gemm_tn needs: 1 = none.
// Each type's plan splits the rows where its output tiles are too few for
// the current device's SMs (dtype 0: sg::plan, dtype 1: hg::plan); the
// count depends only on the shape and the SM count.
int rmcl_gemm_tn_slabs(int dtype, int M, int Na, int Nb) {
  return dtype == 0 ? sg::plan(Na, Nb, M, true).splits
                    : dtype == 1 ? hg::plan(Na, Nb, M, true).splits : 1;
}

// out (Na, Nb) fp32 = a^T . b, a (M, Na), b (M, Nb); partial: the scratch
// rmcl_gemm_tn_slabs asks for, or null when it asks for none.  dtype 0 runs
// the FMA kernel, dtype 1 the wgmma one.
int rmcl_gemm_tn(int dtype, const void* a, const void* b, void* out, void* partial, int M,
                 int Na, int Nb, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_gemm_tn_f32(a, b, out, partial, M, Na, Nb, st);
  if (dtype == 1) return (int)launch_gemm_tn_bf16(a, b, out, partial, M, Na, Nb, st);
  return (int)cudaErrorInvalidValue;
}

// out: (N,) fp32 column sums of a (M, N); needs M > 0, N % 8 == 0 and a
// 16-byte aligned a
int rmcl_colsum(int dtype, const void* a, void* out, int M, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || N % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_colsum<float>(a, out, M, N, st);
  if (dtype == 1) return (int)launch_colsum<bf16>(a, out, M, N, st);
  return (int)cudaErrorInvalidValue;
}

// stats: (B, H, S, 3) fp32 scratch; dqkv: (B, S, 3C), every element written.
// dtype 1 (the wgmma kernels) needs D a multiple of 8 and 16-byte aligned
// buffers, else returns cudaErrorInvalidValue.
int rmcl_masked_attention_bwd(int dtype, const void* qkv, const void* mask,
                              const void* dattn, void* dqkv, void* stats, int B, int S,
                              int H, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_attention_packed_bwd<float>(qkv, mask, dattn, dqkv, stats, B, S, H, D,
                                                   scale, st);
  if (dtype == 1)
    return (int)launch_attention_packed_bwd<bf16>(qkv, mask, dattn, dqkv, stats, B, S, H, D,
                                                  scale, st);
  return (int)cudaErrorInvalidValue;
}

// out: (B, S, C).  dtype 1 (the wgmma kernel) needs D a multiple of 8 and
// 16-byte aligned buffers, else returns cudaErrorInvalidValue.
int rmcl_masked_attention_fwd(int dtype, const void* qkv, const void* mask, void* out,
                              int B, int S, int H, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_attention_packed<float>(qkv, mask, out, B, S, H, D, scale, st);
  if (dtype == 1)
    return (int)launch_attention_packed<bf16>(qkv, mask, out, B, S, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The attention core on (B, H, S, D) operands (pallas_attention.py:_fwd_impl).
// q, k and v share the element strides (qb, qh, qs); out has (ob, oh, os);
// d is contiguous in every operand.  dtype 1 (the wgmma kernel) needs D a
// multiple of 8, 16-byte aligned bases and every stride a multiple of 8
// elements, else returns cudaErrorInvalidValue.
int rmcl_attention_fwd(int dtype, const void* q, const void* k, const void* v, long long qb,
                       long long qh, long long qs, const void* mask, void* out, long long ob,
                       long long oh, long long os, int B, int S, int H, int D, float scale,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  const Strides in{qb, qh, qs}, out_s{ob, oh, os};
  if (dtype == 0)
    return (int)launch_attention<float>(static_cast<const float*>(q),
                                        static_cast<const float*>(k),
                                        static_cast<const float*>(v), in, mask, out, out_s, B,
                                        S, H, D, scale, st);
  if (dtype == 1)
    return (int)launch_attention<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                       static_cast<const bf16*>(v), in, mask, out, out_s, B, S,
                                       H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Its backward (pallas_attention.py:_bwd_impl), with that kernel's rounding
// points.  g has the strides (gb, gh, gs); dq, dk and dv share (db, dh, ds);
// stats: (B, H, S, 3) fp32 scratch.  dtype 1 (the wgmma kernels) needs D a
// multiple of 8, 16-byte aligned bases and every stride a multiple of 8
// elements, else returns cudaErrorInvalidValue.
int rmcl_attention_bwd(int dtype, const void* q, const void* k, const void* v, long long qb,
                       long long qh, long long qs, const void* mask, const void* g,
                       long long gb, long long gh, long long gs, void* dq, void* dk, void* dv,
                       long long db, long long dh, long long ds, void* stats, int B, int S,
                       int H, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  const Strides in{qb, qh, qs}, g_s{gb, gh, gs}, d_s{db, dh, ds};
  if (dtype == 0)
    return (int)launch_attention_bwd<float, false>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        in, mask, static_cast<const float*>(g), g_s, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), d_s, stats, B, S, H, D, scale, st);
  if (dtype == 1)
    return (int)launch_attention_bwd<bf16, false>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        in, mask, static_cast<const bf16*>(g), g_s, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), d_s, stats, B, S, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
