// Hand-written Hopper kernels for the deterministic ViLT block halves.
//
// Replaces (JAX package, Pallas on the TPU):
//   rmcl_tpu/ops/pallas_block.py:_fwd_impl / _half_block_kernel / _attn_fwd_math
//     (fused_attn_half_det: x + proj(MHA(qkv(LN1 x))))
//   rmcl_tpu/ops/pallas_block.py:_mlp_fwd_impl / _mlp_half_kernel
//     (fused_mlp_half: x + fc2(gelu_erf(fc1(LN2 x))))
//
// The TPU kernels run one sample per grid step with every block weight
// resident in VMEM.  That does not carry over: wqkv alone is 3.5 MB in
// bf16 against the 227 KB of shared memory one block can use.  Here each
// half is a chain of two kernels, launched by rmcl_tpu_torch/ops/fused_block.py:
//   attention half = ln_gemm(LN1 -> qkv + bias) -> masked_attention_fwd
//                    -> ln_gemm(proj + bias + residual)
//   MLP half       = ln_gemm(LN2 -> fc1 + bias -> GELU)
//                    -> ln_gemm(fc2 + bias + residual)
//
// What bounds them on an H100.  A layer's bf16 weights are 14 MB.  At
// serving batch 8 and S = 269 the GEMMs have M = 2,152 rows, about 1,500
// FLOP per weight byte: bound by the tensor cores.  At batch 1 (M = 269)
// they sit near the card's 295 FLOP/byte line and are bound by bytes.  The
// attention core is bound by bytes at every batch (D = 64 contractions).
//
// What the design does about it, in this first version:
//   * ln_gemm is a tiled shared-memory GEMM, one 64x64 output tile per
//     block and a K loop, bf16 through WMMA (fp32 accumulate), fp32 through
//     FMA.  LayerNorm is a prologue applied while the A tile is staged, so
//     the normalised activation never reaches device memory; bias, exact-erf
//     GELU and the residual are an epilogue.  Each M tile reads its weight
//     column panel once per K step: weights stream from L2, not once per
//     sample as a per-sample design would.
//   * masked_attention_fwd reads q, k and v straight from the (B, S, 3C)
//     qkv buffer (column order (3, H, D)), keeps K/V tiles in shared
//     memory and runs an online softmax, so no S x S tensor reaches device
//     memory.
//   * Not yet done (left for later work): the qkv buffer, the attention
//     output and the (S, 4C) MLP hidden pass through device memory, which
//     the TPU kernels kept on chip; no TMA, wgmma or pipelining.
//
// Numerics follow the Pallas kernels: LayerNorm, softmax and every
// accumulation in fp32; activations rounded to the activation type at the
// same points (matmul output, + bias, GELU, + residual, P before P.V);
// key bias -1e30 on masked keys; scores scaled by D**-0.5.
//
// Interface: plain C, loaded with ctypes.  Every entry point takes device
// pointers, sizes and the CUDA stream, launches on that stream, allocates
// nothing, and returns cudaGetLastError().  dtype 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------ ln_gemm
// out[M, N] = epi(LN?(A)[M, K] . W[N, K]^T + bias[N])
//   LN (when ln_w != nullptr): fp32 mean and variance per row over K, then
//   (x - mean) * rsqrt(var + eps) * ln_w + ln_b, rounded to T.
//   epi: round to T, + bias (rounded to T), [exact-erf GELU], [+ residual].
// A, W, residual and out are T; ln_w, ln_b and bias are fp32.
// Needs K % 8 == 0 and 16-byte aligned A and W (the wrapper checks).

constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 256;
constexpr int LDC = BN + 4;

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
ln_gemm_kernel(const T* __restrict__ A, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, float eps,
               const T* __restrict__ W, const float* __restrict__ bias,
               const T* __restrict__ residual, T* __restrict__ out,
               int M, int N, int K, int gelu) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // row stride of the staged tiles: WMMA needs a multiple of 16 bytes;
  // the FMA path reads columns across threads, so an odd stride keeps
  // those reads on distinct banks
  constexpr int LDS = kBf16 ? BK + 8 : BK + 1;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = BK / VEC;

  __shared__ __align__(128) T As[BM * LDS];
  __shared__ __align__(128) T Ws[BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ float s_mean[BM], s_rstd[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  const bool ln = ln_w != nullptr;

  if (ln) {
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const int m = bm + r;
      float mean = 0.f, rstd = 0.f;
      if (m < M) {
        const T* row = A + (size_t)m * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += to_f<T>(row[k]);
        mean = warp_sum(s) / (float)K;
        float ss = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = to_f<T>(row[k]) - mean;
          ss += d * d;
        }
        rstd = 1.f / sqrtf(warp_sum(ss) / (float)K + eps);
      }
      if (lane == 0) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // FMA path: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // WMMA path: warp (wm, wn) owns a 16 x 32 strip of the tile
  const int wm = warp / 2, wn = warp % 2;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> cfrag[2];
  if constexpr (kBf16) {
    nvcuda::wmma::fill_fragment(cfrag[0], 0.f);
    nvcuda::wmma::fill_fragment(cfrag[1], 0.f);
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * CHUNKS; c += GEMM_THREADS) {
      const int r = c / CHUNKS, kc = (c % CHUNKS) * VEC;
      const int m = bm + r, k = k0 + kc;
      float v[VEC];
      if (m < M && k < K) {
        const uint4 raw = *reinterpret_cast<const uint4*>(A + (size_t)m * K + k);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = to_f<T>(e[q]);
        if (ln) {
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            v[q] = ((v[q] - s_mean[r]) * s_rstd[r]) * ln_w[k + q] + ln_b[k + q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) As[r * LDS + kc + q] = from_f<T>(v[q]);
    }
    for (int c = tid; c < BN * CHUNKS; c += GEMM_THREADS) {
      const int r = c / CHUNKS, kc = (c % CHUNKS) * VEC;
      const int n = bn + r, k = k0 + kc;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && k < K) raw = *reinterpret_cast<const uint4*>(W + (size_t)n * K + k);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int q = 0; q < VEC; ++q) Ws[r * LDS + kc + q] = e[q];
    }
    __syncthreads();

    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                               nvcuda::wmma::row_major> afrag;
        nvcuda::wmma::load_matrix_sync(afrag, As + (wm * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // B[k][n] = W[n][k]: the staged W tile read column-major
          nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                 nvcuda::wmma::col_major> bfrag;
          nvcuda::wmma::load_matrix_sync(bfrag, Ws + (wn * 32 + j * 16) * LDS + kk, LDS);
          nvcuda::wmma::mma_sync(cfrag[j], afrag, bfrag, cfrag[j]);
        }
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_f<T>(As[(ty + 16 * i) * LDS + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = to_f<T>(Ws[(tx + 16 * j) * LDS + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (kBf16) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + (wm * 16) * LDC + wn * 32 + j * 16, cfrag[j],
                                      LDC, nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = bm + r, n = bn + c;
    if (m >= M || n >= N) continue;
    float v = rnd<T>(Cs[r * LDC + c]);
    v = rnd<T>(v + rnd<T>(bias[n]));
    if (gelu) v = rnd<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
    if (residual != nullptr) v = rnd<T>(v + to_f<T>(residual[(size_t)m * N + n]));
    out[(size_t)m * N + n] = from_f<T>(v);
  }
}

// ------------------------------------------------------ masked attention
// qkv: (B, S, 3C) with columns in (3, H, D) order; mask: (B, S) int32,
// 1 = valid key; out: (B, S, C) with head h at columns h*D .. h*D+D-1.
// One block per (query tile, head, sample); 8 warps, 8 query rows each.
// K and V tiles are staged in shared memory as fp32; scores, the running
// max and sum, and the output accumulators stay in registers.

constexpr int AQ = 64, AK = 64, ATT_THREADS = 256, ROWS_PER_WARP = AQ / (ATT_THREADS / 32);
constexpr int MAX_D = 128;
constexpr float NEG_BIAS = -1e30f;

inline size_t attention_smem_bytes(int D) {
  // Qs [AQ][D], Ks [AK][D + 1], Vs [AK][D], Ps [AQ][AK], key bias [AK]
  return sizeof(float) * ((size_t)AQ * D + (size_t)AK * (D + 1) + (size_t)AK * D +
                          (size_t)AQ * AK + AK);
}

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
masked_attention_fwd_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ mask,
                            T* __restrict__ out, int S, int H, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + AQ * D;
  float* Vs = Ks + AK * (D + 1);
  float* Ps = Vs + AK * D;
  float* kbias = Ps + AQ * AK;

  const int C = H * D;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* base = qkv + (size_t)b * S * 3 * C;

  for (int idx = tid; idx < AQ * D; idx += ATT_THREADS) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[idx] = s < S ? to_f<T>(base[(size_t)s * 3 * C + h * D + d]) : 0.f;
  }

  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP], o[ROWS_PER_WARP][MAX_D / 32];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) o[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += AK) {
    __syncthreads();  // the previous tile's K, V and bias are consumed
    for (int idx = tid; idx < AK * D; idx += ATT_THREADS) {
      const int j = idx / D, d = idx % D, s = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const T* row = base + (size_t)s * 3 * C + h * D + d;
        kv = to_f<T>(row[C]);
        vv = to_f<T>(row[2 * C]);
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * D + d] = vv;
    }
    for (int j = tid; j < AK; j += ATT_THREADS) {
      const int s = k0 + j;
      // keys past S take no weight at all; masked keys get the -1e30 bias
      kbias[j] = s < S ? (mask[(size_t)b * S + s] > 0 ? 0.f : NEG_BIAS) : -INFINITY;
    }
    __syncthreads();

    float sc[ROWS_PER_WARP][2];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) sc[r][0] = sc[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * (D + 1) + d], kb = Ks[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float q = Qs[(warp * ROWS_PER_WARP + r) * D + d];
        sc[r][0] = fmaf(q, ka, sc[r][0]);
        sc[r][1] = fmaf(q, kb, sc[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const float s0 = sc[r][0] * scale + kbias[lane];
      const float s1 = sc[r][1] * scale + kbias[lane + 32];
      // a tile whose keys are all masked gives a max near -1e30; a later
      // valid key rescales everything gathered so far by exp(-1e30) = 0
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_run[r] - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p0 + p1);
      m_run[r] = m_new;
      float* prow = Ps + (warp * ROWS_PER_WARP + r) * AK;
      prow[lane] = rnd<T>(p0);
      prow[lane + 32] = rnd<T>(p1);
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) o[r][i] *= alpha;
    }
    __syncwarp();

    const int jn = min(AK, S - k0);
    for (int j = 0; j < jn; ++j) {
      float v[MAX_D / 32];
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int d = lane + 32 * i;
        v[i] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const float p = Ps[(warp * ROWS_PER_WARP + r) * AK + j];
#pragma unroll
        for (int i = 0; i < MAX_D / 32; ++i) o[r][i] = fmaf(p, v[i], o[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int s = q0 + warp * ROWS_PER_WARP + r;
    if (s >= S) continue;
    T* orow = out + ((size_t)b * S + s) * C + h * D;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_f<T>(o[r][i] / l_run[r]);
    }
  }
}

template <typename T>
cudaError_t launch_attention(const void* qkv, const void* mask, void* out, int B, int S,
                             int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = attention_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + AQ - 1) / AQ, H, B);
  masked_attention_fwd_kernel<T><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int32_t*>(mask), static_cast<T*>(out),
      S, H, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemm(const void* a, const void* ln_w, const void* ln_b, float eps,
                        const void* w, const void* bias, const void* residual, void* out,
                        int M, int N, int K, int gelu, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ln_gemm_kernel<T><<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), eps, static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(residual), static_cast<T*>(out),
      M, N, K, gelu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rmcl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int rmcl_ln_gemm(int dtype, const void* a, const void* ln_w, const void* ln_b, float eps,
                 const void* w, const void* bias, const void* residual, void* out, int M,
                 int N, int K, int gelu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_gemm<float>(a, ln_w, ln_b, eps, w, bias, residual, out, M, N, K,
                                   gelu, st);
  if (dtype == 1)
    return (int)launch_gemm<bf16>(a, ln_w, ln_b, eps, w, bias, residual, out, M, N, K,
                                  gelu, st);
  return (int)cudaErrorInvalidValue;
}

int rmcl_masked_attention_fwd(int dtype, const void* qkv, const void* mask, void* out,
                              int B, int S, int H, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_attention<float>(qkv, mask, out, B, S, H, D, scale, st);
  if (dtype == 1) return (int)launch_attention<bf16>(qkv, mask, out, B, S, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
