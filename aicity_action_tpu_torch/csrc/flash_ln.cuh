// The fused post-pool-LN attention's LayerNorm helpers, shared by its
// forward (flash_attention_ln.cu) and backward (flash_attention_ln_bwd.cu):
// the pool convolutions leave q, k, v d-major ([G][D][L]); these turn them
// into LayerNormed token rows (eps over head_dim, f32 statistics).
#pragma once

#include "common.cuh"

namespace aicity {

// Columns of a d-major smem tile (src[c][tok], D rows) become LayerNormed
// rows of dst[tok][c] (f32 statistics; a plain transpose when !apply),
// LANES threads a token, each holding D / LANES channels of its column in
// registers: the forward's query tiles (flash_attention_ln.cu) and the
// backward's recompute of them (flash_attention_ln_bwd.cu) sum alike, so
// both get the same LN(q). Thread tid of nthreads (both multiples of 32,
// like ntok * LANES: the lanes of a token meet by shuffle). With s_mean
// given, each token's mean and rstd are kept there too.
template <int D, int LANES = 2>
__device__ __forceinline__ void norm_cols_to_rows(
    const bf16* src, int lds, bf16* dst, int ldd, int ntok,
    const bf16* gamma, const bf16* beta, float eps, int apply, int tid,
    int nthreads, float* s_mean = nullptr, float* s_rstd = nullptr) {
  constexpr int DL = D / LANES;
  static_assert(D % LANES == 0 && DL % 2 == 0 && 32 % LANES == 0,
                "a token's channels split evenly over its lanes");
  for (int i = tid; i < ntok * LANES; i += nthreads) {
    const int tok = i / LANES, c0 = DL * (i % LANES);
    float x[DL];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      x[c] = __bfloat162float(src[(c0 + c) * lds + tok]);
      sum += x[c];
    }
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) sum += __shfl_xor_sync(~0u, sum, o);
    float mean = 0.f, rstd = 1.f;
    if (apply) {
      mean = sum / D;
      float q = 0.f;
#pragma unroll
      for (int c = 0; c < DL; ++c) q += (x[c] - mean) * (x[c] - mean);
#pragma unroll
      for (int o = 1; o < LANES; o <<= 1) q += __shfl_xor_sync(~0u, q, o);
      rstd = rsqrtf(q / D + eps);
    }
    if (s_mean != nullptr && c0 == 0) {
      s_mean[tok] = mean;
      s_rstd[tok] = rstd;
    }
#pragma unroll
    for (int c = 0; c < DL; c += 2) {
      float y0 = x[c], y1 = x[c + 1];
      if (apply) {
        y0 = (y0 - mean) * rstd * __bfloat162float(gamma[c0 + c]) +
             __bfloat162float(beta[c0 + c]);
        y1 = (y1 - mean) * rstd * __bfloat162float(gamma[c0 + c + 1]) +
             __bfloat162float(beta[c0 + c + 1]);
      }
      *reinterpret_cast<uint32_t*>(dst + tok * ldd + c0 + c) =
          pack_bf16(y0, y1);
    }
  }
}

// K or V from the d-major layout [G][D][L] to token rows [G][L][D],
// LayerNormed over D when apply (f32 statistics), one thread per token, the
// column read once into registers.
template <int D>
__global__ void __launch_bounds__(128)
    kv_rows_kernel(const bf16* __restrict__ src, const bf16* __restrict__ gamma,
                   const bf16* __restrict__ beta, bf16* __restrict__ dst,
                   int L, float eps, int apply) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const bf16* s = src + (size_t)blockIdx.y * D * L + l;  // element c: s[c*L]
  bf16* d = dst + ((size_t)blockIdx.y * L + l) * D;
  float x[D];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    x[c] = __bfloat162float(s[(size_t)c * L]);
    sum += x[c];
  }
  float mean = 0.f, rstd = 1.f;
  if (apply) {
    mean = sum / D;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) q += (x[c] - mean) * (x[c] - mean);
    rstd = rsqrtf(q / D + eps);
  }
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 8) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 2 * j + e;
        y[e] = x[c];
        if (apply)
          y[e] = (y[e] - mean) * rstd * __bfloat162float(gamma[c]) +
                 __bfloat162float(beta[c]);
      }
      w[j] = pack_bf16(y[0], y[1]);
    }
    *reinterpret_cast<uint4*>(d + c0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace aicity
