// The LayerNorm helpers of the fused post-pool-LN attention, shared by its
// forward (flash_attention_ln.cu) and backward (flash_attention_ln_bwd.cu),
// and of the channel-major pool norm's forward (layer_norm.cu):
// the pool convolutions leave q, k, v d-major ([G][D][L]); these turn them
// into LayerNormed token rows (eps over head_dim, f32 statistics).
#pragma once

#include "common.cuh"

namespace aicity {

// The LayerNorm statistics (mean, rstd) of a token whose D channels lie
// over LANES neighbouring lanes, DL = D / LANES of them in x; (0, 1) where
// !apply. Every lane of the token calls it (they meet by shuffle).
template <int D, int LANES>
__device__ __forceinline__ float2 col_stats(const float (&x)[D / LANES],
                                            float eps, int apply) {
  constexpr int DL = D / LANES;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < DL; ++c) sum += x[c];
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
  return make_float2(mean, rstd);
}

// Columns of a d-major smem tile (src[c][tok], D rows) become LayerNormed
// rows of dst[tok][c] (f32 statistics; a plain transpose when !apply),
// LANES threads a token, each holding D / LANES channels of its column in
// registers: the forward's query tiles (flash_attention_ln.cu), the
// backward's recompute of them (flash_attention_ln_bwd.cu) and the K/V
// pass of both (kv_norm_kernel) sum alike, so LN(k) and LN(v) are summed as
// LN(q) is; the channel-major pool norm takes four lanes a token. Thread
// tid of nthreads (both multiples of 32, like ntok * LANES: the lanes of a
// token meet by shuffle). With s_mean given, each token's mean and rstd
// are kept there too.
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
#pragma unroll
    for (int c = 0; c < DL; ++c)
      x[c] = __bfloat162float(src[(c0 + c) * lds + tok]);
    const float2 st = col_stats<D, LANES>(x, eps, apply);
    const float mean = st.x, rstd = st.y;
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

// ------------------------------------------------- the K/V passes' tiles

// Keys a block of the K/V passes (kv_norm_kernel here, kv_vjp_kernel in
// flash_attention_ln_bwd.cu), two lanes a key as in the forward's query
// tiles.
constexpr int KV_TILE = 64;
constexpr int KV_THREADS = 2 * KV_TILE;
// the row stride (bf16) of a d-major smem tile of KV_TILE keys
constexpr int KV_LDX = KV_TILE + 8;

// Keys [t0, t0 + T) of a d-major group src [D][L] into the smem tile
// s[c * lds + key], zeros past L: 16-byte cp.async copies where L % 8 == 0
// (a warp reads four channels' 128 contiguous bytes each), else 2-byte
// loads. The caller waits (cp_async_wait<0>) and syncs.
template <int D, int T>
__device__ __forceinline__ void load_cols_tile(bf16* s, int lds,
                                               const bf16* __restrict__ src,
                                               int L, int t0) {
  if (L % 8 == 0) {
    constexpr int VPR = T / 8;
    for (int i = threadIdx.x; i < D * VPR; i += blockDim.x) {
      const int c = i / VPR, t = (i - c * VPR) * 8;
      const bool ok = t0 + t < L;
      cp_async16(s + c * lds + t, src + (size_t)c * L + (ok ? t0 + t : 0),
                 ok);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
      const int c = i / T, t = i - c * T;
      s[c * lds + t] = t0 + t < L ? src[(size_t)c * L + t0 + t]
                                  : __float2bfloat16(0.f);
    }
  }
}

// The reverse: the smem tile s[c * lds + key] to keys [t0, min(t0 + T, L))
// of a d-major group dst [D][L], 16-byte stores where L % 8 == 0.
template <int D, int T>
__device__ __forceinline__ void store_cols_tile(bf16* __restrict__ dst, int L,
                                                int t0, const bf16* s,
                                                int lds) {
  if (L % 8 == 0) {
    constexpr int VPR = T / 8;
    for (int i = threadIdx.x; i < D * VPR; i += blockDim.x) {
      const int c = i / VPR, t = (i - c * VPR) * 8;
      if (t0 + t < L)
        *reinterpret_cast<uint4*>(dst + (size_t)c * L + t0 + t) =
            *reinterpret_cast<const uint4*>(s + c * lds + t);
    }
  } else {
    for (int i = threadIdx.x; i < D * T; i += blockDim.x) {
      const int c = i / T, t = i - c * T;
      if (t0 + t < L) dst[(size_t)c * L + t0 + t] = s[c * lds + t];
    }
  }
}

// K and V (blockIdx.z 0 or 1) from the d-major layout [G][D][L] to token
// rows [G][L][D], LayerNormed over D where fk / fv (f32 statistics), a
// tile of KV_TILE keys a block: the d-major tile by 16-byte copies, the
// norm by norm_cols_to_rows (two lanes a key), the tile's rows, which lie
// contiguous in dst, by 16-byte stores. Bound by its bytes: each element
// read and written once.
template <int D>
__global__ void __launch_bounds__(KV_THREADS)
    kv_norm_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ gk, const bf16* __restrict__ bk,
                   const bf16* __restrict__ gv, const bf16* __restrict__ bv,
                   bf16* __restrict__ kn, bf16* __restrict__ vn, int L,
                   float eps, int fk, int fv) {
  constexpr int LDR = D + 8;
  __shared__ __align__(16) bf16 xs[D * KV_LDX];
  __shared__ __align__(16) bf16 rows[KV_TILE * LDR];
  const int z = blockIdx.z, t0 = blockIdx.x * KV_TILE;
  const size_t off = (size_t)blockIdx.y * D * L;
  load_cols_tile<D, KV_TILE>(xs, KV_LDX, (z ? v : k) + off, L, t0);
  cp_async_wait<0>();
  __syncthreads();
  norm_cols_to_rows<D>(xs, KV_LDX, rows, LDR, KV_TILE, z ? gv : gk,
                       z ? bv : bk, eps, z ? fv : fk, threadIdx.x,
                       KV_THREADS);
  __syncthreads();
  bf16* d = (z ? vn : kn) + off + (size_t)t0 * D;
  const int nvec = min(KV_TILE, L - t0) * (D / 8);
  for (int i = threadIdx.x; i < nvec; i += KV_THREADS) {
    const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
    *reinterpret_cast<uint4*>(d + r * D + c) =
        *reinterpret_cast<const uint4*>(rows + r * LDR + c);
  }
}

// The K/V pass of the fused-LN attention at head dim D, K and V in one
// launch.
template <int D>
inline cudaError_t launch_kv_norm(const void* k, const void* v,
                                  const void* gk, const void* bk,
                                  const void* gv, const void* bv, void* kn,
                                  void* vn, int G, int L, float eps, int fk,
                                  int fv, cudaStream_t s) {
  kv_norm_kernel<D><<<dim3((L + KV_TILE - 1) / KV_TILE, G, 2), KV_THREADS,
                       0, s>>>(
      (const bf16*)k, (const bf16*)v, (const bf16*)gk, (const bf16*)bk,
      (const bf16*)gv, (const bf16*)bv, (bf16*)kn, (bf16*)vn, L, eps, fk, fv);
  return cudaGetLastError();
}

}  // namespace aicity
