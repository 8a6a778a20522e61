// Backward of the fused LayerNorm + MLP for Hopper:
// out = fc2(gelu(fc1(LN(x))))  ->  dx, dW1, db1, dW2, db2, dgamma, dbeta.
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_mlp_bwd_kernel
// (:414) and _ln_mlp_bwd_hsplit_kernel (:533) (reached through
// fused_ln_mlp's custom VJP, :694), which every MViT block runs in
// training: x [M, C] with M from 401408 (block 0, batch 4) down to 6272,
// C in {96, 192, 384, 768}, H = 4C. About 10*M*C*H flops against
// 2*M*3C bytes of activations and the weights: bound by the tensor cores.
//
// Like the Pallas kernels, the forward saves only x and the parameters, and
// the backward recomputes LN -> fc1 -> GELU per row tile and hidden chunk,
// so the hidden activation never reaches device memory. The Pallas kernels
// add dW1 / dW2 into resident blocks across a sequential grid (and at
// C = 768, where both weights and their f32 gradients do not fit, split the
// hidden dim and emit f32 dLN(x) partials). GPU blocks run in no order and
// 227 KB of shared memory holds no whole weight gradient, so one design
// serves all four widths with two kernels and f32 per-block partials summed
// by a second pass (reduce_splits; fixed order, no atomics):
// - mlp_bwd_dx_kernel owns a TM-row tile: it normalizes the rows once, then
//   for each HC-wide hidden chunk (W1 / W2 chunks through a cp.async ring)
//   recomputes h_pre = LN(x) W1c^T + b1c, forms dh = dOut W2c and
//   dh_pre = dh * gelu'(h_pre), and accumulates dLN(x) += bf16(dh_pre) W1c
//   in registers (TM x C <= 24576); then the LN backward (ln_bwd.cuh) writes
//   dx and the tile's dgamma / dbeta / db2 partials.
// - mlp_bwd_dw_kernel owns one HC-wide hidden chunk and a range of rows,
//   with W1c and W2c resident in shared memory: per 32/64-row step it
//   recomputes LN(x), h_pre, dh, and adds dW1c += bf16(dh_pre)^T LN(x),
//   dW2c += dOut^T bf16(gelu(h_pre)) and db1c += sum dh_pre (accumulators
//   2 * HC * C <= 24576). Narrow blocks have few hidden chunks, so the rows
//   are split to fill the card, each split writing an f32 partial.
// The two kernels recompute h_pre and dh each (14 instead of 10 M*C*H
// flops); the price of never storing the hidden activation. GELU is the
// exact erff and its derivative 0.5 (1 + erf(x / sqrt2)) + x phi(x) (the
// Pallas kernel's polynomial exists only because Mosaic has no erf). bf16
// products, f32 sums; the weight gradients are rounded to bf16 at the end,
// as the Pallas wrapper rounds them to the weights' compute type.
#include "common.cuh"
#include "ln_bwd.cuh"

namespace aicity {

constexpr int MB_THREADS = 256;

__device__ __forceinline__ float gelu_f(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad_f(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * __expf(-0.5f * x * x) * 0.3989422804014327f;
}

// Row tile TM of width C, hidden chunk HC, STAGES of the weight ring; WGM1
// warps along the rows for the h_pre / dh tiles, WGM2 for the dLN(x)
// accumulator (the other 8 / WGM warps split the columns).
template <int C, int TM, int HC, int STAGES, int WGM1, int WGM2>
struct MlpBwdCfg {
  static constexpr int LDX = C + 8, LDH = HC + 8;
  static constexpr int MT = TM / 16;
  static constexpr int MW1 = MT / WGM1, NW1 = (HC / 8) / (8 / WGM1);
  static constexpr int MW2 = MT / WGM2, NW2 = (C / 8) / (8 / WGM2);
  static constexpr int W1_ELEMS = HC * LDX, W2_ELEMS = C * LDH;
  static constexpr int STAGE_ELEMS = W1_ELEMS + W2_ELEMS;
  static constexpr size_t SMEM =
      (size_t)(2 * TM * LDX + STAGES * STAGE_ELEMS + TM * LDH) * sizeof(bf16) +
      (size_t)(4 * TM + 3 * C) * sizeof(float);
  static_assert(MT % WGM1 == 0 && (HC / 8) % (8 / WGM1) == 0, "h grid");
  static_assert(MT % WGM2 == 0 && (C / 8) % (8 / WGM2) == 0, "dx grid");
  static_assert(NW2 % 2 == 0, "dx tiles come in pairs");
  static_assert(MW2 * NW2 * 4 <= 96, "dx accumulator");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int C, int TM, int HC, int STAGES, int WGM1, int WGM2>
__global__ void __launch_bounds__(MB_THREADS)
    mlp_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ beta, const bf16* __restrict__ w1,
                      const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ gout, bf16* __restrict__ dx,
                      float* __restrict__ part, int M, int H, float eps) {
  using K = MlpBwdCfg<C, TM, HC, STAGES, WGM1, WGM2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [TM][LDX] LN(x)
  bf16* gs = xs + TM * K::LDX;                   // [TM][LDX] dOut
  bf16* ring = gs + TM * K::LDX;                 // STAGES x (W1c, W2c)
  bf16* hs = ring + STAGES * K::STAGE_ELEMS;     // [TM][LDH] bf16(dh_pre)
  float* s_mean = reinterpret_cast<float*>(hs + TM * K::LDH);
  float* s_rstd = s_mean + TM;
  float* s_m1 = s_rstd + TM;
  float* s_m2 = s_m1 + TM;
  float* s_dg = s_m2 + TM;
  float* s_db = s_dg + C;
  float* s_db2 = s_db + C;

  const int row0 = blockIdx.x * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm1 = warp % WGM1, wn1 = warp / WGM1;
  const int wm2 = warp % WGM2, wn2 = warp / WGM2;
  const int nchunks = H / HC;

  // W1 rows [h0, h0+HC) x all C, W2 all C rows x columns [h0, h0+HC)
  auto fetch = [&](int chunk) {
    bf16* w1s = ring + (chunk % STAGES) * K::STAGE_ELEMS;
    load_tile_async(w1s, K::LDX, w1, C, chunk * HC, H, 0, HC, C);
    load_tile_async(w1s + K::W1_ELEMS, K::LDH, w2, H, 0, C, chunk * HC, C,
                    HC);
  };
  load_tile_async(xs, K::LDX, x, C, row0, M, 0, TM, C);
  load_tile_async(gs, K::LDX, gout, C, row0, M, 0, TM, C);
  cp_async_commit();
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) fetch(s);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < 2 * TM + 3 * C; i += blockDim.x)
    s_m1[i] = 0.f;  // s_m1, s_m2, s_dg, s_db, s_db2
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  norm_rows_stats(xs, K::LDX, TM, C, gamma, beta, eps, s_mean, s_rstd);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sacc = 0.f;
    for (int r = 0; r < TM; ++r) sacc += __bfloat162float(gs[r * K::LDX + c]);
    s_db2[c] = sacc;
  }

  float acc[K::MW2][K::NW2][4];
#pragma unroll
  for (int mi = 0; mi < K::MW2; ++mi)
#pragma unroll
    for (int ni = 0; ni < K::NW2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int i = 0; i < nchunks; ++i) {
    if (i + STAGES - 1 < nchunks) fetch(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // chunk i has landed (and, at i == 0, xs is normed)
    const bf16* w1s = ring + (i % STAGES) * K::STAGE_ELEMS;
    const bf16* w2s = w1s + K::W1_ELEMS;
    const int h0 = i * HC;
    {
      float hacc[K::MW1][K::NW1][4], dacc[K::MW1][K::NW1][4];
#pragma unroll
      for (int mi = 0; mi < K::MW1; ++mi)
#pragma unroll
        for (int ni = 0; ni < K::NW1; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[mi][ni][e] = dacc[mi][ni][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[K::MW1][4], ga[K::MW1][4];
#pragma unroll
        for (int mi = 0; mi < K::MW1; ++mi) {
          load_a_frag(a[mi], xs, K::LDX, (wm1 * K::MW1 + mi) * 16, k0, lane);
          load_a_frag(ga[mi], gs, K::LDX, (wm1 * K::MW1 + mi) * 16, k0, lane);
        }
#pragma unroll
        for (int ni = 0; ni < K::NW1; ++ni) {
          const int n = (wn1 * K::NW1 + ni) * 8;
          uint32_t b[2], bt[2];
          load_b_frag(b, w1s, K::LDX, n, k0, lane);
          load_b_frag_trans(bt, w2s, K::LDH, k0, n, lane);
#pragma unroll
          for (int mi = 0; mi < K::MW1; ++mi) {
            mma_16816(hacc[mi][ni], a[mi], b);
            mma_16816(dacc[mi][ni], ga[mi], bt);
          }
        }
      }
#pragma unroll
      for (int ni = 0; ni < K::NW1; ++ni) {
        const int hc = (wn1 * K::NW1 + ni) * 8 + 2 * t;
        const float bb0 = __bfloat162float(b1[h0 + hc]);
        const float bb1 = __bfloat162float(b1[h0 + hc + 1]);
#pragma unroll
        for (int mi = 0; mi < K::MW1; ++mi) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = dacc[mi][ni][e] *
                   gelu_grad_f(hacc[mi][ni][e] + ((e & 1) ? bb1 : bb0));
          const int r = (wm1 * K::MW1 + mi) * 16 + g;
          *reinterpret_cast<uint32_t*>(hs + r * K::LDH + hc) =
              pack_bf16(d[0], d[1]);
          *reinterpret_cast<uint32_t*>(hs + (r + 8) * K::LDH + hc) =
              pack_bf16(d[2], d[3]);
        }
      }
    }
    __syncthreads();

    // dLN(x) += bf16(dh_pre) W1c over this warp's MW2 x NW2 tiles
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      uint32_t a[K::MW2][4];
#pragma unroll
      for (int mi = 0; mi < K::MW2; ++mi)
        load_a_frag(a[mi], hs, K::LDH, (wm2 * K::MW2 + mi) * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < K::NW2 / 2; ++np) {
        uint32_t b[4];
        load_b_frag_trans_x2(b, w1s, K::LDX, kk, (wn2 * K::NW2 + 2 * np) * 8,
                             lane);
#pragma unroll
        for (int mi = 0; mi < K::MW2; ++mi) {
          mma_16816(acc[mi][2 * np], a[mi], b);
          mma_16816(acc[mi][2 * np + 1], a[mi], b + 2);
        }
      }
    }
    __syncthreads();  // this stage and hs are rewritten next iteration
  }

  ln_bwd_epilogue<K::MW2, K::NW2>(acc, wm2 * K::MW2 * 16, wn2 * K::NW2 * 8,
                                  row0, M, C, x, gamma, s_mean, s_rstd, s_m1,
                                  s_m2, s_dg, s_db, dx);
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * C; c += blockDim.x)
    part[(size_t)blockIdx.x * 3 * C + c] = s_dg[c];  // dgamma, dbeta, db2
}

// Hidden chunk HC of width C, TMB rows per step; WGH warps along the hidden
// chunk for the weight-gradient tiles (the other 8 / WGH split C).
template <int C, int HC, int TMB, int WGH>
struct MlpDwCfg {
  static constexpr int LDX = C + 8, LDH = HC + 8;
  static constexpr int WGC = 8 / WGH;
  static constexpr int MT1 = HC / WGH / 16, NT1 = C / WGC / 8;  // dW1c
  static constexpr int MT2 = C / WGC / 16, NT2 = HC / WGH / 8;  // dW2c
  static constexpr size_t SMEM =
      (size_t)(HC * LDX + C * LDH + 2 * TMB * LDX + 2 * TMB * LDH) *
          sizeof(bf16) +
      (size_t)2 * TMB * HC * sizeof(float);
  static_assert(MT1 >= 1 && NT1 % 2 == 0 && NT2 % 2 == 0, "dW grid");
  static_assert((MT1 * NT1 + MT2 * NT2) * 4 <= 96, "dW accumulators");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int C, int HC, int TMB, int WGH>
__global__ void __launch_bounds__(MB_THREADS)
    mlp_bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ beta, const bf16* __restrict__ w1,
                      const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ gout,
                      float* __restrict__ dw1_part,
                      float* __restrict__ dw2_part,
                      float* __restrict__ db1_part, int M, int H, float eps,
                      int rps) {
  using K = MlpDwCfg<C, HC, TMB, WGH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w1s = reinterpret_cast<bf16*>(smem_raw);  // [HC][LDX]
  bf16* w2s = w1s + HC * K::LDX;                  // [C][LDH]
  bf16* xs = w2s + C * K::LDH;                    // [TMB][LDX] LN(x)
  bf16* gs = xs + TMB * K::LDX;                   // [TMB][LDX] dOut
  bf16* hs = gs + TMB * K::LDX;                   // [TMB][LDH] bf16(gelu)
  bf16* dhs = hs + TMB * K::LDH;                  // [TMB][LDH] bf16(dh_pre)
  float* hpf = reinterpret_cast<float*>(dhs + TMB * K::LDH);  // h_pre
  float* dhf = hpf + TMB * HC;                                // dh, dh_pre

  const int h0 = blockIdx.x * HC;
  const int split = blockIdx.y;
  const int ms = split * rps, me = min(M, ms + rps);
  const int nsteps = (me - ms + TMB - 1) / TMB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wh = warp % WGH, wc = warp / WGH;

  load_tile_async(w1s, K::LDX, w1, C, h0, H, 0, HC, C);
  load_tile_async(w2s, K::LDH, w2, H, 0, C, h0, C, HC);
  cp_async_commit();

  float a1[K::MT1][K::NT1][4], a2[K::MT2][K::NT2][4];
#pragma unroll
  for (int mi = 0; mi < K::MT1; ++mi)
#pragma unroll
    for (int ni = 0; ni < K::NT1; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) a1[mi][ni][e] = 0.f;
#pragma unroll
  for (int mi = 0; mi < K::MT2; ++mi)
#pragma unroll
    for (int ni = 0; ni < K::NT2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) a2[mi][ni][e] = 0.f;
  float db1acc = 0.f;

  constexpr int TH = (TMB / 16) * (HC / 16);  // m16 x n16 tiles per product
  for (int i = 0; i < nsteps; ++i) {
    const int m0 = ms + i * TMB;
    load_tile_async(xs, K::LDX, x, C, m0, me, 0, TMB, C);
    load_tile_async(gs, K::LDX, gout, C, m0, me, 0, TMB, C);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    norm_rows(xs, K::LDX, TMB, C, gamma, beta, eps);
    __syncthreads();

    // h_pre = LN(x) W1c^T and dh = dOut W2c, m16 x n16 tiles over the warps
    for (int tile = warp; tile < 2 * TH; tile += 8) {
      const int prod = tile / TH, idx = tile - prod * TH;
      const int mi = idx / (HC / 16), ni = idx - mi * (HC / 16);
      float c4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4], b[4];
        load_a_frag(a, prod == 0 ? xs : gs, K::LDX, mi * 16, k0, lane);
        if (prod == 0)
          load_b_frag_x2(b, w1s, K::LDX, ni * 16, k0, lane);
        else
          load_b_frag_trans_x2(b, w2s, K::LDH, k0, ni * 16, lane);
        mma_16816(c4[0], a, b);
        mma_16816(c4[1], a, b + 2);
      }
      float* out = prod == 0 ? hpf : dhf;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int c = ni * 16 + nn * 8 + 2 * t, r = mi * 16 + g;
        out[r * HC + c] = c4[nn][0];
        out[r * HC + c + 1] = c4[nn][1];
        out[(r + 8) * HC + c] = c4[nn][2];
        out[(r + 8) * HC + c + 1] = c4[nn][3];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TMB * HC; e += blockDim.x) {
      const int r = e / HC, c = e - r * HC;
      const float hp = hpf[e] + __bfloat162float(b1[h0 + c]);
      const float dp = dhf[e] * gelu_grad_f(hp);
      dhf[e] = dp;
      hs[r * K::LDH + c] = __float2bfloat16(gelu_f(hp));
      dhs[r * K::LDH + c] = __float2bfloat16(dp);
    }
    __syncthreads();
    if (threadIdx.x < HC)  // rows past M carry dOut = 0, so dh_pre = 0
      for (int r = 0; r < TMB; ++r) db1acc += dhf[r * HC + threadIdx.x];

    // dW1c += bf16(dh_pre)^T LN(x); dW2c += dOut^T bf16(gelu(h_pre))
#pragma unroll
    for (int kk = 0; kk < TMB; kk += 16) {
#pragma unroll
      for (int mi = 0; mi < K::MT1; ++mi) {
        uint32_t a[4];
        load_a_frag_trans(a, dhs, K::LDH, (wh * K::MT1 + mi) * 16, kk, lane);
#pragma unroll
        for (int np = 0; np < K::NT1 / 2; ++np) {
          uint32_t b[4];
          load_b_frag_trans_x2(b, xs, K::LDX, kk,
                               (wc * K::NT1 + 2 * np) * 8, lane);
          mma_16816(a1[mi][2 * np], a, b);
          mma_16816(a1[mi][2 * np + 1], a, b + 2);
        }
      }
#pragma unroll
      for (int mi = 0; mi < K::MT2; ++mi) {
        uint32_t a[4];
        load_a_frag_trans(a, gs, K::LDX, (wc * K::MT2 + mi) * 16, kk, lane);
#pragma unroll
        for (int np = 0; np < K::NT2 / 2; ++np) {
          uint32_t b[4];
          load_b_frag_trans_x2(b, hs, K::LDH, kk,
                               (wh * K::NT2 + 2 * np) * 8, lane);
          mma_16816(a2[mi][2 * np], a, b);
          mma_16816(a2[mi][2 * np + 1], a, b + 2);
        }
      }
    }
    __syncthreads();  // xs, gs, hs, dhs are rewritten next step
  }

  // partials: dW1 [split][H][C], dW2 [split][C][H], db1 [split][H]
  float* o1 = dw1_part + (size_t)split * H * C;
  float* o2 = dw2_part + (size_t)split * C * H;
#pragma unroll
  for (int mi = 0; mi < K::MT1; ++mi)
#pragma unroll
    for (int ni = 0; ni < K::NT1; ++ni) {
      const int r = h0 + (wh * K::MT1 + mi) * 16 + g;
      const int c = (wc * K::NT1 + ni) * 8 + 2 * t;
      *reinterpret_cast<float2*>(o1 + (size_t)r * C + c) =
          make_float2(a1[mi][ni][0], a1[mi][ni][1]);
      *reinterpret_cast<float2*>(o1 + (size_t)(r + 8) * C + c) =
          make_float2(a1[mi][ni][2], a1[mi][ni][3]);
    }
#pragma unroll
  for (int mi = 0; mi < K::MT2; ++mi)
#pragma unroll
    for (int ni = 0; ni < K::NT2; ++ni) {
      const int r = (wc * K::MT2 + mi) * 16 + g;
      const int c = h0 + (wh * K::NT2 + ni) * 8 + 2 * t;
      *reinterpret_cast<float2*>(o2 + (size_t)r * H + c) =
          make_float2(a2[mi][ni][0], a2[mi][ni][1]);
      *reinterpret_cast<float2*>(o2 + (size_t)(r + 8) * H + c) =
          make_float2(a2[mi][ni][2], a2[mi][ni][3]);
    }
  if (threadIdx.x < HC)
    db1_part[(size_t)split * H + h0 + threadIdx.x] = db1acc;
}

template <int C, int TM, int HC, int STAGES, int WGM1, int WGM2>
int launch_mlp_bwd_dx(const void* x, const void* gamma, const void* beta,
                      const void* w1, const void* b1, const void* w2,
                      const void* gout, void* dx, void* part, int M, int H,
                      float eps, cudaStream_t stream) {
  using K = MlpBwdCfg<C, TM, HC, STAGES, WGM1, WGM2>;
  auto kernel = mlp_bwd_dx_kernel<C, TM, HC, STAGES, WGM1, WGM2>;
  if (H % HC) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(kernel, K::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(M + TM - 1) / TM, MB_THREADS, K::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)w2, (const bf16*)gout, (bf16*)dx,
      (float*)part, M, H, eps);
  return (int)cudaGetLastError();
}

template <int C, int HC, int TMB, int WGH>
int launch_mlp_bwd_dw(const void* x, const void* gamma, const void* beta,
                      const void* w1, const void* b1, const void* w2,
                      const void* gout, void* dw1_part, void* dw2_part,
                      void* db1_part, int M, int H, float eps, int rps,
                      cudaStream_t stream) {
  using K = MlpDwCfg<C, HC, TMB, WGH>;
  auto kernel = mlp_bwd_dw_kernel<C, HC, TMB, WGH>;
  if (H % HC || rps % TMB) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(kernel, K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (M + rps - 1) / rps;
  kernel<<<dim3(H / HC, nsplit), MB_THREADS, K::SMEM, stream>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)w2, (const bf16*)gout, (float*)dw1_part,
      (float*)dw2_part, (float*)db1_part, M, H, eps, rps);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// Per width C (= D): the dx kernel's row tile, and the dW kernel's hidden
// chunk and row step (rps must be a multiple of it). 0 where C has no
// configuration.
extern "C" int aicity_ln_mlp_bwd_cfg(int C, int which) {
  int rows, hc, step;
  switch (C) {
    case 96: rows = 128; hc = 64; step = 64; break;
    case 192: rows = 64; hc = 64; step = 32; break;
    case 384: rows = 64; hc = 32; step = 32; break;
    case 768: rows = 32; hc = 16; step = 32; break;
    default: return 0;
  }
  return which == 0 ? rows : (which == 1 ? hc : step);
}

// x, gout [M, C]; w1 [H, C]; b1 [H]; w2 [C, H]. Outputs (bf16): dx [M, C],
// dw1 [H, C], db1 [H], dw2 [C, H], dgb [3, C] (dgamma, dbeta, db2).
// Scratch (f32): part [ceil(M / rows), 3, C], dw1_part [nsplit, H, C],
// dw2_part [nsplit, C, H], db1_part [nsplit, H], nsplit = ceil(M / rps).
extern "C" int aicity_ln_mlp_bwd(const void* x, const void* gamma,
                                 const void* beta, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* gout, void* dx, void* dw1,
                                 void* db1, void* dw2, void* dgb, void* part,
                                 void* dw1_part, void* dw2_part,
                                 void* db1_part, int M, int C, int H,
                                 float eps, int rps, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = aicity_ln_mlp_bwd_cfg(C, 0);
  if (!rows || H % 64 || rps <= 0) return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  int err;
  switch (C) {
    case 96:
      err = launch_mlp_bwd_dx<96, 128, 64, 3, 8, 4>(x, gamma, beta, w1, b1, w2,
                                                    gout, dx, part, M, H, eps, s);
      if (!err)
        err = launch_mlp_bwd_dw<96, 64, 64, 4>(x, gamma, beta, w1, b1, w2, gout,
                                               dw1_part, dw2_part, db1_part, M,
                                               H, eps, rps, s);
      break;
    case 192:
      err = launch_mlp_bwd_dx<192, 64, 64, 2, 4, 2>(x, gamma, beta, w1, b1, w2,
                                                    gout, dx, part, M, H, eps, s);
      if (!err)
        err = launch_mlp_bwd_dw<192, 64, 32, 2>(x, gamma, beta, w1, b1, w2,
                                                gout, dw1_part, dw2_part,
                                                db1_part, M, H, eps, rps, s);
      break;
    case 384:
      err = launch_mlp_bwd_dx<384, 64, 32, 2, 4, 1>(x, gamma, beta, w1, b1, w2,
                                                    gout, dx, part, M, H, eps, s);
      if (!err)
        err = launch_mlp_bwd_dw<384, 32, 32, 1>(x, gamma, beta, w1, b1, w2,
                                                gout, dw1_part, dw2_part,
                                                db1_part, M, H, eps, rps, s);
      break;
    default:  // 768
      err = launch_mlp_bwd_dx<768, 32, 32, 1, 2, 1>(x, gamma, beta, w1, b1, w2,
                                                    gout, dx, part, M, H, eps, s);
      if (!err)
        err = launch_mlp_bwd_dw<768, 16, 32, 1>(x, gamma, beta, w1, b1, w2,
                                                gout, dw1_part, dw2_part,
                                                db1_part, M, H, eps, rps, s);
  }
  if (err) return err;
  const int nblocks = (M + rows - 1) / rows;
  const int nsplit = (M + rps - 1) / rps;
  cudaError_t e = reduce_splits((const float*)part, (bf16*)dgb, nblocks,
                                3L * C, s);
  if (e == cudaSuccess)
    e = reduce_splits((const float*)dw1_part, (bf16*)dw1, nsplit, (long)H * C,
                      s);
  if (e == cudaSuccess)
    e = reduce_splits((const float*)dw2_part, (bf16*)dw2, nsplit, (long)C * H,
                      s);
  if (e == cudaSuccess)
    e = reduce_splits((const float*)db1_part, (bf16*)db1, nsplit, (long)H, s);
  return (int)e;
}
