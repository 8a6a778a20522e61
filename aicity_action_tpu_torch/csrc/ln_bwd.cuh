// The LayerNorm backward the fused LN+dense backward kernels share: row
// statistics, and the epilogue that turns a row tile's dLN(x) accumulators
// (mma.sync m16n8 layout, f32) into dx, with dgamma / dbeta column sums
// gathered in shared memory for the block's partial.
//
//   xhat = (x - mean) * rstd;  dxhat = dxn * gamma
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   dgamma += sum_rows dxn * xhat;  dbeta += sum_rows dxn
//
// (the arithmetic of aicity_action_tpu/ops/pallas/fused_dense.py:225-230)
#pragma once

#include "common.cuh"

namespace aicity {

// Per-row mean and rstd (f32, two passes) of rows [row0, row0 + nrows) of
// the row-major global x [M][D], one warp per row; rows past M get mean 0
// and rstd 1/sqrt(eps) (a zero row). Written to shared memory and, when
// g_mean is given, to global memory.
__device__ __forceinline__ void row_stats(const bf16* __restrict__ x,
                                          int row0, int M, int D, int nrows,
                                          float eps, float* s_mean,
                                          float* s_rstd, float* g_mean,
                                          float* g_rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nrows; r += nwarps) {
    const int gr = row0 + r;
    float mean = 0.f, rstd = rsqrtf(eps);
    if (gr < M) {
      const bf16* row = x + (size_t)gr * D;
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += __bfloat162float(row[c]);
      mean = warp_sum(s) / D;
      float q = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float d = __bfloat162float(row[c]) - mean;
        q += d * d;
      }
      rstd = rsqrtf(warp_sum(q) / D + eps);
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
      if (g_mean != nullptr && gr < M) {
        g_mean[gr] = mean;
        g_rstd[gr] = rstd;
      }
    }
  }
}

// norm_rows that also keeps each row's mean and rstd in shared memory.
__device__ __forceinline__ void norm_rows_stats(bf16* s, int lds, int nrows,
                                                int D, const bf16* gamma,
                                                const bf16* beta, float eps,
                                                float* s_mean, float* s_rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nrows; r += nwarps) {
    bf16* row = s + r * lds;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum += __bfloat162float(row[c]);
    const float mean = warp_sum(sum) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(row[c]) - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + eps);
    for (int c = lane; c < D; c += 32)
      row[c] = __float2bfloat16((__bfloat162float(row[c]) - mean) * rstd *
                                    __bfloat162float(gamma[c]) +
                                __bfloat162float(beta[c]));
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
}

// The LN backward of a row tile. acc[MW][NW][4] holds this warp's dLN(x)
// tiles: rows wrow + mi*16 + g (+8) of the tile, columns wcol + ni*8 + 2t
// (+1). x is the global [M][D] input, rows from row0; s_mean / s_rstd the
// tile's row statistics; s_m1 / s_m2 ([rows], zeroed, synchronized before
// the call) and s_dg / s_db ([D], zeroed) are shared scratch. Writes dx rows
// below M; adds the tile's dgamma / dbeta column sums to s_dg / s_db. Every
// thread of the block must call it (it synchronizes once).
template <int MW, int NW>
__device__ __forceinline__ void ln_bwd_epilogue(
    const float (&acc)[MW][NW][4], int wrow, int wcol, int row0, int M, int D,
    const bf16* __restrict__ x, const bf16* __restrict__ gamma,
    const float* s_mean, const float* s_rstd, float* s_m1, float* s_m2,
    float* s_dg, float* s_db, bf16* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float p1[MW][2], p2[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) p1[mi][h] = p2[mi][h] = 0.f;

#pragma unroll
  for (int ni = 0; ni < NW; ++ni) {
    const int c = wcol + ni * 8 + 2 * t;
    const float g0 = __bfloat162float(gamma[c]);
    const float g1 = __bfloat162float(gamma[c + 1]);
    float cg0 = 0.f, cg1 = 0.f, cb0 = 0.f, cb1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wrow + mi * 16 + g + 8 * h;
        const int gr = row0 + r;
        float x0 = 0.f, x1 = 0.f;
        if (gr < M) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)gr * D + c);
          x0 = __bfloat162float(xv.x);
          x1 = __bfloat162float(xv.y);
        }
        const float mean = s_mean[r], rstd = s_rstd[r];
        const float xh0 = (x0 - mean) * rstd, xh1 = (x1 - mean) * rstd;
        const float d0 = acc[mi][ni][2 * h], d1 = acc[mi][ni][2 * h + 1];
        const float e0 = d0 * g0, e1 = d1 * g1;
        p1[mi][h] += e0 + e1;
        p2[mi][h] += e0 * xh0 + e1 * xh1;
        cg0 += d0 * xh0;
        cg1 += d1 * xh1;
        cb0 += d0;
        cb1 += d1;
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      cg0 += __shfl_xor_sync(0xffffffffu, cg0, o);
      cg1 += __shfl_xor_sync(0xffffffffu, cg1, o);
      cb0 += __shfl_xor_sync(0xffffffffu, cb0, o);
      cb1 += __shfl_xor_sync(0xffffffffu, cb1, o);
    }
    if (g == 0) {
      atomicAdd(s_dg + c, cg0);
      atomicAdd(s_dg + c + 1, cg1);
      atomicAdd(s_db + c, cb0);
      atomicAdd(s_db + c + 1, cb1);
    }
  }
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = p1[mi][h], b = p2[mi][h];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if (t == 0) {
        const int r = wrow + mi * 16 + g + 8 * h;
        atomicAdd(s_m1 + r, a);
        atomicAdd(s_m2 + r, b);
      }
    }
  __syncthreads();

#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + mi * 16 + g + 8 * h;
      const int gr = row0 + r;
      if (gr >= M) continue;
      const float mean = s_mean[r], rstd = s_rstd[r];
      const float m1 = s_m1[r] / D, m2 = s_m2[r] / D;
#pragma unroll
      for (int ni = 0; ni < NW; ++ni) {
        const int c = wcol + ni * 8 + 2 * t;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)gr * D + c);
        const float xh0 = (__bfloat162float(xv.x) - mean) * rstd;
        const float xh1 = (__bfloat162float(xv.y) - mean) * rstd;
        const float e0 = acc[mi][ni][2 * h] * __bfloat162float(gamma[c]);
        const float e1 = acc[mi][ni][2 * h + 1] * __bfloat162float(gamma[c + 1]);
        *reinterpret_cast<uint32_t*>(dx + (size_t)gr * D + c) =
            pack_bf16(rstd * (e0 - m1 - xh0 * m2), rstd * (e1 - m1 - xh1 * m2));
      }
    }
}

}  // namespace aicity
