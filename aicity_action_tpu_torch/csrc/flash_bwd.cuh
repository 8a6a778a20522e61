// The flash-attention backward pieces that the plain backward
// (flash_attention.cu) and the fused-LN backward (flash_attention_ln_bwd.cu)
// share: the K/V loop of a 64-row dq tile, and the dk/dv kernel over a
// 64-key tile with query splits into f32 partials. Both follow the Pallas
// kernels' operand discipline: the logits are f32 products of bf16(q * s)
// with k (so they match the saved lse), P and dS are rounded to bf16 for
// their products (dS for dq as a bf16 pair hi + lo, see dq_tile_loop).
#pragma once

#include <math.h>

#include "common.cuh"

namespace aicity {

constexpr int BW_T = 64, BW_THREADS = 128;

// (x0, x1) as packed bf16 hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y));
}

// The K/V loop of a 64-row dq tile, 4 warps of 16 rows each (this warp's
// rows g and g + 8 of its m16 tile): for every 64-key tile of the token rows
// kg, vg [Lk][D], streamed through the two stages ks / vs (cp.async; the
// caller has committed tile 0 into stage 0), per 32 keys S = qa k^T,
// P = exp(S - lse), dP = da v^T, dS = P (dP - delta), acc += dS k. qa holds
// the A fragments of bf16(q * s), da those of dO; keys past Lk get P = 0.
template <int D>
__device__ __forceinline__ void dq_tile_loop(
    const uint32_t (&qa)[D / 16][4], const uint32_t (&da)[D / 16][4],
    bf16* ks, bf16* vs, const bf16* kg, const bf16* vg, int Lk, float lse0,
    float lse1, float dl0, float dl1, float (&acc)[D / 8][4]) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int TILE = BW_T * LD;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ntiles = (Lk + BW_T - 1) / BW_T;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      const int j1 = (j + 1) * BW_T;
      load_tile_async(ks + nb * TILE, LD, kg, D, j1, Lk, 0, BW_T, D);
      load_tile_async(vs + nb * TILE, LD, vg, D, j1, Lk, 0, BW_T, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + (j & 1) * TILE;
    const bf16* vt = vs + (j & 1) * TILE;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kb = half * 32;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          load_b_frag_x2(b, kt, LD, kb + np * 16, kk * 16, lane);
          mma_16816(s[2 * np], qa[kk], b);
          mma_16816(s[2 * np + 1], qa[kk], b + 2);
          load_b_frag_x2(b, vt, LD, kb + np * 16, kk * 16, lane);
          mma_16816(dp[2 * np], da[kk], b);
          mma_16816(dp[2 * np + 1], da[kk], b + 2);
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int key = j * BW_T + kb + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key + (e & 1) < Lk;
          const float p = ok ? __expf(s[nt][e] - (e < 2 ? lse0 : lse1)) : 0.f;
          s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1));  // dS
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // dS as a bf16 pair hi + lo: dq = sum dS (k - mean k) cancels
        // (each row of dS sums to zero), so one bf16 rounding of dS is
        // amplified in dq; the second product keeps it near f32
        uint32_t a[4], al[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], a[0], al[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], a[1], al[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], a[2], al[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], a[3], al[3]);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b[4];
          load_b_frag_trans_x2(b, kt, LD, kb + kk * 16, nd * 8, lane);
          mma_16816(acc[nd], a, b);
          mma_16816(acc[nd + 1], a, b + 2);
          mma_16816(acc[nd], al, b);
          mma_16816(acc[nd + 1], al, b + 2);
        }
      }
    }
    __syncthreads();
  }

}

// dk / dv of a 64-key tile over the queries [split * qps, (split+1) * qps):
// 4 warps own 16 keys each; q / dO tiles of 64 rows stream through shared
// memory with their lse / delta. Computed transposed, keys as rows:
// S^T = k bf16(q s)^T, P^T = exp(S^T - lse), dP^T = v dO^T,
// dS^T = bf16(P^T (dP^T - delta)); dv += bf16(P^T) dO, dk += dS^T bf16(q s).
// Writes f32 partials [split][G][Lk][D].
template <int D>
__global__ void __launch_bounds__(BW_THREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int G, int Lq, int Lk,
                         float scale, int qps) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int TILE = BW_T * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* vs = ks + TILE;                          // [64][LD]
  bf16* qs = vs + TILE;                          // 2 stages
  bf16* dos = qs + 2 * TILE;                     // 2 stages
  float* ls = reinterpret_cast<float*>(dos + 2 * TILE);  // 2 x [64] lse
  float* dls = ls + 2 * BW_T;                             // 2 x [64] delta

  const int k0 = blockIdx.x * BW_T;
  const int grp = blockIdx.y;
  const int split = blockIdx.z;
  const int qa0 = split * qps;
  const int qb = min(Lq, qa0 + qps);
  const int ntq = (qb - qa0 + BW_T - 1) / BW_T;
  const bf16* qg = q + (size_t)grp * Lq * D;
  const bf16* dg = dout + (size_t)grp * Lq * D;
  const float* lg = lse + (size_t)grp * Lq;
  const float* dlg = delta + (size_t)grp * Lq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp * 16;

  auto fetch = [&](int i) {
    const int st = i & 1;
    const int row0 = qa0 + i * BW_T;
    load_tile_async(qs + st * TILE, LD, qg, D, row0, qb, 0, BW_T, D);
    load_tile_async(dos + st * TILE, LD, dg, D, row0, qb, 0, BW_T, D);
    for (int r = threadIdx.x; r < BW_T; r += blockDim.x) {
      const int row = row0 + r;
      ls[st * BW_T + r] = row < qb ? lg[row] : INFINITY;
      dls[st * BW_T + r] = row < qb ? dlg[row] : 0.f;
    }
  };
  load_tile_async(ks, LD, k + (size_t)grp * Lk * D, D, k0, Lk, 0, BW_T, D);
  load_tile_async(vs, LD, v + (size_t)grp * Lk * D, D, k0, Lk, 0, BW_T, D);
  if (ntq > 0) fetch(0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int i = 0; i < ntq; ++i) {
    if (i + 1 < ntq) {
      fetch(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = i & 1;
    bf16* qt = qs + st * TILE;
    const bf16* dt = dos + st * TILE;
    const float* lt = ls + st * BW_T;
    const float* dlt = dls + st * BW_T;
    // bf16(q * scale) in place: the Pallas kernel's operand for S and dk
    for (int e = threadIdx.x; e < BW_T * D / 2; e += blockDim.x) {
      const int r = e / (D / 2), c = (e - r * (D / 2)) * 2;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(qt + r * LD + c);
      const __nv_bfloat162 x = *p;
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(
          __bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qb0 = half * 32;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        load_a_frag(ka, ks, LD, wk, kk * 16, lane);
        load_a_frag(va, vs, LD, wk, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          load_b_frag_x2(b, qt, LD, qb0 + np * 16, kk * 16, lane);
          mma_16816(s[2 * np], ka, b);
          mma_16816(s[2 * np + 1], ka, b + 2);
          load_b_frag_x2(b, dt, LD, qb0 + np * 16, kk * 16, lane);
          mma_16816(dp[2 * np], va, b);
          mma_16816(dp[2 * np + 1], va, b + 2);
        }
      }
      float ds[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qb0 + nt * 8 + 2 * t + (e & 1);
          const float p = __expf(s[nt][e] - lt[col]);
          s[nt][e] = p;
          ds[nt][e] = p * (dp[nt][e] - dlt[col]);
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        sa[0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
        sa[1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
        sa[2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
        sa[3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b[4];
          load_b_frag_trans_x2(b, dt, LD, qb0 + kk * 16, nd * 8, lane);
          mma_16816(dva[nd], pa, b);
          mma_16816(dva[nd + 1], pa, b + 2);
          load_b_frag_trans_x2(b, qt, LD, qb0 + kk * 16, nd * 8, lane);
          mma_16816(dka[nd], sa, b);
          mma_16816(dka[nd + 1], sa, b + 2);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  const size_t base = ((size_t)split * G + grp) * Lk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + wk + g + 8 * h;
    if (key >= Lk) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk_part + (base + key) * D + col) =
          make_float2(dka[nd][2 * h], dka[nd][2 * h + 1]);
      *reinterpret_cast<float2*>(dv_part + (base + key) * D + col) =
          make_float2(dva[nd][2 * h], dva[nd][2 * h + 1]);
    }
  }
}

}  // namespace aicity
