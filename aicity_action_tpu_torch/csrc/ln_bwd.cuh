// The pieces the backwards of the fused LayerNorm + dense layers
// (fused_ln_qkv_bwd.cu, fused_ln_mlp_bwd.cu) share around their GEMMs on the
// hopper.cuh mainloop: the pre-pass's row LayerNorm and its channel-major
// stores, the LN backward over rows, the weights' transposes and the
// fixed-order sums of many f32 partials. Each source wraps the device code
// in kernels of its own name, so that a profile tells the two apart.
//
// The LN backward (the arithmetic of aicity_action_tpu/ops/pallas/
// fused_dense.py:225-230):
//   xhat = (x - mean) * rstd;  dxhat = dxn * gamma
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   dgamma += sum_rows dxn * xhat;  dbeta += sum_rows dxn
#pragma once

#include "hopper.cuh"

namespace aicity {

// ----------------------------------------------------------- the pre-passes

// rows of a pre-pass tile, four threads a row: small tiles, so that the
// narrow batch-1 and block-15 calls still spread over every SM
constexpr int PREP_ROWS = 32;
constexpr int PREP_THREADS = 4 * PREP_ROWS;

// Rows [row0, row0 + PREP_ROWS) of x [M, C], four lanes a row, each holding
// VPL 16-byte vectors (C <= 32 * VPL): the statistics as
// hopper.cuh:ln_stats_rows computes them (stats [Mpad][2], rows past M as
// (0, 0)), and xn = bf16(LN(x)) as hopper.cuh:ln_rows_smem rounds it, into
// the shared tile [PREP_ROWS][C + 8] and, where xn is given, row-major into
// xn [M, C].
template <int VPL>
__device__ __forceinline__ void ln_prep_rows(const bf16* __restrict__ x,
                                             const bf16* __restrict__ gamma,
                                             const bf16* __restrict__ beta,
                                             float2* __restrict__ stats,
                                             bf16* tile, bf16* __restrict__ xn,
                                             int row0, int M, int C,
                                             float eps) {
  const int ldt = C + 8;
  const int lane = threadIdx.x & 31, q = lane & 3, nv = C / 8;
  const int rl = threadIdx.x >> 2, r = row0 + rl;
  uint4 v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = q + 4 * i;
    v[i] = r < M && c < nv ? *reinterpret_cast<const uint4*>(
                                 x + (size_t)r * C + 8 * c)
                           : make_uint4(0u, 0u, 0u, 0u);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) s += sum8(v[i]);
  s += __shfl_xor_sync(~0u, s, 1);
  s += __shfl_xor_sync(~0u, s, 2);
  const float mu = s / C;
  float d2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    if (q + 4 * i < nv) d2 += sqdev8(v[i], mu);
  d2 += __shfl_xor_sync(~0u, d2, 1);
  d2 += __shfl_xor_sync(~0u, d2, 2);
  const float rs = rsqrtf(d2 / C + eps);
  if (q == 0)
    stats[r] = r < M ? make_float2(mu, rs) : make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = q + 4 * i;
    if (c >= nv) continue;
    const uint4 gv = *reinterpret_cast<const uint4*>(gamma + 8 * c);
    const uint4 bv = *reinterpret_cast<const uint4*>(beta + 8 * c);
    const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
    const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = pack_bf16(
          (bf16_lo(w[e]) - mu) * rs * bf16_lo(gw[e]) + bf16_lo(bw[e]),
          (bf16_hi(w[e]) - mu) * rs * bf16_hi(gw[e]) + bf16_hi(bw[e]));
    const uint4 ov = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(tile + rl * ldt + 8 * c) = ov;
    if (xn != nullptr && r < M)
      *reinterpret_cast<uint4*>(xn + (size_t)r * C + 8 * c) = ov;
  }
}

// Columns [row0, row0 + PREP_ROWS) of outT [C][ld] from the block's
// [PREP_ROWS][C + 8] shared tile: one thread per (channel, 8 rows), 16-byte
// stores (ld is a multiple of 8, so a run that starts below M ends within
// ld).
__device__ __forceinline__ void store_transposed(const bf16* tile, int C,
                                                 bf16* outT, int ld,
                                                 int row0, int M) {
  const int ldt = C + 8;
  const unsigned short* u = reinterpret_cast<const unsigned short*>(tile);
  constexpr int RUNS = PREP_ROWS / 8;  // 8-row runs of a channel
  for (int i = threadIdx.x; i < C * RUNS; i += blockDim.x) {
    const int c = i / RUNS, k = i % RUNS, t0 = row0 + 8 * k;
    if (t0 >= M) continue;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = (uint32_t)u[(8 * k + 2 * e) * ldt + c] |
             ((uint32_t)u[(8 * k + 2 * e + 1) * ldt + c] << 16);
    *reinterpret_cast<uint4*>(outT + (size_t)c * ld + t0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The pre-pass kernel of the fewest vectors per lane that cover C (C <= 768:
// VPL 3, 6, 12 or 24), pick(VPL), so that registers follow C.
template <class Pick>
inline auto prep_kernel_for(Pick pick, int C) {
  const int vpl = (C / 8 + 3) / 4;
  return vpl <= 3 ? pick(3) : vpl <= 6 ? pick(6) : vpl <= 12 ? pick(12)
                                                             : pick(24);
}

// --------------------------------------------------- the LN backward over rows

constexpr int LNB_THREADS = 256;

// Dynamic shared memory of the LN backward: each warp's column sums
// [SUMS][C].
__host__ __device__ inline int ln_bwd_smem_bytes(int C, int sums) {
  return (LNB_THREADS / 32) * sums * C * 4;
}

__device__ __forceinline__ void add4(float* p, float a, float b, float c,
                                     float d) {
  float4 v = *reinterpret_cast<float4*>(p);
  v.x += a;
  v.y += b;
  v.z += c;
  v.w += d;
  *reinterpret_cast<float4*>(p) = v;
}

// Rows [blockIdx.x * rpb, + rpb) of x [M, C], one warp a row, each lane
// 4-column groups lane + 32 i (C <= 128 * NI): dx from dxn (f32) and the
// statistics, and the block's column sums of dxn * xhat (dgamma), dxn
// (dbeta) and, with SUMS 3, of gout (the LN+MLP's db2): each lane adds its
// columns of a row to its warp's sums in shared memory (`sums`, [8][SUMS][C]:
// few registers, so that several blocks share an SM), then the warps' sums
// in order go to part [gridDim.x][SUMS][C].
template <int NI, int SUMS>
__device__ __forceinline__ void ln_bwd_rows(const bf16* __restrict__ x,
                                            const float2* __restrict__ stats,
                                            const float* __restrict__ dxn,
                                            const bf16* __restrict__ gamma,
                                            const bf16* __restrict__ gout,
                                            bf16* __restrict__ dx,
                                            float* __restrict__ part, int M,
                                            int C, int rpb, float* sums) {
  static_assert(SUMS == 2 || SUMS == 3, "dgamma, dbeta (and gout's sums)");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = C / 4;
  const int row0 = blockIdx.x * rpb, row1 = min(M, row0 + rpb);
  float* mine = sums + warp * SUMS * C;  // this warp's [SUMS][C]
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int q = lane + 32 * i;
    if (q < ng)
      for (int k = 0; k < SUMS; ++k)
        *reinterpret_cast<float4*>(mine + k * C + 4 * q) =
            make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int rr = row0 + warp; rr < row1; rr += LNB_THREADS / 32) {
    const float2 st = stats[rr];
    float xh[NI][4], e[NI][4];
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int q = lane + 32 * i;
      if (q < ng) {
        const size_t off = (size_t)rr * C + 4 * q;
        const float4 d = *reinterpret_cast<const float4*>(dxn + off);
        const uint2 xv = *reinterpret_cast<const uint2*>(x + off);
        const uint2 gmv = *reinterpret_cast<const uint2*>(gamma + 4 * q);
        const float dv[4] = {d.x, d.y, d.z, d.w};
        const float xs[4] = {bf16_lo(xv.x), bf16_hi(xv.x), bf16_lo(xv.y),
                             bf16_hi(xv.y)};
        const float gm[4] = {bf16_lo(gmv.x), bf16_hi(gmv.x), bf16_lo(gmv.y),
                             bf16_hi(gmv.y)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          xh[i][k] = (xs[k] - st.x) * st.y;
          e[i][k] = dv[k] * gm[k];
          p1 += e[i][k];
          p2 += e[i][k] * xh[i][k];
        }
        add4(mine + 4 * q, dv[0] * xh[i][0], dv[1] * xh[i][1],
             dv[2] * xh[i][2], dv[3] * xh[i][3]);
        add4(mine + C + 4 * q, dv[0], dv[1], dv[2], dv[3]);
        if constexpr (SUMS == 3) {
          const uint2 gv = *reinterpret_cast<const uint2*>(gout + off);
          add4(mine + 2 * C + 4 * q, bf16_lo(gv.x), bf16_hi(gv.x),
               bf16_lo(gv.y), bf16_hi(gv.y));
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) xh[i][k] = e[i][k] = 0.f;
      }
    }
    const float m1 = warp_sum(p1) / C, m2 = warp_sum(p2) / C;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int q = lane + 32 * i;
      if (q >= ng) continue;
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = st.y * (e[i][k] - m1 - xh[i][k] * m2);
      *reinterpret_cast<uint2*>(dx + (size_t)rr * C + 4 * q) =
          make_uint2(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < SUMS * C; c += LNB_THREADS) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_THREADS / 32; ++w) total += sums[w * SUMS * C + c];
    part[(size_t)blockIdx.x * SUMS * C + c] = total;
  }
}

typedef void (*LnBwdKernel)(const bf16*, const float2*, const float*,
                            const bf16*, const bf16*, bf16*, float*, int, int,
                            int);

// Launch of the LN-backward kernel pick(NI) for the fewest 4-column groups
// a lane that cover C (NI 1, 2, 3 or 6: C <= 768).
template <int SUMS, class Pick>
inline cudaError_t launch_ln_bwd(Pick pick, const void* x, const void* stats,
                                 const void* dxn, const void* gamma,
                                 const void* gout, void* dx, void* part, int M,
                                 int C, int rpb, int blocks, cudaStream_t s) {
  const int ni = (C + 127) / 128;
  const LnBwdKernel k = ni <= 1   ? pick(1)
                        : ni <= 2 ? pick(2)
                        : ni <= 3 ? pick(3)
                                  : pick(6);
  const int smem = ln_bwd_smem_bytes(C, SUMS);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<blocks, LNB_THREADS, smem, s>>>(
      (const bf16*)x, (const float2*)stats, (const float*)dxn,
      (const bf16*)gamma, (const bf16*)gout, (bf16*)dx, (float*)part, M, C,
      rpb);
  return cudaGetLastError();
}

// ------------------------------------------------- the weights' transposes

// dst [cols][rows] = src [rows][cols]^T, bf16.
struct Transpose {
  const bf16* src;
  bf16* dst;
  int rows, cols;
};

// Tile `index` of a transpose (32 x 32 through shared memory), by a block
// of 32 x (blockDim.x / 32) threads; nothing past the transpose's tiles.
__device__ __forceinline__ void transpose_tile(const Transpose& t,
                                               int index) {
  __shared__ unsigned short tile[32][33];
  const unsigned short* src = reinterpret_cast<const unsigned short*>(t.src);
  unsigned short* dst = reinterpret_cast<unsigned short*>(t.dst);
  const int tiles_c = (t.cols + 31) / 32;
  if (index >= tiles_c * ((t.rows + 31) / 32)) return;
  const int r0 = (index / tiles_c) * 32, c0 = (index % tiles_c) * 32;
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const int ny = blockDim.x >> 5;
  for (int k = y; k < 32; k += ny)
    if (r0 + k < t.rows && c0 + x < t.cols)
      tile[k][x] = src[(size_t)(r0 + k) * t.cols + c0 + x];
  __syncthreads();
  for (int k = y; k < 32; k += ny)  // row c0 + k of the transpose
    if (c0 + k < t.cols && r0 + x < t.rows)
      dst[(size_t)(c0 + k) * t.rows + r0 + x] = tile[x][k];
}

__host__ __device__ inline int transpose_tiles(const Transpose& t) {
  return ((t.rows + 31) / 32) * ((t.cols + 31) / 32);
}

// ---------------------------------------------------- the partial sums

// Columns [32 cb, 32 cb + 32) of the sum of nsplit f32 slabs of n, by a
// block of 256 threads: its 8 warps each sum every 8th split in order, then
// the 8 sums in order (a fixed order), rounded to bf16.
__device__ __forceinline__ void reduce_cols(const float* __restrict__ part,
                                            bf16* __restrict__ out,
                                            int nsplit, long n, long cb) {
  __shared__ float sums[8][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const long i = cb * 32 + x;
  float s = 0.f;
  if (i < n)
    for (int k = y; k < nsplit; k += 8) s += part[(long)k * n + i];
  sums[y][x] = s;
  __syncthreads();
  if (y == 0 && i < n) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += sums[k][x];
    out[i] = __float2bfloat16(total);
  }
}

// The gradients that a backward sums from f32 partials, all in one launch:
// job j sums nsplit[j] slabs of n[j] into out[j] (bf16) with the grid's
// blocks [start[j], start[j + 1]), each of 256 threads. Where the splits
// are few, a thread sums its columns over the splits in order (as
// common.cuh:reduce_splits): four columns by 16-byte loads where n % 4 ==
// 0 and the slabs and out are aligned for it (vec), else one; where they
// are many, a block takes 32 columns (reduce_cols). The order of every sum
// is fixed.
constexpr int SUM_JOBS = 4, FEW_SPLITS = 16;

struct PartialSums {
  const float* part[SUM_JOBS];
  bf16* out[SUM_JOBS];
  int nsplit[SUM_JOBS];
  int vec[SUM_JOBS];
  long n[SUM_JOBS];
  int start[SUM_JOBS + 1];
};

// Adds job (part, out, nsplit, n) after the `jobs` added so far.
inline void add_sum(PartialSums& p, int& jobs, const float* part, bf16* out,
                    int nsplit, long n) {
  if (jobs == 0) p.start[0] = 0;
  const bool few = nsplit <= FEW_SPLITS;
  const bool vec = few && n % 4 == 0 && (uintptr_t)part % 16 == 0 &&
                   (uintptr_t)out % 8 == 0;
  p.part[jobs] = part;
  p.out[jobs] = out;
  p.nsplit[jobs] = nsplit;
  p.vec[jobs] = vec;
  p.n[jobs] = n;
  const long blocks =
      vec ? (n + 1023) / 1024 : few ? (n + 255) / 256 : (n + 31) / 32;
  p.start[jobs + 1] = p.start[jobs] + (int)blocks;
  for (int j = jobs + 2; j <= SUM_JOBS; ++j) p.start[j] = p.start[jobs + 1];
  ++jobs;
}

// A block of a sums kernel (launched with p.start[SUM_JOBS] blocks of 256
// threads). The job's fields are read by constant indices: a runtime index
// into the kernel's parameters would copy them to every thread's local
// memory.
__device__ __forceinline__ void sum_partials(const PartialSums& p) {
  const int b = blockIdx.x;
  const float* part = nullptr;
  bf16* out = nullptr;
  int nsplit = 0, vec = 0;
  long n = 0, cb = 0;
#pragma unroll
  for (int j = 0; j < SUM_JOBS; ++j)
    if (b >= p.start[j] && b < p.start[j + 1]) {
      part = p.part[j];
      out = p.out[j];
      nsplit = p.nsplit[j];
      vec = p.vec[j];
      n = p.n[j];
      cb = b - p.start[j];
    }
  if (nsplit > FEW_SPLITS) {
    reduce_cols(part, out, nsplit, n, cb);
    return;
  }
  const long i = cb * 256 + threadIdx.x;
  if (vec) {
    const long n4 = n / 4;
    if (i >= n4) return;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nsplit; ++k) {
      const float4 a = p4[(long)k * n4 + i];
      s.x += a.x;
      s.y += a.y;
      s.z += a.z;
      s.w += a.w;
    }
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    return;
  }
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(long)k * n + i];
  out[i] = __float2bfloat16(s);
}

}  // namespace aicity
