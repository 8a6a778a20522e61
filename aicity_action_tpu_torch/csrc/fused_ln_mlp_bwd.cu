// Backward of the fused LayerNorm + MLP for Hopper:
// out = fc2(gelu(fc1(LN(x))))  ->  dx, dW1, db1, dW2, db2, dgamma, dbeta.
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_mlp_bwd_kernel
// (:414) and _ln_mlp_bwd_hsplit_kernel (:533) (reached through
// fused_ln_mlp's custom VJP, :694), which every MViT block runs in
// training: x [M, C] with M from 401408 (block 0, batch 4) down to 6272,
// C in {96, 192, 384, 768}, H = 4C. 10*M*C*H flops against 2*M*3C bytes of
// activations and the weights: the tensor cores bound it, and at the narrow
// widths the hidden activations this design stores.
//
// The Pallas kernel recomputes LN -> fc1 -> GELU per row tile and adds the
// weight gradients into resident blocks across a sequential grid. GPU
// blocks run in no order and 227 KB of shared memory holds no weight
// gradient, so here the hidden activations go through device memory once
// and every product runs on the wgmma mainloop of hopper.cuh (TMA loads
// through an mbarrier ring, both operands from shared memory), each
// product once (10 M*C*H flops), after mlp_bwd_transpose_kernel has
// written W1^T and W2^T (the K-major operands of launches 2 and 3):
//  1. mlp_bwd_prep_kernel: the LN statistics (mean, rstd) of every row,
//     xn = bf16(LN(x)) row-major, and xn^T and dOut^T channel-major
//     ([C][ld], ld = M rounded up to 8 so that TMA's strides are whole 16
//     bytes), transposed through shared memory.
//  2. mlp_bwd_dual_kernel: per (128-row tile, 128-wide hidden tile), two
//     accumulators over K = C, h_pre = xn W1[tile]^T and dh = dOut
//     W2t[tile]^T (W2t = W2^T, a contiguous copy). The epilogue adds b1,
//     forms h = bf16(gelu(h_pre)) and dh_pre = dh * gelu'(h_pre) in f32,
//     adds dh_pre's column sums to its consumer's db1 partial (a row of
//     its own in device memory, a fixed order), and stores by TMA h^T and dhp^T = bf16(dh_pre)^T
//     channel-major and dhp row-major, each staged by stmatrix (transposed
//     for the channel-major boxes) from bf16 pairs packed in registers.
//  3. mlp_bwd_gemm_kernel: dxn [M, C] = dhp W1t^T (W1t = W1^T), K = H, f32
//     out.
//  4. mlp_bwd_ln_kernel: the LN backward of each row (ln_bwd.cuh's
//     arithmetic) from dxn and the statistics -> dx; per block of rows the
//     dgamma, dbeta and db2 (column sums of dOut) partials.
//  5. mlp_bwd_gemm_kernel twice, split over K = M: dW2 [C, H] = dOut^T h and
//     dW1 [H, C] = dhp^T xn from the channel-major copies (K-major, the
//     mainloop's only layout), each split an f32 partial.
// Every cross-block sum is a set of f32 partials summed in a fixed order
// (reduce_parts; no atomics), rounded to bf16 at the end, as the Pallas
// wrapper rounds the gradients to the weights' compute type. Rounding points
// are the Pallas kernel's: xn, h and dhp bf16; h_pre, dh, dh_pre, dxn and
// every sum f32. GELU is the exact erff and its derivative 0.5 (1 +
// erf(x / sqrt2)) + x phi(x) (the Pallas kernel's polynomial exists only
// because Mosaic has no erf).
#include "hopper.cuh"

namespace aicity {

// 0.5 (1 + erf(x / sqrt 2)): GELU is x times it, its derivative it plus
// x phi(x)
__device__ __forceinline__ float gelu_cdf(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// ------------------------------------------------- launch 1: the pre-pass

// rows of a pre-pass block, four threads a row: small blocks, so that the
// narrow batch-1 and block-15 calls still spread over every SM
constexpr int PREP_ROWS = 32;
constexpr int PREP_THREADS = 4 * PREP_ROWS;

__host__ __device__ inline int prep_smem_bytes(int C) {
  return PREP_ROWS * (C + 8) * 2;
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

// PREP_ROWS rows a block, four lanes a row, each holding VPL 16-byte
// vectors (C <= 32 * VPL): the statistics as hopper.cuh:ln_stats_rows
// computes them (stats [Mpad][2], rows past M as (0, 0)), xn = bf16(LN(x))
// as hopper.cuh:ln_rows_smem rounds it, then xn^T and dOut^T.
template <int VPL>
__global__ void __launch_bounds__(PREP_THREADS)
    mlp_bwd_prep_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta,
                        const bf16* __restrict__ gout,
                        float2* __restrict__ stats, bf16* __restrict__ xn,
                        bf16* __restrict__ xnT, bf16* __restrict__ goutT,
                        int M, int C, int ld, float eps) {
  extern __shared__ __align__(16) unsigned char prep_smem[];
  bf16* tile = reinterpret_cast<bf16*>(prep_smem);
  const int ldt = C + 8;
  const int lane = threadIdx.x & 31, q = lane & 3, nv = C / 8;
  const int rl = threadIdx.x >> 2;
  const int row0 = blockIdx.x * PREP_ROWS, r = row0 + rl;
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
    if (r < M) *reinterpret_cast<uint4*>(xn + (size_t)r * C + 8 * c) = ov;
  }
  __syncthreads();
  store_transposed(tile, C, xnT, ld, row0, M);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = q + 4 * i;
    if (c < nv)
      *reinterpret_cast<uint4*>(tile + rl * ldt + 8 * c) =
          r < M ? *reinterpret_cast<const uint4*>(gout + (size_t)r * C + 8 * c)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  store_transposed(tile, C, goutT, ld, row0, M);
}

typedef void (*PrepKernel)(const bf16*, const bf16*, const bf16*,
                           const bf16*, float2*, bf16*, bf16*, bf16*, int,
                           int, int, float);

// ------------------------------------------- launch 2: the dual GEMM

// Stores four 8x8 bf16 matrices to shared memory: register i of every lane
// holds its pair of matrix i in the mma fragment layout (row lane / 4,
// columns 2 (lane % 4), + 1), and lanes 8i..8i+7 give the addresses of
// matrix i's eight 16-byte rows; with TRANS each matrix is stored
// transposed (row k holds column k).
template <bool TRANS>
__device__ __forceinline__ void stmatrix_x4(const void* row,
                                            const uint32_t* r) {
  if constexpr (TRANS)
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
        "{%1, %2, %3, %4};\n" ::"r"(smem_u32(row)),
        "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
        : "memory");
  else
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
        ::"r"(smem_u32(row)),
        "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
        : "memory");
}

// A ring stage: xn and dOut [128][64], W1 and W2t [TN][64] (bf16, 128-byte
// swizzle).
__host__ __device__ inline int dual_stage_bytes(int tn) {
  return 2 * DENSE_BM * 128 + 2 * tn * 128;
}

// alignment slack, the ring, each consumer's staging box (tn x 64 bf16;
// also its db1 column-sum scratch), each consumer's b1 slice in f32, the
// barriers: three stages fit
__host__ __device__ inline int dual_smem_bytes(int tn, int stages) {
  return 1024 + stages * dual_stage_bytes(tn) + 2 * tn * 128 + 2 * tn * 4 +
         2 * DENSE_MAX_STAGES * 8;
}

struct DualArgs {
  const bf16* b1;   // [H]
  float* db1_part;  // [2 * gridDim.x][H]: each consumer's sums, its own
                    // row, which its thread c mod 128 zeroes and adds to
  int M, H, K;      // xn, dOut [M, K = C]; W1, W2t [H, K]
  int stages;
};

template <int TN>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    mlp_bwd_dual_kernel(const __grid_constant__ CUtensorMap map_xn,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_w1,
                        const __grid_constant__ CUtensorMap map_w2t,
                        const __grid_constant__ CUtensorMap map_ht,
                        const __grid_constant__ CUtensorMap map_dhpt,
                        const __grid_constant__ CUtensorMap map_dhp,
                        const DualArgs p) {
  extern __shared__ unsigned char dual_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ((uintptr_t)dual_smem_raw + 1023) & ~(uintptr_t)1023);
  constexpr int A_BYTES = DENSE_BM * 128;
  constexpr int STAGE = 2 * A_BYTES + 2 * TN * 128;
  static_assert(TN == 128, "a consumer thread per column of the tile");
  unsigned char* stg = ring + p.stages * STAGE;
  float* bsm = reinterpret_cast<float*>(stg + 2 * TN * 128);  // [2][TN]
  uint64_t* full = reinterpret_cast<uint64_t*>(bsm + 2 * TN);
  uint64_t* empty = full + DENSE_MAX_STAGES;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int nk = (p.K + 63) / 64;
  const int n_tiles = p.H / TN;
  const int tiles = ((p.M + DENSE_BM - 1) / DENSE_BM) * n_tiles;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / n_tiles) * DENSE_BM;
      const int n0 = (tile % n_tiles) * TN;
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % p.stages, round = it / p.stages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* st = ring + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load(st, &map_xn, &full[s], kc * 64, row0);
        tma_load(st + A_BYTES, &map_do, &full[s], kc * 64, row0);
        tma_load(st + 2 * A_BYTES, &map_w1, &full[s], kc * 64, n0);
        tma_load(st + 2 * A_BYTES + TN * 128, &map_w2t, &full[s], kc * 64,
                 n0);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3, ctid = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* box = stg + cw * TN * 128;
  float* red = reinterpret_cast<float*>(box);  // [4 warps][TN], db1 sums
  float* bias = bsm + cw * TN;
  // this consumer's db1 row: thread ctid owns the columns ctid mod 128
  float* mydb = p.db1_part + ((size_t)blockIdx.x * 2 + cw) * p.H;
  for (int i = ctid; i < p.H; i += 128) mydb[i] = 0.f;
  // stmatrix.x4 rounds of a packed bf16 tile (pk[2j + h]: rows 8h + g,
  // columns 8j + 2t, 2t + 1 of this warp's 16 rows): lane l gives the row
  // address of 8x8 matrix l / 8, (j, h) = (2 jp + l / 16, l / 8 % 2)
  const int mj = lane >> 4, mh = (lane >> 3) & 1, mi = lane & 7;
  // channel-major [TN][64] box, each matrix transposed (row = channel)
  auto stage_cm = [&](const uint32_t* pk) {
    if (ctid == 0) bulk_wait_read();  // the last stores have left the box
    named_sync(2 + cw, 128);
#pragma unroll
    for (int jp = 0; jp < TN / 16; ++jp) {
      const int c = 8 * (2 * jp + mj) + mi, rr = warp * 16 + 8 * mh;
      stmatrix_x4<true>(box + c * 128 + (((rr >> 3) ^ (c & 7)) << 4),
                        pk + 4 * jp);
    }
    fence_proxy_async();  // the staged box, visible to TMA
    named_sync(2 + cw, 128);
  };
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile / n_tiles) * DENSE_BM;
    const int n0 = (tile % n_tiles) * TN;
    const int r0 = row0 + cw * 64;  // this warpgroup's first row
    const float b1v = __bfloat162float(p.b1[n0 + ctid]);  // under the loop
    float acc_h[TN / 2], acc_d[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc_h[i] = acc_d[i] = 0.f;
    int prev = -1;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % p.stages;
      mbar_wait(&full[s], (it / p.stages) & 1);
      const unsigned char* st = ring + s * STAGE;
      const uint64_t da = desc_sw128(st + cw * 64 * 128);
      const uint64_t dd = desc_sw128(st + A_BYTES + cw * 64 * 128);
      const uint64_t d1 = desc_sw128(st + 2 * A_BYTES);
      const uint64_t d2 = desc_sw128(st + 2 * A_BYTES + TN * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // past K: TMA's zero fill
        WgmmaSS<TN>::mma(acc_h, da + 2 * kk, d1 + 2 * kk);
        WgmmaSS<TN>::mma(acc_d, dd + 2 * kk, d2 + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    fence_regs<TN / 2>(acc_h);
    fence_regs<TN / 2>(acc_d);
    // the tile's b1 published; the box free (the last tile's stores have
    // read it) for the db1 sums
    if (ctid == 0) bulk_wait_read();
    bias[ctid] = b1v;
    named_sync(2 + cw, 128);

    // b1 and the GELU backward in f32: acc_h becomes gelu(h_pre), acc_d
    // dh_pre (rows past M read zero dOut, so their dh_pre is 0)
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hp = acc_h[4 * j + e] + bias[8 * j + 2 * t + (e & 1)];
        const float cdf = gelu_cdf(hp);
        acc_d[4 * j + e] *= cdf + hp * __expf(-0.5f * hp * hp) *
                                      0.3989422804014327f;
        acc_h[4 * j + e] = hp * cdf;
      }
    // db1: column sums of dh_pre over this warp's 16 rows (shuffles over
    // g), then over the warpgroup's four warps in order
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      float s0 = acc_d[4 * j] + acc_d[4 * j + 2];
      float s1 = acc_d[4 * j + 1] + acc_d[4 * j + 3];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(~0u, s0, o);
        s1 += __shfl_xor_sync(~0u, s1, o);
      }
      if (g == 0) {
        red[warp * TN + 8 * j + 2 * t] = s0;
        red[warp * TN + 8 * j + 2 * t + 1] = s1;
      }
    }
    // h and dhp rounded to bf16 pairs, pk[2j + h] as stage_cm takes them
    uint32_t hpk[TN / 4], dpk[TN / 4];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hpk[2 * j + h] = pack_bf16(acc_h[4 * j + 2 * h],
                                   acc_h[4 * j + 2 * h + 1]);
        dpk[2 * j + h] = pack_bf16(acc_d[4 * j + 2 * h],
                                   acc_d[4 * j + 2 * h + 1]);
      }
    named_sync(2 + cw, 128);
    mydb[n0 + ctid] +=
        red[ctid] + red[TN + ctid] + red[2 * TN + ctid] + red[3 * TN + ctid];

    // h^T and dhp^T channel-major, then dhp row-major, through the one box
    stage_cm(hpk);
    if (ctid == 0 && r0 < p.M) {
      tma_store(&map_ht, box, r0, n0);
      bulk_commit();
    }
    stage_cm(dpk);
    if (ctid == 0 && r0 < p.M) {
      tma_store(&map_dhpt, box, r0, n0);
      bulk_commit();
    }
    if (ctid == 0) bulk_wait_read();
    named_sync(2 + cw, 128);
#pragma unroll
    for (int jp = 0; jp < TN / 16; ++jp) {  // [64][64] boxes, row-major
      const int j = 2 * jp + mj;
      stmatrix_x4<false>(
          sw128_chunk(box + (j / 8) * 8192, warp * 16 + 8 * mh + mi, j % 8),
          dpk + 4 * jp);
    }
    fence_proxy_async();
    named_sync(2 + cw, 128);
    if (ctid == 0 && r0 < p.M) {
      for (int b = 0; b < TN / 64; ++b)
        tma_store(&map_dhp, box + b * 8192, n0 + 64 * b, r0);
      bulk_commit();
    }
  }
  bulk_wait_done();  // this thread's asynchronous stores are complete
}

// ------------------------------ launches 3 and 5: the K-major mainloop

template <int TN>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    mlp_bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const DenseArgs args, float* out) {
  dense_block<TN, false>(map_a, map_b, args, F32Store{out});
}

// ------------------------------------------ launch 4: the LN backward

constexpr int LNB_THREADS = 256;

// Dynamic shared memory of the LN backward: each warp's column sums [3][C].
__host__ __device__ inline int ln_bwd_smem_bytes(int C) {
  return (LNB_THREADS / 32) * 3 * C * 4;
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

// Rows [blockIdx.x * rpb, + rpb) of x, one warp a row, each lane 4-column
// groups lane + 32 i (C <= 128 * NI):
//   xhat = (x - mean) * rstd;  dxhat = dxn * gamma
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// and the block's column sums of dxn * xhat (dgamma), dxn (dbeta) and dOut
// (db2): each lane adds its columns of a row to its warp's sums in shared
// memory (few registers, so that several blocks share an SM), then the
// warps' sums in order go to part [gridDim.x][3][C].
template <int NI>
__global__ void __launch_bounds__(LNB_THREADS)
    mlp_bwd_ln_kernel(const bf16* __restrict__ x,
                      const float2* __restrict__ stats,
                      const float* __restrict__ dxn,
                      const bf16* __restrict__ gamma,
                      const bf16* __restrict__ gout, bf16* __restrict__ dx,
                      float* __restrict__ part, int M, int C, int rpb) {
  extern __shared__ __align__(16) float ln_sums[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = C / 4;
  const int row0 = blockIdx.x * rpb, row1 = min(M, row0 + rpb);
  float* mine = ln_sums + warp * 3 * C;  // this warp's [3][C]
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int q = lane + 32 * i;
    if (q < ng)
      for (int k = 0; k < 3; ++k)
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
        const uint2 gv = *reinterpret_cast<const uint2*>(gout + off);
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
        add4(mine + 2 * C + 4 * q, bf16_lo(gv.x), bf16_hi(gv.x),
             bf16_lo(gv.y), bf16_hi(gv.y));
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
  for (int c = threadIdx.x; c < 3 * C; c += LNB_THREADS) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_THREADS / 32; ++w) total += ln_sums[w * 3 * C + c];
    part[(size_t)blockIdx.x * 3 * C + c] = total;
  }
}

// ------------------------------------------- the weights' transposes

// W2^T [H][C] from w2 [C][H] (blockIdx.y 0) and W1^T [C][H] from w1 [H][C]
// (blockIdx.y 1), 32 x 32 tiles through shared memory, blocks of 32 x 8
// threads.
__global__ void __launch_bounds__(256)
    mlp_bwd_transpose_kernel(const bf16* __restrict__ w1,
                             const bf16* __restrict__ w2,
                             bf16* __restrict__ w1t, bf16* __restrict__ w2t,
                             int C, int H) {
  __shared__ unsigned short tile[32][33];
  const bool second = blockIdx.y == 1;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(
      second ? w1 : w2);
  unsigned short* dst = reinterpret_cast<unsigned short*>(second ? w1t : w2t);
  const int rows = second ? H : C, cols = second ? C : H;
  const int tiles_c = (cols + 31) / 32;
  const int r0 = (blockIdx.x / tiles_c) * 32, c0 = (blockIdx.x % tiles_c) * 32;
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  for (int k = y; k < 32; k += 8)
    if (r0 + k < rows && c0 + x < cols)
      tile[k][x] = src[(size_t)(r0 + k) * cols + c0 + x];
  __syncthreads();
  for (int k = y; k < 32; k += 8)  // row c0 + k of the transpose
    if (c0 + k < cols && r0 + x < rows)
      dst[(size_t)(c0 + k) * rows + r0 + x] = tile[x][k];
}

// ---------------------------------------------------- the partial sums

// reduce_splits (common.cuh) for many splits of a short row: 32 columns a
// block, its 8 warps each summing every 8th split in order, then the 8 sums
// in order (a fixed order, as reduce_splits'), rounded to bf16.
__global__ void __launch_bounds__(256)
    mlp_bwd_reduce_kernel(const float* __restrict__ part,
                          bf16* __restrict__ out, int nsplit, long n) {
  __shared__ float sums[8][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const long i = (long)blockIdx.x * 32 + x;
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

// The sum of nsplit f32 slabs of n: one thread a column where the splits
// are few, a block of 32 columns where they are many.
inline cudaError_t reduce_parts(const float* part, bf16* out, int nsplit,
                                long n, cudaStream_t s) {
  if (nsplit <= 16) return reduce_splits(part, out, nsplit, n, s);
  mlp_bwd_reduce_kernel<<<(unsigned)((n + 31) / 32), 256, 0, s>>>(
      part, out, nsplit, n);
  return cudaGetLastError();
}

// ------------------------------------------------------------- host side

inline cudaError_t launch_prep(const void* x, const void* gamma,
                               const void* beta, const void* gout,
                               void* stats, void* xn, void* xnT, void* goutT,
                               int M, int C, int ld, float eps,
                               cudaStream_t s) {
  const int vpl = (C / 8 + 3) / 4;
  const PrepKernel k = vpl <= 3    ? mlp_bwd_prep_kernel<3>
                       : vpl <= 6  ? mlp_bwd_prep_kernel<6>
                       : vpl <= 12 ? mlp_bwd_prep_kernel<12>
                                   : mlp_bwd_prep_kernel<24>;
  const int smem = prep_smem_bytes(C);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<(M + PREP_ROWS - 1) / PREP_ROWS, PREP_THREADS, smem, s>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta,
      (const bf16*)gout, (float2*)stats, (bf16*)xn, (bf16*)xnT, (bf16*)goutT,
      M, C, ld, eps);
  return cudaGetLastError();
}

constexpr int DUAL_TN = 128;

inline cudaError_t launch_dual(const CUtensorMap* maps, const DualArgs& a,
                               int grid, cudaStream_t s) {
  auto kernel = mlp_bwd_dual_kernel<DUAL_TN>;
  static bool ready = false;
  cudaError_t err = prepare_dense(kernel, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, DENSE_THREADS, dual_smem_bytes(DUAL_TN, a.stages), s>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                maps[6], a);
  return cudaGetLastError();
}

template <int TN>
inline cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                               const DenseArgs& a, float* out, int grid,
                               cudaStream_t s) {
  static bool ready = false;
  cudaError_t err = prepare_dense(mlp_bwd_gemm_kernel<TN>, ready);
  if (err != cudaSuccess) return err;
  mlp_bwd_gemm_kernel<TN><<<grid, DENSE_THREADS,
                            dense_smem_bytes(TN, a.stages, a.K, false), s>>>(
      ma, mb, a, out);
  return cudaGetLastError();
}

inline cudaError_t launch_gemm_tn(int tn, const CUtensorMap& ma,
                                  const CUtensorMap& mb, const DenseArgs& a,
                                  float* out, int grid, cudaStream_t s) {
  switch (tn) {
    case 128: return launch_gemm<128>(ma, mb, a, out, grid, s);
    case 192: return launch_gemm<192>(ma, mb, a, out, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

inline cudaError_t launch_ln(const void* x, const void* stats,
                             const void* dxn, const void* gamma,
                             const void* gout, void* dx, void* part, int M,
                             int C, int rpb, int blocks, cudaStream_t s) {
  typedef void (*K)(const bf16*, const float2*, const float*, const bf16*,
                    const bf16*, bf16*, float*, int, int, int);
  const int ni = (C + 127) / 128;
  const K k = ni <= 1   ? mlp_bwd_ln_kernel<1>
              : ni <= 2 ? mlp_bwd_ln_kernel<2>
              : ni <= 3 ? mlp_bwd_ln_kernel<3>
                        : mlp_bwd_ln_kernel<6>;
  const int smem = ln_bwd_smem_bytes(C);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<blocks, LNB_THREADS, smem, s>>>(
      (const bf16*)x, (const float2*)stats, (const float*)dxn,
      (const bf16*)gamma, (const bf16*)gout, (bf16*)dx, (float*)part, M, C,
      rpb);
  return cudaGetLastError();
}

}  // namespace aicity

// Shared memory of a launch of the plan (ops/fused_dense.py:_mlp_bwd_plan):
// variant 0 the dual GEMM (tn, stages), 1 a K-major GEMM without LN (tn,
// stages), 2 the pre-pass (C).
extern "C" int aicity_ln_mlp_bwd_smem_bytes(int variant, int C, int H, int tn,
                                            int stages) {
  using namespace aicity;
  switch (variant) {
    case 0: return dual_smem_bytes(tn, stages);
    case 1: return dense_smem_bytes(tn, stages, 64, false);
    default: return prep_smem_bytes(C);
  }
}

// ptr[]: the inputs x [M, C], gamma, beta [C], w1 [H, C], b1 [H], w2
// [C, H], gout [M, C]; the outputs (bf16) dx [M, C], dw1 [H, C], db1 [H],
// dw2 [C, H], dgb [3][C] (dgamma, dbeta, db2); the scratch w1t (W1^T
// [C, H]), w2t (W2^T [H, C]), stats [ceil(M / 128) * 128][2] f32, xn
// [M, C], xnT and goutT [C][ld], hT and dhpT [H][ld], dhp [M, H] (bf16),
// dxn [M, C] f32, and the f32 partials db1 [2 * grid2][H], dgb
// [blocks4][3][C], dw1 [splits1][H][C], dw2 [splits2][C][H].
// plan[]: ld (M rounded up to 8), stages2, grid2 (the dual GEMM, tile 128),
// tn3, stages3, grid3 (dxn), blocks4, rows4 (the LN backward), then for dW1
// and dW2 each tn, stages, grid, splits, split_chunks (64-deep K chunks a
// split).
extern "C" int aicity_ln_mlp_bwd(const void* const* ptr, const int* plan,
                                 int M, int C, int H, float eps,
                                 void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || C % 8 || C > 768 || H % DUAL_TN)
    return (int)cudaErrorInvalidValue;
  const void *x = ptr[0], *gamma = ptr[1], *beta = ptr[2], *w1 = ptr[3],
             *b1 = ptr[4], *w2 = ptr[5], *gout = ptr[6];
  void *dx = (void*)ptr[7], *dw1 = (void*)ptr[8], *db1 = (void*)ptr[9],
       *dw2 = (void*)ptr[10], *dgb = (void*)ptr[11];
  void *w1t = (void*)ptr[12], *w2t = (void*)ptr[13], *stats = (void*)ptr[14],
       *xn = (void*)ptr[15], *xnT = (void*)ptr[16], *goutT = (void*)ptr[17],
       *hT = (void*)ptr[18], *dhpT = (void*)ptr[19], *dhp = (void*)ptr[20],
       *dxn = (void*)ptr[21];
  float *db1_part = (float*)ptr[22], *dgb_part = (float*)ptr[23],
        *dw1_part = (float*)ptr[24], *dw2_part = (float*)ptr[25];
  const int ld = plan[0], stages2 = plan[1], grid2 = plan[2], tn3 = plan[3],
            stages3 = plan[4], grid3 = plan[5], blocks4 = plan[6],
            rows4 = plan[7];
  const int* pw1 = plan + 8;  // tn, stages, grid, splits, split_chunks
  const int* pw2 = plan + 13;
  if (ld < M || ld % 8 || stages2 < 2 || stages2 > DENSE_MAX_STAGES ||
      (long)blocks4 * rows4 < M)
    return (int)cudaErrorInvalidValue;

  // descriptors: the dual GEMM's loads and stores, then dxn's, dW1's and
  // dW2's operands (K-major; columns past M load as zero)
  CUtensorMap dual[7], m_dhp, m_w1t, m_dhpt, m_xnt, m_dot, m_ht;
  int err = make_tmap(&dual[0], xn, M, C, C, DENSE_BM);
  if (!err) err = make_tmap(&dual[1], gout, M, C, C, DENSE_BM);
  if (!err) err = weight_tmap(&dual[2], w1, H, C, C, DUAL_TN);
  if (!err) err = make_tmap(&dual[3], w2t, H, C, C, DUAL_TN);
  if (!err) err = make_tmap(&dual[4], hT, H, M, ld, DUAL_TN);
  if (!err) err = make_tmap(&dual[5], dhpT, H, M, ld, DUAL_TN);
  if (!err) err = make_tmap(&dual[6], dhp, M, H, H, 64);
  if (!err) err = make_tmap(&m_dhp, dhp, M, H, H, DENSE_BM);
  if (!err) err = make_tmap(&m_w1t, w1t, C, H, H, tn3);
  if (!err) err = make_tmap(&m_dhpt, dhpT, H, M, ld, DENSE_BM);
  if (!err) err = make_tmap(&m_xnt, xnT, C, M, ld, pw1[0]);
  if (!err) err = make_tmap(&m_dot, goutT, C, M, ld, DENSE_BM);
  if (!err) err = make_tmap(&m_ht, hT, H, M, ld, pw2[0]);
  if (err) return err;

  mlp_bwd_transpose_kernel<<<dim3(((C + 31) / 32) * ((H + 31) / 32), 2),
                             256, 0, s>>>(
      (const bf16*)w1, (const bf16*)w2, (bf16*)w1t, (bf16*)w2t, C, H);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = launch_prep(x, gamma, beta, gout, stats, xn, xnT, goutT, M, C, ld,
                    eps, s);
  if (e == cudaSuccess) {
    const DualArgs a{(const bf16*)b1, db1_part, M, H, C, stages2};
    e = launch_dual(dual, a, grid2, s);
  }
  if (e == cudaSuccess) {  // dxn [M, C] = dhp W1t^T
    const DenseArgs a{nullptr, nullptr, nullptr, nullptr, M, C, H, stages3,
                      (C + tn3 - 1) / tn3, 1, 0};
    e = launch_gemm_tn(tn3, m_dhp, m_w1t, a, (float*)dxn, grid3, s);
  }
  if (e == cudaSuccess)
    e = launch_ln(x, stats, dxn, gamma, gout, dx, dgb_part, M, C, rows4,
                  blocks4, s);
  if (e == cudaSuccess) {  // dW1 [H, C] = dhp^T xn
    const DenseArgs a{nullptr, nullptr, nullptr, nullptr, H, C, M, pw1[1],
                      (C + pw1[0] - 1) / pw1[0], pw1[3], pw1[4]};
    e = launch_gemm_tn(pw1[0], m_dhpt, m_xnt, a, dw1_part, pw1[2], s);
  }
  if (e == cudaSuccess) {  // dW2 [C, H] = dOut^T h
    const DenseArgs a{nullptr, nullptr, nullptr, nullptr, C, H, M, pw2[1],
                      (H + pw2[0] - 1) / pw2[0], pw2[3], pw2[4]};
    e = launch_gemm_tn(pw2[0], m_dot, m_ht, a, dw2_part, pw2[2], s);
  }
  if (e == cudaSuccess)
    e = reduce_parts(dgb_part, (bf16*)dgb, blocks4, 3L * C, s);
  if (e == cudaSuccess)
    e = reduce_parts(db1_part, (bf16*)db1, 2 * grid2, (long)H, s);
  if (e == cudaSuccess)
    e = reduce_parts(dw1_part, (bf16*)dw1, pw1[3], (long)H * C, s);
  if (e == cudaSuccess)
    e = reduce_parts(dw2_part, (bf16*)dw2, pw2[3], (long)C * H, s);
  return (int)e;
}
