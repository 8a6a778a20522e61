// Backward of the fused LayerNorm + MLP for Hopper:
// out = fc2(gelu(fc1(LN(x))))  ->  dx, dW1, db1, dW2, db2, dgamma, dbeta.
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_mlp_bwd_kernel
// (:414) and _ln_mlp_bwd_hsplit_kernel (:533) (reached through
// fused_ln_mlp's custom VJP, :694), which every MViT block runs in
// training: x [M, C] with M from 401408 (block 0, batch 4) down to 6272,
// C in {96, 192, 384, 768}, H = 4C (MViT-v2-L: C in {144, 288, 576,
// 1152}; the JAX package leaves C 1152 to XLA, the port runs this).
// 10*M*C*H flops against 2*M*3C bytes of activations and the weights: the
// tensor cores bound it, and at the narrow widths the hidden activations
// this design stores.
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
//  2. mlp_bwd_dual_kernel: per (128-row tile, 128-wide hidden tile; 64-wide
//     where 128 does not divide H, MViT-v2-L's H = 576), two
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
// (mlp_bwd_reduce_kernel, one launch; no atomics), rounded to bf16 at the
// end, as the Pallas wrapper rounds the gradients to the weights' compute
// type. Rounding points are the Pallas kernel's: xn, h and dhp bf16; h_pre,
// dh, dh_pre, dxn and every sum f32. GELU is the exact erff and its
// derivative 0.5 (1 + erf(x / sqrt2)) + x phi(x) (the Pallas kernel's
// polynomial exists only because Mosaic has no erf).
#include "ln_bwd.cuh"

namespace aicity {

// 0.5 (1 + erf(x / sqrt 2)): GELU is x times it, its derivative it plus
// x phi(x)
__device__ __forceinline__ float gelu_cdf(float x) {
  return 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// ------------------------------------------------- launch 1: the pre-pass

__host__ __device__ inline int prep_smem_bytes(int C) {
  return PREP_ROWS * (C + 8) * 2;
}

// PREP_ROWS rows a block (ln_bwd.cuh:ln_prep_rows): the statistics and xn,
// then xn^T and dOut^T.
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
  const int q = threadIdx.x & 3, nv = C / 8;
  const int rl = threadIdx.x >> 2;
  const int row0 = blockIdx.x * PREP_ROWS, r = row0 + rl;
  ln_prep_rows<VPL>(x, gamma, beta, stats, tile, xn, row0, M, C, eps);
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
  // a consumer thread per column of the tile (TN 128), or of its first TN
  // threads (TN 64; the guards below fold away at 128)
  static_assert(TN == 128 || TN == 64, "the dual GEMM's hidden tiles");
  constexpr bool HALF = TN < 128;
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
    const float b1v = !HALF || ctid < TN
                          ? __bfloat162float(p.b1[n0 + ctid])  // under the loop
                          : 0.f;
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
    if (!HALF || ctid < TN) bias[ctid] = b1v;
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
    if (!HALF || ctid < TN)
      mydb[n0 + ctid] += red[ctid] + red[TN + ctid] + red[2 * TN + ctid] +
                         red[3 * TN + ctid];

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

// ln_bwd.cuh:ln_bwd_rows with db2, the column sums of dOut, as its third
template <int NI>
__global__ void __launch_bounds__(LNB_THREADS)
    mlp_bwd_ln_kernel(const bf16* __restrict__ x,
                      const float2* __restrict__ stats,
                      const float* __restrict__ dxn,
                      const bf16* __restrict__ gamma,
                      const bf16* __restrict__ gout, bf16* __restrict__ dx,
                      float* __restrict__ part, int M, int C, int rpb) {
  extern __shared__ __align__(16) float ln_sums[];
  ln_bwd_rows<NI, 3>(x, stats, dxn, gamma, gout, dx, part, M, C, rpb,
                     ln_sums);
}

// ------------------------------- the weight transposes, the partial sums

__global__ void __launch_bounds__(256)
    mlp_bwd_transpose_kernel(const Transpose a, const Transpose b) {
  transpose_tile(blockIdx.y == 0 ? a : b, blockIdx.x);
}

__global__ void __launch_bounds__(256)
    mlp_bwd_reduce_kernel(const PartialSums p) {
  sum_partials(p);
}

// ------------------------------------------------------------- host side

// W2^T and W1^T in one launch (blockIdx.y 0 and 1).
inline cudaError_t launch_transposes(const Transpose& a, const Transpose& b,
                                     cudaStream_t s) {
  mlp_bwd_transpose_kernel<<<
      dim3(max(transpose_tiles(a), transpose_tiles(b)), 2), 256, 0, s>>>(a,
                                                                          b);
  return cudaGetLastError();
}

inline cudaError_t launch_prep(const void* x, const void* gamma,
                               const void* beta, const void* gout,
                               void* stats, void* xn, void* xnT, void* goutT,
                               int M, int C, int ld, float eps,
                               cudaStream_t s) {
  const PrepKernel k = prep_kernel_for(
      [](int vpl) -> PrepKernel {
        switch (vpl) {
          case 3: return mlp_bwd_prep_kernel<3>;
          case 6: return mlp_bwd_prep_kernel<6>;
          case 12: return mlp_bwd_prep_kernel<12>;
          case 24: return mlp_bwd_prep_kernel<24>;
          default: return mlp_bwd_prep_kernel<36>;
        }
      },
      C);
  const int smem = prep_smem_bytes(C);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<(M + PREP_ROWS - 1) / PREP_ROWS, PREP_THREADS, smem, s>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta,
      (const bf16*)gout, (float2*)stats, (bf16*)xn, (bf16*)xnT, (bf16*)goutT,
      M, C, ld, eps);
  return cudaGetLastError();
}

// the dual GEMM's hidden tile: 128, or 64 where 128 does not divide H
constexpr int DUAL_TN = 128;

__host__ __device__ inline int dual_tn(int H) {
  return H % DUAL_TN ? DUAL_TN / 2 : DUAL_TN;
}

template <int TN>
inline cudaError_t launch_dual(const CUtensorMap* maps, const DualArgs& a,
                               int grid, cudaStream_t s) {
  auto kernel = mlp_bwd_dual_kernel<TN>;
  static bool ready = false;
  cudaError_t err = prepare_dense(kernel, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, DENSE_THREADS, dual_smem_bytes(TN, a.stages), s>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
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
  return launch_ln_bwd<3>(
      [](int ni) -> LnBwdKernel {
        switch (ni) {
          case 1: return mlp_bwd_ln_kernel<1>;
          case 2: return mlp_bwd_ln_kernel<2>;
          case 3: return mlp_bwd_ln_kernel<3>;
          case 6: return mlp_bwd_ln_kernel<6>;
          default: return mlp_bwd_ln_kernel<9>;
        }
      },
      x, stats, dxn, gamma, gout, dx, part, M, C, rpb, blocks, s);
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
// plan[]: ld (M rounded up to 8), stages2, grid2 (the dual GEMM, hidden
// tile dual_tn(H)),
// tn3, stages3, grid3 (dxn), blocks4, rows4 (the LN backward), then for dW1
// and dW2 each tn, stages, grid, splits, split_chunks (64-deep K chunks a
// split).
extern "C" int aicity_ln_mlp_bwd(const void* const* ptr, const int* plan,
                                 int M, int C, int H, float eps,
                                 void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || C % 8 || C > DENSE_MAX_LN_K || H % (DUAL_TN / 2))
    return (int)cudaErrorInvalidValue;
  const int tn1 = dual_tn(H);
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
  if (!err) err = weight_tmap(&dual[2], w1, H, C, C, tn1);
  if (!err) err = make_tmap(&dual[3], w2t, H, C, C, tn1);
  if (!err) err = make_tmap(&dual[4], hT, H, M, ld, tn1);
  if (!err) err = make_tmap(&dual[5], dhpT, H, M, ld, tn1);
  if (!err) err = make_tmap(&dual[6], dhp, M, H, H, 64);
  if (!err) err = make_tmap(&m_dhp, dhp, M, H, H, DENSE_BM);
  if (!err) err = make_tmap(&m_w1t, w1t, C, H, H, tn3);
  if (!err) err = make_tmap(&m_dhpt, dhpT, H, M, ld, DENSE_BM);
  if (!err) err = make_tmap(&m_xnt, xnT, C, M, ld, pw1[0]);
  if (!err) err = make_tmap(&m_dot, goutT, C, M, ld, DENSE_BM);
  if (!err) err = make_tmap(&m_ht, hT, H, M, ld, pw2[0]);
  if (err) return err;

  cudaError_t e =
      launch_transposes(Transpose{(const bf16*)w2, (bf16*)w2t, C, H},
                        Transpose{(const bf16*)w1, (bf16*)w1t, H, C}, s);
  if (e == cudaSuccess)
    e = launch_prep(x, gamma, beta, gout, stats, xn, xnT, goutT, M, C, ld,
                    eps, s);
  if (e == cudaSuccess) {
    const DualArgs a{(const bf16*)b1, db1_part, M, H, C, stages2};
    e = tn1 == DUAL_TN ? launch_dual<DUAL_TN>(dual, a, grid2, s)
                       : launch_dual<DUAL_TN / 2>(dual, a, grid2, s);
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
  if (e != cudaSuccess) return (int)e;
  PartialSums sums;
  int jobs = 0;
  add_sum(sums, jobs, dgb_part, (bf16*)dgb, blocks4, 3L * C);
  add_sum(sums, jobs, db1_part, (bf16*)db1, 2 * grid2, H);
  add_sum(sums, jobs, dw1_part, (bf16*)dw1, pw1[3], (long)H * C);
  add_sum(sums, jobs, dw2_part, (bf16*)dw2, pw2[3], (long)C * H);
  mlp_bwd_reduce_kernel<<<sums.start[SUM_JOBS], 256, 0, s>>>(sums);
  return (int)cudaGetLastError();
}
