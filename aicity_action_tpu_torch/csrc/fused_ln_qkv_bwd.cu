// Backward of the fused LayerNorm + qkv projection for Hopper:
// (q, k, v) = split(LN(x) W^T + b)  ->  dx, dW, db, dgamma, dbeta.
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_qkv_bwd_kernel
// (:175, reached through fused_ln_qkv's custom VJP, :285), which every MViT
// block runs in training. At 448 and batch 4 it sees x [M, D] with M from
// 401408 (blocks 0-1) down to 6272, D in {96, 192, 384, 768} and 3C in
// {288, ..., 2304}: dx = dLN(G W) and dW = G^T LN(x) are 4*M*D*3C flops
// against 2*M*(2D + 3C) bytes, 64-400 flops per byte, so both the tensor
// cores and memory matter.
//
// The Pallas kernel walks row tiles in order and adds dW, db, dgamma and
// dbeta into blocks that stay resident across its sequential grid. GPU
// blocks run in no order, so the work is split in two kernels, each with
// per-block f32 partials summed by a second pass (reduce_splits, fixed
// order, no atomics):
// - qkv_bwd_dx_kernel owns a row tile (TM rows x all D, the dLN(x)
//   accumulator in registers, TM * D <= 24576): it streams the incoming
//   gradients in 32-column chunks with the matching 32 rows of W through a
//   two-stage cp.async ring, accumulates dLN(x) = G W on mma.sync tiles, then
//   runs the LN backward (ln_bwd.cuh) from the row statistics and writes dx,
//   the tile's dgamma / dbeta partials and the row statistics, which the
//   second kernel reuses.
// - qkv_bwd_dw_kernel owns a 96 x 96 tile of dW and a range of rows: it
//   rebuilds bf16(LN(x)) for its 96 columns from the statistics, and sums
//   G^T LN(x) over its rows (and db from the tile's first column blocks).
//   Blocks 0-1 have only 3-6 such tiles, so the rows are split to fill the
//   card; each split writes an f32 partial.
// Layout: the forward wrote q, k, v channel-major, [B, C, L] each, for the
// pool convolutions, so their gradients arrive that way: both kernels read
// G as it lies, 8 tokens (16 bytes) at a time where L % 8 == 0, else (the
// odd 1 + T*H*W of a cls-token model) one element at a time.
// bf16 products, f32 sums; dW, db, dgamma and dbeta are rounded to bf16 at
// the end as the Pallas wrapper rounds them to the weights' compute type.
#include "common.cuh"
#include "ln_bwd.cuh"

namespace aicity {

constexpr int QB_THREADS = 256, QB_KC = 32;
constexpr int QW_T = 96, QW_TM = 32, QW_THREADS = 128;

// Source of 16 bytes of gradient rows [r, r + 8) of channel column n (of
// the 3C) in the channel-major q / k / v gradients.
__device__ __forceinline__ const bf16* grad_src(const bf16* dq, const bf16* dk,
                                                const bf16* dv, int n, int r,
                                                int C, int tokens) {
  const int which = n / C, cc = n - which * C;
  const bf16* base = which == 0 ? dq : (which == 1 ? dk : dv);
  const int b = r / tokens, l = r - b * tokens;
  return base + ((size_t)b * C + cc) * tokens + l;
}

// Gradient columns [n0, n0 + nc) x rows [row0, row0 + nrows) into smem as
// [n][row] (rows contiguous), rows past M zero-filled. Clips of a multiple
// of 8 tokens are read 8 tokens (16 bytes) at a time with cp.async; other
// token counts (a cls token's 1 + T*H*W) element by element, since their
// channel rows are not 16-byte aligned and 8 rows may span two clips.
__device__ __forceinline__ void load_grad_tile(bf16* s, int lds, const bf16* dq,
                                               const bf16* dk, const bf16* dv,
                                               int n0, int nc, int row0,
                                               int nrows, int M, int C,
                                               int tokens) {
  if (tokens % 8 == 0) {
    const int vpr = nrows / 8;
    for (int i = threadIdx.x; i < nc * vpr; i += blockDim.x) {
      const int n = i / vpr, r = (i - n * vpr) * 8;
      const bool ok = row0 + r < M;
      cp_async16(s + n * lds + r,
                 grad_src(dq, dk, dv, n0 + n, ok ? row0 + r : 0, C, tokens),
                 ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < nc * nrows; i += blockDim.x) {
    const int n = i / nrows, r = i - n * nrows;
    s[n * lds + r] = row0 + r < M
                         ? *grad_src(dq, dk, dv, n0 + n, row0 + r, C, tokens)
                         : __float2bfloat16(0.f);
  }
}

template <int D, int TM, int WGM>
__global__ void __launch_bounds__(QB_THREADS)
    qkv_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ w, const bf16* __restrict__ dq,
                      const bf16* __restrict__ dk, const bf16* __restrict__ dv,
                      bf16* __restrict__ dx, float* __restrict__ part,
                      float* __restrict__ g_mean, float* __restrict__ g_rstd,
                      int M, int C, float eps, int tokens) {
  constexpr int LDG = TM + 8, LDW = D + 8;
  constexpr int G_ELEMS = QB_KC * LDG, W_ELEMS = QB_KC * LDW;
  constexpr int NW = (D / 8) / (8 / WGM);  // n8 tiles of a warp
  static_assert(TM / 16 == WGM && NW % 2 == 0, "warp grid");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // 2 x (G chunk, W chunk)
  float* s_mean = reinterpret_cast<float*>(ring + 2 * (G_ELEMS + W_ELEMS));
  float* s_rstd = s_mean + TM;
  float* s_m1 = s_rstd + TM;
  float* s_m2 = s_m1 + TM;
  float* s_dg = s_m2 + TM;
  float* s_db = s_dg + D;

  const int row0 = blockIdx.x * TM;
  const int N = 3 * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WGM, wn = warp / WGM;
  const int nchunks = N / QB_KC;

  auto fetch = [&](int i) {
    bf16* gs = ring + (i & 1) * (G_ELEMS + W_ELEMS);
    load_grad_tile(gs, LDG, dq, dk, dv, i * QB_KC, QB_KC, row0, TM, M, C,
                   tokens);
    load_tile_async(gs + G_ELEMS, LDW, w, D, i * QB_KC, N, 0, QB_KC, D);
  };
  fetch(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < 2 * TM + 2 * D; i += blockDim.x)
    s_m1[i] = 0.f;  // s_m1, s_m2, s_dg, s_db
  row_stats(x, row0, M, D, TM, eps, s_mean, s_rstd, g_mean, g_rstd);

  float acc[1][NW][4];
#pragma unroll
  for (int ni = 0; ni < NW; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][ni][e] = 0.f;

  for (int i = 0; i < nchunks; ++i) {
    if (i + 1 < nchunks) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* gs = ring + (i & 1) * (G_ELEMS + W_ELEMS);
    const bf16* ws = gs + G_ELEMS;
#pragma unroll
    for (int kk = 0; kk < QB_KC; kk += 16) {
      uint32_t a[4];
      load_a_frag_trans(a, gs, LDG, wm * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < NW / 2; ++np) {
        uint32_t b[4];
        load_b_frag_trans_x2(b, ws, LDW, kk, (wn * NW + 2 * np) * 8, lane);
        mma_16816(acc[0][2 * np], a, b);
        mma_16816(acc[0][2 * np + 1], a, b + 2);
      }
    }
    __syncthreads();  // this stage is refilled two chunks on
  }

  ln_bwd_epilogue<1, NW>(acc, wm * 16, wn * NW * 8, row0, M, D, x, gamma,
                         s_mean, s_rstd, s_m1, s_m2, s_dg, s_db, dx);
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x)
    part[(size_t)blockIdx.x * 2 * D + c] = s_dg[c];  // s_dg then s_db
}

// One 96 x 96 tile (n0, d0) of dW [3C][D] over rows [split * rps, ...):
// 4 warps in 2 x 2, each 48 x 48; 32-row steps, double buffered.
__global__ void __launch_bounds__(QW_THREADS)
    qkv_bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ beta,
                      const float* __restrict__ g_mean,
                      const float* __restrict__ g_rstd,
                      const bf16* __restrict__ dq, const bf16* __restrict__ dk,
                      const bf16* __restrict__ dv, float* __restrict__ dw_part,
                      float* __restrict__ db_part, int M, int D, int C,
                      int tokens, int rps) {
  constexpr int LDG = QW_TM + 8, LDX = QW_T + 8;
  constexpr int G_ELEMS = QW_T * LDG, X_ELEMS = QW_TM * LDX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // 2 x (G^T tile, x tile)

  const int n0 = blockIdx.x * QW_T, d0 = blockIdx.y * QW_T;
  const int split = blockIdx.z;
  const int N = 3 * C;
  const int ms = split * rps, me = min(M, ms + rps);
  const int nsteps = (me - ms + QW_TM - 1) / QW_TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const bool do_db = blockIdx.y == 0;

  auto fetch = [&](int i) {
    bf16* gs = ring + (i & 1) * (G_ELEMS + X_ELEMS);
    const int m0 = ms + i * QW_TM;
    load_grad_tile(gs, LDG, dq, dk, dv, n0, QW_T, m0, QW_TM, me, C, tokens);
    load_tile_async(gs + G_ELEMS, LDX, x, D, m0, me, d0, QW_TM, QW_T);
  };
  if (nsteps > 0) fetch(0);
  cp_async_commit();

  float acc[3][6][4];
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int ni = 0; ni < 6; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float dbacc = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    bf16* gs = ring + (i & 1) * (G_ELEMS + X_ELEMS);
    bf16* xs = gs + G_ELEMS;
    const int m0 = ms + i * QW_TM;
    // x -> bf16(LN(x)) for the tile's columns, from the row statistics
    for (int e = threadIdx.x; e < QW_TM * QW_T; e += blockDim.x) {
      const int r = e / QW_T, c = e - r * QW_T;
      const int gr = m0 + r;
      float y = 0.f;
      if (gr < me)
        y = (__bfloat162float(xs[r * LDX + c]) - g_mean[gr]) * g_rstd[gr] *
                __bfloat162float(gamma[d0 + c]) +
            __bfloat162float(beta[d0 + c]);
      xs[r * LDX + c] = __float2bfloat16(y);
    }
    if (do_db && threadIdx.x < QW_T)
      for (int r = 0; r < QW_TM; ++r)
        dbacc += __bfloat162float(gs[threadIdx.x * LDG + r]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QW_TM; kk += 16) {
      uint32_t a[3][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
        load_a_frag(a[mi], gs, LDG, wm * 48 + mi * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        uint32_t b[4];
        load_b_frag_trans_x2(b, xs, LDX, kk, wn * 48 + np * 16, lane);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
          mma_16816(acc[mi][2 * np], a[mi], b);
          mma_16816(acc[mi][2 * np + 1], a[mi], b + 2);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  float* out = dw_part + (size_t)split * N * D;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int ni = 0; ni < 6; ++ni) {
      const int r = n0 + wm * 48 + mi * 16 + g;
      const int c = d0 + wn * 48 + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (size_t)r * D + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * D + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  if (do_db && threadIdx.x < QW_T)
    db_part[(size_t)split * N + n0 + threadIdx.x] = dbacc;
}

template <int D, int TM, int WGM>
int launch_qkv_bwd_dx(const void* x, const void* gamma, const void* w,
                      const void* dq, const void* dk, const void* dv,
                      void* dx, void* part, void* mean, void* rstd, int M,
                      int C, float eps, int tokens, cudaStream_t stream) {
  auto kernel = qkv_bwd_dx_kernel<D, TM, WGM>;
  const size_t smem =
      (size_t)2 * (QB_KC * (TM + 8) + QB_KC * (D + 8)) * sizeof(bf16) +
      (4 * TM + 2 * D) * sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(M + TM - 1) / TM, QB_THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)w, (const bf16*)dq,
      (const bf16*)dk, (const bf16*)dv, (bf16*)dx, (float*)part,
      (float*)mean, (float*)rstd, M, C, eps, tokens);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// Row tile of the dx kernel for width D (0 where D has no configuration).
extern "C" int aicity_ln_qkv_bwd_rows(int D) {
  switch (D) {
    case 96: case 192: return 128;
    case 384: return 64;
    case 768: return 32;
    default: return 0;
  }
}

// x [M, D]; w [3C, D]; dq, dk, dv [M / tokens, C, tokens] (the forward's
// channel-major layout). Outputs: dx [M, D] bf16; dw [3C, D], db [3C],
// dgb [2, D] (dgamma, dbeta) bf16. Scratch (f32): part
// [ceil(M / rows), 2, D], stats [2, M], dw_part [nsplit, 3C, D], db_part
// [nsplit, 3C], nsplit = ceil(M / rps), rps a multiple of 32.
extern "C" int aicity_ln_qkv_bwd(const void* x, const void* gamma,
                                 const void* beta, const void* w,
                                 const void* dq, const void* dk,
                                 const void* dv, void* dx, void* dw, void* db,
                                 void* dgb, void* part, void* stats,
                                 void* dw_part, void* db_part, int M, int D,
                                 int C, float eps, int tokens, int rps,
                                 void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = aicity_ln_qkv_bwd_rows(D);
  if (!rows || C % QW_T || tokens <= 0 || M % tokens || rps <= 0 ||
      rps % 32)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  float* mean = (float*)stats;
  float* rstd = mean + M;
  int err;
  switch (D) {
    case 96:
      err = launch_qkv_bwd_dx<96, 128, 8>(x, gamma, w, dq, dk, dv, dx, part,
                                          mean, rstd, M, C, eps, tokens, s);
      break;
    case 192:
      err = launch_qkv_bwd_dx<192, 128, 8>(x, gamma, w, dq, dk, dv, dx, part,
                                           mean, rstd, M, C, eps, tokens, s);
      break;
    case 384:
      err = launch_qkv_bwd_dx<384, 64, 4>(x, gamma, w, dq, dk, dv, dx, part,
                                          mean, rstd, M, C, eps, tokens, s);
      break;
    default:
      err = launch_qkv_bwd_dx<768, 32, 2>(x, gamma, w, dq, dk, dv, dx, part,
                                          mean, rstd, M, C, eps, tokens, s);
  }
  if (err) return err;
  const int nblocks = (M + rows - 1) / rows;
  cudaError_t e = reduce_splits((const float*)part, (bf16*)dgb, nblocks,
                                2L * D, s);
  if (e != cudaSuccess) return (int)e;
  const int nsplit = (M + rps - 1) / rps;
  const size_t smem = (size_t)2 *
                      (QW_T * (QW_TM + 8) + QW_TM * (QW_T + 8)) * sizeof(bf16);
  e = set_smem(qkv_bwd_dw_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  qkv_bwd_dw_kernel<<<dim3(3 * C / QW_T, D / QW_T, nsplit), QW_THREADS, smem,
                      s>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, mean, rstd,
      (const bf16*)dq, (const bf16*)dk, (const bf16*)dv, (float*)dw_part,
      (float*)db_part, M, D, C, tokens, rps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = reduce_splits((const float*)dw_part, (bf16*)dw, nsplit, 3L * C * D, s);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_splits((const float*)db_part, (bf16*)db, nsplit, 3L * C,
                            s);
}
