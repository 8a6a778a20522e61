// Fused LayerNorm + qkv projection for Hopper: (q, k, v) = split(LN(x) W^T + b).
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_qkv_kernel (reached
// through fused_ln_qkv), MViT's norm1 + attn.qkv. At 448 it sees x [B*L, D]
// with D in {96, 192, 384, 768} and 3C in {288, 576, 1152, 2304}: 2*D*3C flops
// per row against 2*(D + 3C) bytes, i.e. 64-400 flops/byte -- below the
// H100's ~295 flops/byte ridge for the narrow blocks and above it for the
// wide ones, so both memory and the tensor cores matter.
//
// The Pallas kernel keeps the whole [D, 3C] weight resident in VMEM; at
// D=768 that is 3.5 MB and does not fit in shared memory. Design: one block
// owns a 128-row tile for ALL output columns. It loads the rows once,
// computes the row LayerNorm once (f32 statistics over the full D) and keeps
// the normalized bf16 rows in shared memory, then walks the output columns
// in 128-wide tiles (64 where 128 does not divide 3C, or at D=768, where
// the rows fill shared memory),
// streaming each weight tile through a two-stage shared-memory ring in
// 64-deep K chunks with cp.async, so the next chunk loads while this one
// multiplies (the weight stays L2-resident across blocks; each row tile
// re-reads it once). Products run on mma.sync m16n8k16 bf16 tiles with f32
// accumulation; 8 warps each own a 32 x 64 (or 32 x 32) sub-tile, its B
// fragments loaded two n8 tiles at a time by ldmatrix. The bias is added in
// f32 and q, k, v are written channel-major, [B, C, L] each: the NCDHW
// layout the depthwise pool convolutions read, so no transpose of the three
// full-size tensors goes through device memory.
#include "common.cuh"

namespace aicity {

constexpr int QKV_TM = 128, QKV_KC = 64, QKV_THREADS = 256;
constexpr int QKV_LDW = QKV_KC + 8;

// Output columns per weight tile: 128 (warp tiles 32x64) where they divide
// the 3C outputs evenly and the normalized rows leave room in shared memory
// (D <= 384), else 64 (a partial last tile wastes less).
inline int qkv_tn(int D, int C) {
  return D <= 384 && (3 * C) % 128 == 0 ? 128 : 64;
}

template <int TN>
__global__ void __launch_bounds__(QKV_THREADS)
    ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, bf16* __restrict__ q,
                  bf16* __restrict__ k, bf16* __restrict__ v, int M, int D,
                  int C, float eps, int tokens) {
  constexpr int NW = TN / 16;  // n8 tiles of a warp's 32 x TN/2 sub-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  const int ldx = D + 8;
  bf16* ws = xs + QKV_TM * ldx;  // 2 stages of [TN][LDW]

  const int row0 = blockIdx.x * QKV_TM;
  const int N = 3 * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (D + QKV_KC - 1) / QKV_KC;
  const int ntile = ((N + TN - 1) / TN) * nk;  // (n0, k0) pairs

  // weight tile s (n-major, k-minor) into ring stage s & 1
  auto fetch = [&](int s) {
    const int n0 = (s / nk) * TN, k0 = (s % nk) * QKV_KC;
    load_tile_async(ws + (s & 1) * TN * QKV_LDW, QKV_LDW, w, D, n0, N, k0, TN,
                    min(QKV_KC, D - k0));
  };
  fetch(0);
  cp_async_commit();

  load_tile(xs, ldx, x, D, row0, M, 0, QKV_TM, D);
  __syncthreads();
  norm_rows(xs, ldx, QKV_TM, D, gamma, beta, eps);

  float acc[2][NW][4];
  for (int s = 0; s < ntile; ++s) {
    const int n0 = (s / nk) * TN, k0 = (s % nk) * QKV_KC;
    const int kc = min(QKV_KC, D - k0);
    if (k0 == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NW; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    if (s + 1 < ntile) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile s has landed (and, at s == 0, xs is normed)
    const bf16* wt = ws + (s & 1) * TN * QKV_LDW;
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a_frag(a[mi], xs, ldx, wm * 32 + mi * 16, k0 + kk, lane);
#pragma unroll
      for (int np = 0; np < NW / 2; ++np) {
        uint32_t b[4];
        load_b_frag_x2(b, wt, QKV_LDW, wn * (TN / 2) + np * 16, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * np], a[mi], b);
          mma_16816(acc[mi][2 * np + 1], a[mi], b + 2);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on

    if (k0 + kc == D) {  // last K chunk of this column tile: epilogue
#pragma unroll
      for (int ni = 0; ni < NW; ++ni) {
        const int col = n0 + wn * (TN / 2) + ni * 8 + 2 * t;
        if (col >= N) continue;
        const int which = col / C, cc = col - which * C;
        bf16* out = which == 0 ? q : (which == 1 ? k : v);
        const float b0 = bias ? __bfloat162float(bias[col]) : 0.f;
        const float b1 = bias ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g and g + 8
            const int r = row0 + wm * 32 + mi * 16 + g + 8 * h;
            if (r >= M) continue;
            const int b = r / tokens, l = r - b * tokens;
            bf16* p = out + ((size_t)b * C + cc) * tokens + l;
            p[0] = __float2bfloat16(acc[mi][ni][2 * h] + b0);
            p[tokens] = __float2bfloat16(acc[mi][ni][2 * h + 1] + b1);
          }
        }
      }
    }
  }
}

}  // namespace aicity

extern "C" int aicity_ln_qkv_smem_bytes(int D, int C) {
  using namespace aicity;
  return (QKV_TM * (D + 8) + 2 * qkv_tn(D, C) * QKV_LDW) * (int)sizeof(bf16);
}

// x is [M, D] token rows of clips of `tokens` tokens; q, k, v are each
// [M / tokens, C, tokens].
extern "C" int aicity_ln_qkv(const void* x, const void* gamma, const void* beta,
                             const void* w, const void* bias, void* q, void* k,
                             void* v, int M, int D, int C, float eps,
                             int tokens, void* stream) {
  using namespace aicity;
  if (tokens <= 0 || M % tokens) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)aicity_ln_qkv_smem_bytes(D, C);
  auto kernel = qkv_tn(D, C) == 128 ? ln_qkv_kernel<128> : ln_qkv_kernel<64>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + QKV_TM - 1) / QKV_TM;
  if (blocks > 0)
    kernel<<<blocks, QKV_THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (const bf16*)w,
        (const bf16*)bias, (bf16*)q, (bf16*)k, (bf16*)v, M, D, C, eps,
        tokens);
  return (int)cudaGetLastError();
}
