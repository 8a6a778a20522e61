// Grouped LayerNorm for Hopper: the forward and its backward.
//
// Replaces aicity_action_tpu/ops/pallas/layer_norm.py:_ln_fwd_kernel (reached
// through fused_layer_norm). On the main path it is the final norm of MViT
// ([B*1568, 768], groups 1, eps 1e-6). A row LayerNorm does ~8 flops per
// element against 4 bytes moved (bf16 in and out), so it is bound by device
// memory bandwidth. Design: one warp per (row, group) segment, f32 statistics
// in two passes (the second pass re-reads the segment from L1), one write of
// the normalized values; no shared memory, so many warps stay in flight to
// cover memory latency.
//
// The backward replaces layer_norm.py:_ln_bwd_kernel (reached through
// fused_layer_norm's custom VJP). In training it runs for the final norm and
// for the three pooled q/k/v norms of every block (per head, over d = 96; the
// port feeds them as [B*h*L, 96] rows, so groups = 1 there). It reads x and
// dy and writes dx (6 bytes per element against ~20 flops): bound by device
// memory. The Pallas kernel sums dgamma / dbeta in one block that stays
// resident across its sequential grid; GPU blocks run in no order, so here
// each warp walks (row, group) segments grid-stride, keeps its lanes'
// dgamma / dbeta sums in registers, the block adds its warps' sums in shared
// memory and writes one f32 partial per block, and a second pass
// (reduce_splits) sums the partials in a fixed order: no atomics, the same
// bits every run.
#include "common.cuh"

namespace aicity {

__global__ void __launch_bounds__(256)
    layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                      const bf16* __restrict__ beta, bf16* __restrict__ y,
                      long segments, int dg, float eps) {
  const long seg = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (seg >= segments) return;
  const int lane = threadIdx.x & 31;
  // a (row, group) segment is contiguous: row * C + group * dg == seg * dg
  const bf16* xs = x + seg * dg;
  bf16* ys = y + seg * dg;
  float s = 0.f;
  for (int c = lane; c < dg; c += 32) s += __bfloat162float(xs[c]);
  const float mean = warp_sum(s) / dg;
  float q = 0.f;
  for (int c = lane; c < dg; c += 32) {
    const float d = __bfloat162float(xs[c]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / dg + eps);
  for (int c = lane; c < dg; c += 32) {
    const float v = (__bfloat162float(xs[c]) - mean) * rstd *
                        __bfloat162float(gamma[c]) +
                    __bfloat162float(beta[c]);
    ys[c] = __float2bfloat16(v);
  }
}

// One warp per (row, group) segment of dg = 32 * NPL channels, grid-stride;
// lane l owns channels l + 32 j. part is [gridDim.x][2][dg]: the block's
// dgamma then dbeta sums.
template <int NPL>
__global__ void __launch_bounds__(256)
    layer_norm_bwd_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ gamma,
                          const bf16* __restrict__ dy, bf16* __restrict__ dx,
                          float* __restrict__ part, long segments, float eps) {
  constexpr int DG = 32 * NPL;
  extern __shared__ float red[];  // [warps][2][DG]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float gam[NPL], accg[NPL], accb[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    gam[j] = __bfloat162float(gamma[lane + 32 * j]);
    accg[j] = accb[j] = 0.f;
  }
  for (long seg = (long)blockIdx.x * nwarps + warp; seg < segments;
       seg += (long)gridDim.x * nwarps) {
    const bf16* xs = x + seg * DG;
    const bf16* dys = dy + seg * DG;
    float xv[NPL], dv[NPL];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      xv[j] = __bfloat162float(xs[lane + 32 * j]);
      dv[j] = __bfloat162float(dys[lane + 32 * j]);
      s += xv[j];
    }
    const float mean = warp_sum(s) / DG;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      xv[j] -= mean;
      q += xv[j] * xv[j];
    }
    const float rstd = rsqrtf(warp_sum(q) / DG + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      xv[j] *= rstd;  // xhat
      const float e = dv[j] * gam[j];
      s1 += e;
      s2 += e * xv[j];
      accg[j] += dv[j] * xv[j];
      accb[j] += dv[j];
    }
    const float m1 = warp_sum(s1) / DG, m2 = warp_sum(s2) / DG;
    bf16* dxs = dx + seg * DG;
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      dxs[lane + 32 * j] = __float2bfloat16(
          (dv[j] * gam[j] - m1 - xv[j] * m2) * rstd);
  }
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    red[(warp * 2) * DG + lane + 32 * j] = accg[j];
    red[(warp * 2 + 1) * DG + lane + 32 * j] = accb[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * DG; c += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < nwarps; ++w) v += red[w * 2 * DG + c];
    part[(size_t)blockIdx.x * 2 * DG + c] = v;
  }
}

template <int NPL>
int launch_ln_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                  void* dgb, void* part, long segments, int nblocks, float eps,
                  cudaStream_t stream) {
  constexpr int DG = 32 * NPL;
  const size_t smem = 8 * 2 * DG * sizeof(float);
  cudaError_t err = set_smem(layer_norm_bwd_kernel<NPL>, smem);
  if (err != cudaSuccess) return (int)err;
  layer_norm_bwd_kernel<NPL><<<nblocks, 256, smem, stream>>>(
      (const bf16*)x, (const bf16*)gamma, (const bf16*)dy, (bf16*)dx,
      (float*)part, segments, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_splits((const float*)part, (bf16*)dgb, nblocks, 2 * DG,
                            stream);
}

}  // namespace aicity

// Blocks of the backward (the partials buffer holds [blocks][2][dg] f32).
extern "C" int aicity_layer_norm_bwd_blocks(long rows, int groups) {
  const long segs = rows * groups;
  const long b = (segs + 7) / 8;
  return (int)(b < 1024 ? (b > 0 ? b : 1) : 1024);
}

// dx [rows, cols]; dgb [2, cols / groups] bf16 (dgamma, then dbeta); part
// [aicity_layer_norm_bwd_blocks(rows, groups), 2, cols / groups] f32.
extern "C" int aicity_layer_norm_bwd(const void* x, const void* gamma,
                                     const void* dy, void* dx, void* dgb,
                                     void* part, long rows, int cols,
                                     int groups, float eps, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  const long segments = rows * groups;
  const int nb = aicity_layer_norm_bwd_blocks(rows, groups);
  const int dg = cols / groups;
  if (groups < 1 || cols % groups) return (int)cudaErrorInvalidValue;
  switch (dg) {
    case 32: return launch_ln_bwd<1>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 64: return launch_ln_bwd<2>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 96: return launch_ln_bwd<3>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 128: return launch_ln_bwd<4>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 192: return launch_ln_bwd<6>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 256: return launch_ln_bwd<8>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 384: return launch_ln_bwd<12>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 512: return launch_ln_bwd<16>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    case 768: return launch_ln_bwd<24>(x, gamma, dy, dx, dgb, part, segments, nb, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int aicity_layer_norm(const void* x, const void* gamma,
                                 const void* beta, void* y, long rows, int cols,
                                 int groups, float eps, void* stream) {
  using namespace aicity;
  const long segments = rows * groups;
  const int warps = 8;
  const long blocks = (segments + warps - 1) / warps;
  if (blocks > 0)
    layer_norm_kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (bf16*)y,
        segments, cols / groups, eps);
  return (int)cudaGetLastError();
}
