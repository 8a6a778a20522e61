// Grouped LayerNorm forward for Hopper.
//
// Replaces aicity_action_tpu/ops/pallas/layer_norm.py:_ln_fwd_kernel (reached
// through fused_layer_norm). On the main path it is the final norm of MViT
// ([B*1568, 768], groups 1, eps 1e-6). A row LayerNorm does ~8 flops per
// element against 4 bytes moved (bf16 in and out), so it is bound by device
// memory bandwidth. Design: one warp per (row, group) segment, f32 statistics
// in two passes (the second pass re-reads the segment from L1), one write of
// the normalized values; no shared memory, so many warps stay in flight to
// cover memory latency.
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

}  // namespace aicity

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
