// Flash attention over head-major token rows for Hopper, forward (with an
// optional f32 logsumexp per query row) and backward:
//   out = softmax(bf16(q * s) . k^T) . v,  lse = logsumexp of the logits
//
// Replaces aicity_action_tpu/ops/pallas/flash_attention.py:
// - _flash_kernel (flash_attention, :61) and _flash_fwd_lse_kernel (:261):
//   flash_fwd_kernel, one kernel whose lse store is skipped when no lse
//   buffer is given;
// - _flash_bwd (:550), which picks one of _flash_dqkv_kernel (:416),
//   _flash_dqkv_chunked_kernel (:459) or _flash_dq_kernel (:340) +
//   _flash_dkv_kernel (:379): here ONE design for every shape, the split
//   one: flash_bwd_prep_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel
//   (flash_bwd.cuh) and flash_bwd_sum_kernel.
// In training every MViT block runs it on the pooled, normalized q, k, v:
// at 448 and batch 4, G = B*h groups of q [G, Lq, 96] against k, v
// [G, Lk, 96], from (G 4, Lq 100352, Lk 1568) at block 0 to (G 32, Lq = Lk
// = 1568) at the last stage. The forward does 4*Lq*Lk*d flops per group and
// the backward 10 (16 as executed: the logits recomputed in both of its
// kernels, dq's product twice for dS's hi + lo), against O((Lq + Lk) * d)
// bytes: bound by the tensor cores and by the CUDA-core exponentials of
// the softmax.
//
// Forward (flash_fwd.cuh's core, on wgmma with TMA): a block owns 128 query
// rows, two consumer warpgroups of 64; a producer warp streams the group's
// 64-key K/V tiles through a TMA ring that both consumers share, under the
// running max / sum of online softmax. The Pallas kernel keeps a group's
// whole K/V in VMEM; 227 KB of shared memory cannot, hence the streaming.
// Each consumer reads its query rows straight into A fragments, scaled
// and rounded once, bf16(q * s).
//
// Backward (wgmma with TMA, flash_bwd.cuh), no sequential grid: the Pallas
// kernels add dk / dv into blocks that stay resident over a sequential q
// axis. GPU blocks run in no order, so:
// - a pre-pass writes qs = bf16(q * s) (the operand of the logits and of
//   dk, as the Pallas kernels round it) and (lse, delta = rowsum(dO * O))
//   per query row, padded to whole 64-row tiles;
// - the dq kernel owns 64 query rows and streams the K/V tiles (dq never
//   leaves registers); dq = s * sum dS k in f32 where Pallas multiplies by
//   bf16(k * s) (one rounding of k apart), and where Pallas rounds dS to
//   bf16 for dq this kernel feeds it as two bf16 terms (hi + lo): each row
//   of dS sums to zero, so dq is a difference of nearly equal sums and one
//   rounding of dS showed as 4.8e-2 relative L2 in the batch-1 gradient of
//   block 1's q pool weights against the plain reference (chip_smoke.py,
//   NVIDIA H100 80GB HBM3 at 700 W);
// - the dk/dv kernel owns a 64-key tile and streams (qs, dO) tiles over a
//   range of queries. At block 0 that is only 25 key tiles x G 4 = 100
//   tiles for 132 SMs, each walking 100352 queries, so the query range is
//   split too (the plan: ops/flash_attention.py:_attn_bwd_plan): each split
//   writes f32 partial dk / dv, and flash_bwd_sum_kernel sums them in a
//   fixed order. No atomics: the result does not depend on block order.
//
// Layout: all of q, k, v, out, dO, dq, dk, dv are contiguous token rows
// [G, L, 96]. The training path pays one transpose of each pooled tensor
// from the pool convolutions' [B, h*d, L] into these rows (and one back for
// their gradients) so that the pool norms, this kernel and its backward
// share one layout. Every kernel also takes head dim 72 (MViT-v2-L's
// unfused path, forward with or without the logsumexp and backward): the
// tiles' columns past 72 load as zeros (flash_fwd.cuh, flash_bwd.cuh) and
// only the loads and stores see 72.
#include <math.h>

#include "common.cuh"
#include "flash_fwd.cuh"
#include "ln_bwd.cuh"

namespace aicity {

// The forward of 128 query rows of group blockIdx.y (flash_fwd.cuh): the
// producer warp loads K and V through kmap / vmap ([G][Lk][D] token
// rows); each consumer reads its 64 rows of q ([G][Lq][D], rows past Lq as
// zeros) into A fragments of bf16(q * s), runs the K/V loop and stores out
// (and lse when given). LAST: the last key tile's product width
// (fwd_last_width); D: the head dim (FwdDim).
template <int LAST, int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const bf16* __restrict__ q, bf16* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, float scale) {
  extern __shared__ unsigned char fw_smem_raw[];
  unsigned char* base = align1024(fw_smem_raw);
  const int grp = blockIdx.y, q0 = blockIdx.x * FW_ROWS;
  const FwdRing ring(base, &kmap, &vmap, grp, Lk);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256) ring.produce();
    return;
  }
  const int cw = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = q0 + 64 * cw;  // this consumer's first row
  const int r0 = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  uint32_t qa[6][4];
  rows_to_a<D>(q + (size_t)grp * Lq * D, r0, Lq, lane & 3, qa);
  scale_a(qa, scale);
  float acc[48], m[2], l[2];
  fwd_tile_loop<LAST>(qa, ring, Lk, acc, m, l);
  bf16* st = ring.staging(cw);
  const FwdOut out{o + (size_t)grp * Lq * D, nullptr,
                   lse == nullptr ? nullptr : lse + (size_t)grp * Lq, false};
  fwd_epilogue<D>(acc, m, l, st, row0, Lq, cw, out);
}

// The forward's instance for head dim D and the last key tile's width.
template <int D>
auto flash_fwd_for(int last) {
  return last == 16   ? flash_fwd_kernel<16, D>
         : last == 32 ? flash_fwd_kernel<32, D>
                      : flash_fwd_kernel<BW_T, D>;
}

// The backward's pre-pass: qs = bf16(q * s) token rows (the logits' and
// dk's operand), and ld[row] = (lse, delta = rowsum(dO * O)) for every row
// of the 64-row tiles covering Lq, (+inf, 0) past it. Four lanes a row,
// three 16-byte vectors each (at head dim D 72 the row's nine: lanes past
// them idle); 64 rows a block, grid (Lqp / 64, G).
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          bf16* __restrict__ qs, float2* __restrict__ ld,
                          int Lq, int Lqp, float scale) {
  const int grp = blockIdx.y, q4 = threadIdx.x & 3;
  const int r = blockIdx.x * BW_T + (threadIdx.x >> 2);
  float dsum = 0.f;
  if (r < Lq) {
    const size_t base = ((size_t)grp * Lq + r) * D;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = 8 * (q4 + 4 * i);
      if (D != BW_D && c >= D) continue;
      const uint4 x = *reinterpret_cast<const uint4*>(q + base + c);
      const uint4 a = *reinterpret_cast<const uint4*>(o + base + c);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + base + c);
      const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
      uint32_t y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = pack_bf16(bf16_lo(xw[e]) * scale, bf16_hi(xw[e]) * scale);
        dsum += bf16_lo(aw[e]) * bf16_lo(bw[e]) +
                bf16_hi(aw[e]) * bf16_hi(bw[e]);
      }
      *reinterpret_cast<uint4*>(qs + base + c) =
          make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
  dsum += __shfl_xor_sync(~0u, dsum, 1);
  dsum += __shfl_xor_sync(~0u, dsum, 2);
  if (q4 == 0)
    ld[(size_t)grp * Lqp + r] =
        r < Lq ? make_float2(lse[(size_t)grp * Lq + r], dsum)
               : make_float2(INFINITY, 0.f);
}

// dq of a 64-row tile, one warpgroup: the A fragments of qs and dO from
// global memory (rows past Lq, and columns past D, as zeros), the K/V tiles
// through a TMA ring (dq_tile_loop), dq = s * sum dS k rounded to bf16 (its
// first D columns).
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 2)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const bf16* __restrict__ qs,
                        const bf16* __restrict__ dout,
                        const float2* __restrict__ ld, bf16* __restrict__ dq,
                        int Lq, int Lk, int Lqp, float scale) {
  extern __shared__ unsigned char bw_smem_raw[];
  const int grp = blockIdx.y, q0 = blockIdx.x * BW_T;
  const KvRing<DQ_STAGES> ring(align1024(bw_smem_raw), &kmap, &vmap, grp, Lk);
  ring.start();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[6][4], da[6][4];
  rows_to_a<D>(qs + (size_t)grp * Lq * D, r0, Lq, t, qa);
  rows_to_a<D>(dout + (size_t)grp * Lq * D, r0, Lq, t, da);
  const float2 l0 = ld[(size_t)grp * Lqp + r0], l1 = ld[(size_t)grp * Lqp + r1];
  float acc[12][4];
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  __syncthreads();  // the ring's barriers are set up

  dq_tile_loop(qa, da, ring, Lk, l0.x, l1.x, l0.y, l1.y, acc);

  bf16* dqg = dq + (size_t)grp * Lq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)r0 * D + col) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)r1 * D + col) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// dk and dv from their f32 partials [nsplit][G * Lk * d], summed in a
// fixed order (ln_bwd.cuh:sum_partials, two jobs), rounded to bf16.
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const PartialSums p) {
  sum_partials(p);
}

// A one-tile check of the 64-byte-swizzle descriptors the backward builds
// on: a, b [64][D] bf16 token rows (D 96 or 72), b loaded by TMA as the
// backward loads its tiles (columns past D as zeros); c1 = a b^T [64][64]
// f32 with A from registers and B K-major (the logits of the dq loop and of
// the dk/dv kernel), c2 = bf16(c1) b [64][96] f32 with B MN-major (dq, dk,
// dv; columns past D zero). A wrong leading or stride byte offset gives
// plausible numbers, not a fault, so chip_smoke.py holds these against
// torch before it runs the backward.
template <int D>
__global__ void __launch_bounds__(BW_THREADS)
    wgmma_sw64_probe_kernel(const __grid_constant__ CUtensorMap bmap,
                            const bf16* __restrict__ a, float* __restrict__ c1,
                            float* __restrict__ c2) {
  extern __shared__ unsigned char bw_smem_raw[];
  unsigned char* bt = align1024(bw_smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bt + BW_TILE);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(bar, BW_TILE);
    load_rows_tile(bt, &bmap, bar, 0, 0);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[6][4];
  rows_to_a<D>(a, warp * 16 + g, BW_T, t, qa);
  float s1[32], s2[48];
#pragma unroll
  for (int i = 0; i < 32; ++i) s1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 48; ++i) s2[i] = 0.f;
  mbar_wait(bar, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) WgmmaRS<64>::mma(s1, qa[kk], tile_k(bt, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s1);
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(s1, kk, pa[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaRS<96>::mma<1>(s2, pa[kk], tile_mn(bt, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<48>(s2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c1[r * 64 + 8 * j + 2 * t + e] = s1[4 * j + 2 * h + e];
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c2[r * BW_D + 8 * j + 2 * t + e] = s2[4 * j + 2 * h + e];
  }
}

}  // namespace aicity

// q [G, Lq, d], k / v [G, Lk, d], o [G, Lq, d] bf16 token rows (d 96 or
// 72); lse [G, Lq] f32, or null to skip it.
extern "C" int aicity_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int G, int Lq, int Lk, int d,
                                      float scale, void* stream) {
  using namespace aicity;
  if (d != BW_D && d != 72) return (int)cudaErrorInvalidValue;
  if (G <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaSuccess;
  const int last = fwd_last_width(Lk);
  auto kernel = d == 72 ? flash_fwd_for<72>(last) : flash_fwd_for<96>(last);
  cudaError_t err = set_smem(kernel, fwd_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mk, mv;
  if (make_tmap3_sw64(&mk, k, G, Lk, d, BW_T) ||
      make_tmap3_sw64(&mv, v, G, Lk, d, BW_T))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Lq + FW_ROWS - 1) / FW_ROWS, G);
  kernel<<<grid, FW_THREADS, fwd_smem_bytes(), (cudaStream_t)stream>>>(
      mk, mv, (const bf16*)q, (bf16*)o, (float*)lse, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

// Shared memory of the backward's kernels (0: dq, 1: dk/dv), for the
// wrapper's plan to check its own against.
extern "C" int aicity_flash_bwd_smem_bytes(int which) {
  using namespace aicity;
  return which == 0 ? 1024 + KvRing<DQ_STAGES>::ring_bytes()
                    : dkv_smem_bytes();
}

namespace aicity {

// The backward's four launches at head dim D (aicity_flash_attention_bwd).
template <int D>
int flash_bwd_launches(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* qs, void* ld, void* dq, void* dk, void* dv,
                       void* dk_part, void* dv_part, int G, int Lq, int Lk,
                       float scale, int qps, cudaStream_t s) {
  const int lqp = (Lq + BW_T - 1) / BW_T * BW_T;
  flash_bwd_prep_kernel<D><<<dim3(lqp / BW_T, G), 256, 0, s>>>(
      (const bf16*)q, (const bf16*)out, (const bf16*)dout, (const float*)lse,
      (bf16*)qs, (float2*)ld, Lq, lqp, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap mk, mv;
  if (make_tmap3_sw64(&mk, k, G, Lk, D, BW_T) ||
      make_tmap3_sw64(&mv, v, G, Lk, D, BW_T))
    return (int)cudaErrorInvalidValue;
  const int smem_dq = 1024 + KvRing<DQ_STAGES>::ring_bytes();
  err = set_smem(flash_bwd_dq_kernel<D>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3(lqp / BW_T, G), BW_THREADS, smem_dq, s>>>(
      mk, mv, (const bf16*)qs, (const bf16*)dout, (const float2*)ld,
      (bf16*)dq, Lq, Lk, lqp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_dkv<D>(qs, dout, k, v, (const float2*)ld, (float*)dk_part,
                      (float*)dv_part, G, Lq, Lk, lqp, qps, s);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (Lq + qps - 1) / qps;
  const long n = (long)G * Lk * D;
  PartialSums sums;
  int jobs = 0;
  add_sum(sums, jobs, (const float*)dk_part, (bf16*)dk, nsplit, n);
  add_sum(sums, jobs, (const float*)dv_part, (bf16*)dv, nsplit, n);
  flash_bwd_sum_kernel<<<sums.start[SUM_JOBS], 256, 0, s>>>(sums);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// The backward. out, dout [G, Lq, d]; lse [G, Lq] f32; dq, dk, dv bf16 like
// q, k, v (d 96 or 72). Scratch: qs [G, Lq, d] bf16, ld [G, Lqp] float2
// (Lqp = Lq rounded up to 64), dk_part / dv_part [nsplit, G, Lk, d] f32,
// nsplit = ceil(Lq / qps) query splits of qps rows (a multiple of 64). Four
// kernels: the pre-pass (qs, ld), dq, dk/dv partials, their sums.
extern "C" int aicity_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* qs, void* ld, void* dq,
    void* dk, void* dv, void* dk_part, void* dv_part, int G, int Lq, int Lk,
    int d, float scale, int qps, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if ((d != BW_D && d != 72) || qps <= 0 || qps % BW_T)
    return (int)cudaErrorInvalidValue;
  if (G <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaSuccess;
  return d == 72 ? flash_bwd_launches<72>(q, k, v, out, dout, lse, qs, ld,
                                          dq, dk, dv, dk_part, dv_part, G,
                                          Lq, Lk, scale, qps, s)
                 : flash_bwd_launches<96>(q, k, v, out, dout, lse, qs, ld,
                                          dq, dk, dv, dk_part, dv_part, G,
                                          Lq, Lk, scale, qps, s);
}

// The descriptor check (wgmma_sw64_probe_kernel): a, b [64, d] bf16 (d 96
// or 72); c1 [64, 64] and c2 [64, 96] f32.
extern "C" int aicity_wgmma_sw64_probe(const void* a, const void* b, void* c1,
                                       void* c2, int d, void* stream) {
  using namespace aicity;
  if (d != BW_D && d != 72) return (int)cudaErrorInvalidValue;
  CUtensorMap mb;
  if (make_tmap3_sw64(&mb, b, 1, BW_T, d, BW_T))
    return (int)cudaErrorInvalidValue;
  const int smem = 1024 + BW_TILE + 8;
  auto kernel = d == 72 ? wgmma_sw64_probe_kernel<72>
                        : wgmma_sw64_probe_kernel<96>;
  kernel<<<1, BW_THREADS, smem, (cudaStream_t)stream>>>(
      mb, (const bf16*)a, (float*)c1, (float*)c2);
  return (int)cudaGetLastError();
}
