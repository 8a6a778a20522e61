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
//   one, flash_bwd_dq_kernel + flash_bwd_dkv_kernel.
// In training every MViT block runs it on the pooled, normalized q, k, v:
// at 448 and batch 4, G = B*h groups of q [G, Lq, 96] against k, v
// [G, Lk, 96], from (G 4, Lq 100352, Lk 1568) at block 0 to (G 32, Lq = Lk
// = 1568) at the last stage. The forward does 4*Lq*Lk*d flops per group and
// the backward 10 (recomputing the logits once more in each of its two
// kernels: 14), against O((Lq + Lk) * d) bytes: bound by the tensor cores
// and by the CUDA-core exponentials of the softmax.
//
// Design (FlashAttention-2 on mma.sync m16n8k16 bf16 tiles, f32 sums):
// - Forward: 4 warps own 32 query rows each of a 128-row q tile; 64-key K/V
//   tiles stream through shared memory (cp.async, double buffered) under the
//   running max / sum of online softmax. The Pallas kernel keeps a group's
//   whole K/V in VMEM; 227 KB of shared memory cannot, hence the streaming.
// - Backward, no sequential grid: the Pallas kernels add dk / dv into
//   blocks that stay resident over a sequential q axis. GPU blocks run in
//   no order, so the dq kernel owns 64 query rows and streams the K/V tiles
//   (dq never leaves registers), and the dk/dv kernel owns a 64-key tile and
//   streams q / dO tiles over a range of queries. At block 0 that is only
//   25 key tiles x G 4 = 100 blocks for 132 SMs, each walking 100352
//   queries, so the query range is split too: each split writes f32
//   partial dk / dv, and a second pass (reduce_splits) sums them in a fixed
//   order. No atomics: the result does not depend on block order.
// - Operand discipline as the Pallas kernels: the logits are f32 products
//   of bf16(q * s) with k (so they match the saved lse), P and dS are
//   rounded to bf16 for their products, delta = rowsum(dO * O) comes from
//   outside the kernel (flash_attention.py:555). dk uses bf16(q * s) as the
//   Pallas kernel does; dq multiplies sum(dS . k) by s in f32 where Pallas
//   multiplies by bf16(k * s) (one rounding of k apart). Where Pallas
//   rounds dS to bf16 for dq, this kernel feeds it as two bf16 terms
//   (hi + lo): each row of dS sums to zero, so dq is a difference of
//   nearly equal sums and one rounding of dS showed as 4.8e-2 relative L2
//   in the batch-1 gradient of block 1's q pool weights against the plain
//   reference (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).
// - Layout: all of q, k, v, out, dO, dq, dk, dv are contiguous token rows
//   [G, L, 96]. The training path pays one transpose of each pooled tensor
//   from the pool convolutions' [B, h*d, L] into these rows (and one back
//   for their gradients) so that the pool norms, this kernel and its
//   backward share one layout.
#include <math.h>

#include "common.cuh"
#include "flash_bwd.cuh"

namespace aicity {

constexpr int FW_TQ = 128, FW_TK = 64, FW_THREADS = 128;

template <int D>
__global__ void __launch_bounds__(FW_THREADS, 2)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int TILE = FW_TK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TQ][LD]
  bf16* ks = qs + FW_TQ * LD;                    // 2 stages of [TK][LD]
  bf16* vs = ks + 2 * TILE;

  const int grp = blockIdx.y;
  const int q0 = blockIdx.x * FW_TQ;
  const bf16* qg = q + (size_t)grp * Lq * D;
  const bf16* kg = k + (size_t)grp * Lk * D;
  const bf16* vg = v + (size_t)grp * Lk * D;
  bf16* og = o + (size_t)grp * Lq * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 32;
  const int ntiles = (Lk + FW_TK - 1) / FW_TK;

  load_tile_async(qs, LD, qg, D, q0, Lq, 0, FW_TQ, D);
  load_tile_async(ks, LD, kg, D, 0, Lk, 0, FW_TK, D);
  load_tile_async(vs, LD, vg, D, 0, Lk, 0, FW_TK, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[2][KS][4];  // bf16(q * scale), as the Pallas kernel rounds it
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      load_a_frag(qa[mi][kk], qs, LD, wr + mi * 16, kk * 16, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&qa[mi][kk][e]);
        qa[mi][kk][e] = pack_bf16(__bfloat162float(p.x) * scale,
                                  __bfloat162float(p.y) * scale);
      }
    }

  float acc[2][ND][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nd][e] = 0.f;
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      const int j1 = (j + 1) * FW_TK;
      load_tile_async(ks + nb * TILE, LD, kg, D, j1, Lk, 0, FW_TK, D);
      load_tile_async(vs + nb * TILE, LD, vg, D, j1, Lk, 0, FW_TK, D);
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
      float s[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          load_b_frag_x2(b, kt, LD, kb + np * 16, kk * 16, lane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(s[mi][2 * np], qa[mi][kk], b);
            mma_16816(s[mi][2 * np + 1], qa[mi][kk], b + 2);
          }
        }

#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int key = j * FW_TK + kb + nt * 8 + 2 * t;
          if (key >= Lk) { s[mi][nt][0] = -INFINITY; s[mi][nt][2] = -INFINITY; }
          if (key + 1 >= Lk) {
            s[mi][nt][1] = -INFINITY;
            s[mi][nt][3] = -INFINITY;
          }
          mx0 = fmaxf(mx0, fmaxf(s[mi][nt][0], s[mi][nt][1]));
          mx1 = fmaxf(mx1, fmaxf(s[mi][nt][2], s[mi][nt][3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // a fully masked half keeps the old max (never the first half)
        const float mn0 = fmaxf(m[mi][0], mx0), mn1 = fmaxf(m[mi][1], mx1);
        const float al0 = __expf(m[mi][0] - mn0), al1 = __expf(m[mi][1] - mn1);
        m[mi][0] = mn0;
        m[mi][1] = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          s[mi][nt][0] = __expf(s[mi][nt][0] - mn0);
          s[mi][nt][1] = __expf(s[mi][nt][1] - mn0);
          s[mi][nt][2] = __expf(s[mi][nt][2] - mn1);
          s[mi][nt][3] = __expf(s[mi][nt][3] - mn1);
          rs0 += s[mi][nt][0] + s[mi][nt][1];
          rs1 += s[mi][nt][2] + s[mi][nt][3];
        }
        l[mi][0] = l[mi][0] * al0 + rs0;
        l[mi][1] = l[mi][1] * al1 + rs1;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[mi][nd][0] *= al0;
          acc[mi][nd][1] *= al0;
          acc[mi][nd][2] *= al1;
          acc[mi][nd][3] *= al1;
        }
      }

#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          a[mi][0] = pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
          a[mi][1] = pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
          a[mi][2] = pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
          a[mi][3] = pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
        }
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b[4];
          load_b_frag_trans_x2(b, vt, LD, kb + kk * 16, nd * 8, lane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(acc[mi][nd], a[mi], b);
            mma_16816(acc[mi][nd + 1], a[mi], b + 2);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    float l0 = l[mi][0], l1 = l[mi][1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int r0 = q0 + wr + mi * 16 + g, r1 = r0 + 8;
    if (lse != nullptr && t == 0) {
      if (r0 < Lq) lse[(size_t)grp * Lq + r0] = m[mi][0] + logf(l0);
      if (r1 < Lq) lse[(size_t)grp * Lq + r1] = m[mi][1] + logf(l1);
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(og + (size_t)r0 * D + col) =
            pack_bf16(acc[mi][nd][0] / l0, acc[mi][nd][1] / l0);
      if (r1 < Lq)
        *reinterpret_cast<uint32_t*>(og + (size_t)r1 * D + col) =
            pack_bf16(acc[mi][nd][2] / l1, acc[mi][nd][3] / l1);
    }
  }
}

// dq of a 64-row q tile: 4 warps own 16 rows each; K/V tiles of 64 keys
// stream through shared memory. Per 32 keys: S = bf16(q s) k^T,
// P = exp(S - lse), dP = dO v^T, dS = bf16(P (dP - delta)), dq += dS k.
template <int D>
__global__ void __launch_bounds__(BW_THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int Lq, int Lk, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int TILE = BW_T * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dos = qs + TILE;                         // [64][LD]
  bf16* ks = dos + TILE;                         // 2 stages
  bf16* vs = ks + 2 * TILE;                      // 2 stages

  const int grp = blockIdx.y;
  const int q0 = blockIdx.x * BW_T;
  const bf16* qg = q + (size_t)grp * Lq * D;
  const bf16* dg = dout + (size_t)grp * Lq * D;
  const bf16* kg = k + (size_t)grp * Lk * D;
  const bf16* vg = v + (size_t)grp * Lk * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  load_tile_async(qs, LD, qg, D, q0, Lq, 0, BW_T, D);
  load_tile_async(dos, LD, dg, D, q0, Lq, 0, BW_T, D);
  load_tile_async(ks, LD, kg, D, 0, Lk, 0, BW_T, D);
  load_tile_async(vs, LD, vg, D, 0, Lk, 0, BW_T, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a_frag(qa[kk], qs, LD, wr, kk * 16, lane);
    load_a_frag(da[kk], dos, LD, wr, kk * 16, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&qa[kk][e]);
      qa[kk][e] = pack_bf16(__bfloat162float(p.x) * scale,
                            __bfloat162float(p.y) * scale);
    }
  }
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  // rows past Lq get lse = +inf: P = 0 there
  const float lse0 = r0 < Lq ? lse[(size_t)grp * Lq + r0] : INFINITY;
  const float lse1 = r1 < Lq ? lse[(size_t)grp * Lq + r1] : INFINITY;
  const float dl0 = r0 < Lq ? delta[(size_t)grp * Lq + r0] : 0.f;
  const float dl1 = r1 < Lq ? delta[(size_t)grp * Lq + r1] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  dq_tile_loop<D>(qa, da, ks, vs, kg, vg, Lk, lse0, lse1, dl0, dl1, acc);

  bf16* dqg = dq + (size_t)grp * Lq * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)r0 * D + col) =
          pack_bf16(acc[nd][0] * scale, acc[nd][1] * scale);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)r1 * D + col) =
          pack_bf16(acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

}  // namespace aicity

// q [G, Lq, d], k / v [G, Lk, d], o [G, Lq, d] bf16 token rows; lse [G, Lq]
// f32, or null to skip it.
extern "C" int aicity_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int G, int Lq, int Lk, int d,
                                      float scale, void* stream) {
  using namespace aicity;
  if (d != 96) return (int)cudaErrorInvalidValue;
  if (G <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(FW_TQ + 4 * FW_TK) * (96 + 8) * sizeof(bf16);
  cudaError_t err = set_smem(flash_fwd_kernel<96>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + FW_TQ - 1) / FW_TQ, G);
  flash_fwd_kernel<96><<<grid, FW_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      Lq, Lk, scale);
  return (int)cudaGetLastError();
}

// The backward. dout [G, Lq, d]; lse, delta [G, Lq] f32 (delta =
// rowsum(dout * out)); dq, dk, dv bf16 like q, k, v; dk_part / dv_part
// [nsplit, G, Lk, d] f32 scratch, nsplit = ceil(Lq / qps) query splits of
// qps rows (a multiple of 64).
extern "C" int aicity_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    void* dk_part, void* dv_part, int G, int Lq, int Lk, int d, float scale,
    int qps, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (d != 96 || qps <= 0 || qps % BW_T) return (int)cudaErrorInvalidValue;
  if (G <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaSuccess;
  constexpr int LD = 96 + 8;
  const size_t smem_dq = (size_t)6 * BW_T * LD * sizeof(bf16);
  cudaError_t err = set_smem(flash_bwd_dq_kernel<96>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<96><<<dim3((Lq + BW_T - 1) / BW_T, G), BW_THREADS,
                            smem_dq, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, Lq, Lk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (Lq + qps - 1) / qps;
  const size_t smem_kv =
      (size_t)6 * BW_T * LD * sizeof(bf16) + 4 * BW_T * sizeof(float);
  err = set_smem(flash_bwd_dkv_kernel<96>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<96><<<dim3((Lk + BW_T - 1) / BW_T, G, nsplit),
                             BW_THREADS, smem_kv, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (float*)dk_part,
      (float*)dv_part, G, Lq, Lk, scale, qps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)G * Lk * d;
  err = reduce_splits((const float*)dk_part, (bf16*)dk, nsplit, n, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_splits((const float*)dv_part, (bf16*)dv, nsplit, n, s);
}
