// Flash attention over raw pooled q/k/v with the per-head LayerNorms and the
// MViT-v2 query residual fused, for Hopper:
//   out = softmax(LN(q) * s . LN(k)^T) . LN(v)  [+ LN(q)]
// with each LN applied only where its flag is set (eps 1e-5, over head_dim).
//
// Replaces aicity_action_tpu/ops/pallas/flash_attention.py:_flash_ln_fwd_kernel
// (reached through flash_attention_ln), which runs in all 16 MViT blocks at
// inference, and _flash_ln_fwd_lse_kernel (_flash_ln_fwd, the forward under
// autograd when training takes the fused path): the same kernel, which also
// stores the f32 logsumexp of each query row when given an lse buffer, and
// the attention output before the v2 residual for the backward's delta
// (the Pallas wrapper recovers it as out - LN(q) from the bf16 out, which
// costs a rounding of O + LN(q), with LN(q) of order 1: noise in gradients
// that cancel, such as the k norm's bias gradient, exactly zero). At
// 448 it sees q [B*h, Lq, 96] and k, v [B*h, Lk, 96] with Lq up to 100352
// and Lk in {1568, 6272}: 4*Lq*Lk*d flops against 2*(Lq + 2*Lk)*d
// bytes, far above the ridge, so it is bound by the tensor cores (and by the
// CUDA-core work of the softmax).
//
// Translation from the TPU design:
// - Pallas keeps one group's whole K/V resident in VMEM (up to 1.2 MB each)
//   and normalizes it once per group into scratch at grid step 0. GPU blocks
//   run in no order and share nothing, so the entry point normalizes K and V
//   once, in a pass (kv_rows_kernel) into scratch the caller provides: Lk*d
//   work per group, where normalizing inside every q tile would repeat it
//   Lq/128 times. The attention kernel then streams 64-key tiles of the
//   normalized K/V through shared memory with cp.async, double buffered,
//   under the running max / sum of online softmax (FlashAttention-2).
// - LN(q) is computed once per 128-row q tile and stays in shared memory for
//   the residual; the output is acc / l [+ LN(q)] rounded as the Pallas
//   kernel rounds it.
// - Layout: the pool convolutions leave q, k, v d-major ([B, h*d, L], NCDHW)
//   where the TPU kernel reads head-major token rows. Rather than transpose
//   them in device memory, the kernel reads the d-major layout as it lies: a
//   q tile is loaded as D rows of 128 tokens and turned into token rows in
//   shared memory by its LayerNorm, and K/V become token rows in the pass
//   that normalizes them.
// Design: 4 warps own 32 query rows each, so each K/V fragment read from
// shared memory (the kernel's scarcest bandwidth) feeds two m16 tiles;
// S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 tiles with f32
// accumulation over 32-key halves of each tile, P is re-packed from the S
// accumulators into A fragments without touching shared memory, and K's
// and V's B fragments come from their row-major tiles through ldmatrix
// (.trans for V).
#include <math.h>

#include "common.cuh"
#include "flash_ln.cuh"

namespace aicity {

// 4 warps own 32 query rows each (two m16 tiles), so every K/V fragment read
// from shared memory feeds two MMAs; two blocks fit on an SM.
constexpr int FA_TQ = 128, FA_TK = 64, FA_THREADS = 128;

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 2)
    flash_ln_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ gq,
                    const bf16* __restrict__ bq, bf16* __restrict__ o,
                    float* __restrict__ lse, bf16* __restrict__ oa, int Lq,
                    int Lk, float scale, float eps, int fq, int add_qn) {
  constexpr int LD = D + 8;        // smem row stride (16-byte aligned rows)
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int ND = D / 8;        // n-tiles of the output
  constexpr int TILE = FA_TK * LD; // one K or V stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [TQ][LD]
  bf16* ks = qs + FA_TQ * LD;                    // 2 stages of [TK][LD]
  bf16* vs = ks + 2 * TILE;                      // 2 stages of [TK][LD]
  bf16* qt = vs + 2 * TILE;                      // [D][TQ+8] of q

  const int grp = blockIdx.y;
  const int q0 = blockIdx.x * FA_TQ;
  const bf16* qg = q + (size_t)grp * D * Lq;  // [D][Lq]
  const bf16* kg = k + (size_t)grp * Lk * D;  // token rows [Lk][D]
  const bf16* vg = v + (size_t)grp * Lk * D;
  bf16* og = o + (size_t)grp * Lq * D;
  bf16* oag = oa == nullptr ? nullptr : oa + (size_t)grp * Lq * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 32;  // this warp's first row in the q tile
  const int ntiles = (Lk + FA_TK - 1) / FA_TK;

  // the first K/V tile is in flight while the q tile is normalized
  load_tile_async(ks, LD, kg, D, 0, Lk, 0, FA_TK, D);
  load_tile_async(vs, LD, vg, D, 0, Lk, 0, FA_TK, D);
  cp_async_commit();
  // q is [D][Lq] per group: a D x TQ tile, turned to token rows
  load_tile_cols(qt, FA_TQ + 8, qg, Lq, q0, Lq, D, FA_TQ);
  __syncthreads();
  norm_cols_to_rows<D>(qt, FA_TQ + 8, qs, LD, FA_TQ, gq, bq, eps, fq);
  __syncthreads();

  // A fragments of bf16(LN(q) * scale), as the Pallas kernel rounds them
  uint32_t qa[2][KS][4];
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
  // running max and (per-thread partial) sum of rows g and g + 8 of each m16
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {  // prefetch the next tile into the other stage
      const int nb = (j + 1) & 1;
      const int j1 = (j + 1) * FA_TK;
      load_tile_async(ks + nb * TILE, LD, kg, D, j1, Lk, 0, FA_TK, D);
      load_tile_async(vs + nb * TILE, LD, vg, D, j1, Lk, 0, FA_TK, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + (j & 1) * TILE;
    const bf16* vt = vs + (j & 1) * TILE;

    // the tile's keys in two halves of 32, each a full online-softmax step
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
        // mask keys past Lk, then the online softmax update of rows g, g+8
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int key = j * FA_TK + kb + nt * 8 + 2 * t;
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

      // O += P V over the half's 32 keys (two k16 steps)
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
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    float l0 = l[mi][0], l1 = l[mi][1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int r0 = wr + mi * 16 + g, r1 = r0 + 8;
    if (lse != nullptr && t == 0) {  // the training forward's logsumexp
      if (q0 + r0 < Lq) lse[(size_t)grp * Lq + q0 + r0] = m[mi][0] + logf(l0);
      if (q0 + r1 < Lq) lse[(size_t)grp * Lq + q0 + r1] = m[mi][1] + logf(l1);
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * t;
      float y[4] = {acc[mi][nd][0] / l0, acc[mi][nd][1] / l0,
                    acc[mi][nd][2] / l1, acc[mi][nd][3] / l1};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = __bfloat162float(__float2bfloat16(y[e]));
      if (oag != nullptr) {  // the attention output before the residual
        if (q0 + r0 < Lq)
          *reinterpret_cast<uint32_t*>(oag + (size_t)(q0 + r0) * D + col) =
              pack_bf16(y[0], y[1]);
        if (q0 + r1 < Lq)
          *reinterpret_cast<uint32_t*>(oag + (size_t)(q0 + r1) * D + col) =
              pack_bf16(y[2], y[3]);
      }
      if (add_qn) {
        y[0] += __bfloat162float(qs[r0 * LD + col]);
        y[1] += __bfloat162float(qs[r0 * LD + col + 1]);
        y[2] += __bfloat162float(qs[r1 * LD + col]);
        y[3] += __bfloat162float(qs[r1 * LD + col + 1]);
      }
      if (q0 + r0 < Lq)
        *reinterpret_cast<uint32_t*>(og + (size_t)(q0 + r0) * D + col) =
            pack_bf16(y[0], y[1]);
      if (q0 + r1 < Lq)
        *reinterpret_cast<uint32_t*>(og + (size_t)(q0 + r1) * D + col) =
            pack_bf16(y[2], y[3]);
    }
  }
}

template <int D>
size_t flash_ln_smem_bytes() {
  return ((size_t)(FA_TQ + 4 * FA_TK) * (D + 8) + (size_t)D * (FA_TQ + 8)) *
         sizeof(bf16);
}

template <int D>
int launch_flash_ln(const void* q, const void* k, const void* v,
                    const void* gq, const void* bq, void* o, void* lse,
                    void* oa, int G, int Lq, int Lk, float scale, float eps,
                    int fq, int add_qn, cudaStream_t stream) {
  const size_t smem = flash_ln_smem_bytes<D>();
  cudaError_t err = set_smem(flash_ln_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + FA_TQ - 1) / FA_TQ, G);
  flash_ln_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)gq,
      (const bf16*)bq, (bf16*)o, (float*)lse, (bf16*)oa, Lq, Lk, scale, eps,
      fq, add_qn);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// q, k, v come d-major, [G, d, L] (per head, the NCDHW output of the pool
// convolutions); kn / vn are [G, Lk, d] scratch for the token rows of
// LN(k) / LN(v) (of k / v where fk / fv is off). The output is [G, Lq, d].
// The training forward also stores lse [G, Lq] f32 (the logsumexp) and oa
// [G, Lq, d], the attention output before the residual, for the backward's
// delta; either may be null.
extern "C" int aicity_flash_attention_ln(
    const void* q, const void* k, const void* v, const void* gq,
    const void* bq, const void* gk, const void* bk, const void* gv,
    const void* bv, void* o, void* lse, void* oa, void* kn, void* vn, int G,
    int Lq, int Lk, int d, float scale, float eps, int fq, int fk, int fv,
    int add_qn, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (d != 96) return (int)cudaErrorInvalidValue;
  if (G <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaSuccess;
  const dim3 kv_grid((Lk + 127) / 128, G);
  kv_rows_kernel<96><<<kv_grid, 128, 0, s>>>(
      (const bf16*)k, (const bf16*)gk, (const bf16*)bk, (bf16*)kn, Lk, eps, fk);
  kv_rows_kernel<96><<<kv_grid, 128, 0, s>>>(
      (const bf16*)v, (const bf16*)gv, (const bf16*)bv, (bf16*)vn, Lk, eps, fv);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_flash_ln<96>(q, kn, vn, gq, bq, o, lse, oa, G, Lq, Lk, scale,
                             eps, fq, add_qn, s);
}
