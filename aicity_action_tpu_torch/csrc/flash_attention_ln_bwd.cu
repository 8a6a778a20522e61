// Backward of the fused post-pool-LN attention for Hopper:
//   out = softmax(LN(q) * s . LN(k)^T) . LN(v)  [+ LN(q)]
//   -> dq, dk, dv (raw, through each LN's VJP) and dgamma / dbeta of the
//      three pool norms (zeros where a flag is off).
//
// Replaces aicity_action_tpu/ops/pallas/flash_attention.py:_flash_ln_bwd
// (:1203), which picks _flash_ln_dqkv_kernel (:929, K/V resident) or
// _flash_ln_dqkv_chunked_kernel (:1020, K chunked, dq as partials): here
// ONE design for every shape. Training with AICITY_TPU_FUSE_ATTN_LN=1 runs
// it in every MViT block; at 448 and batch 4 it sees G = B*h groups of
// q [G, Lq, 96] against k, v [G, Lk, 96], from (4, 100352, 1568) at block 0
// to (32, 1568, 1568) (MViT-v2-B), and of head dim 72 from (8, 100352,
// 1568) to (64, 1568, 1568) (MViT-v2-L). Like the plain attention backward
// it is bound by the tensor cores (10 products per (q, k) pair and d, 16 as
// executed: the logits recomputed in both kernels, dq's product twice for
// dS's hi + lo) and the softmax's exponentials; the LN work is O((Lq + Lk)
// * d).
//
// Translation from the TPU design: the Pallas kernels add dk / dv and the
// dgamma / dbeta rows into blocks resident across a sequential grid and
// convert d(LN k) into dk at the last q step. GPU blocks run in no order,
// so the work is five passes, all sums in a fixed order (no atomics, the
// same bits every run):
// 1. kv_norm_kernel (flash_ln.cuh, the forward's K/V pass) normalizes K and
//    V once into token-row scratch, one launch for both: 64 keys a block,
//    the d-major tile in and the rows out by 16-byte vectors.
// 2. flash_ln_bwd_dq_kernel owns 64 query rows: it normalizes its q tile
//    (kept raw too, for the VJP), writes the LN(q) rows to scratch for pass
//    3 already scaled, bf16(bf16(LN q) * s), the operand of the logits and
//    of dk, computes delta = rowsum(dO * O) from the attention output
//    before the residual, which the forward saved (the Pallas wrapper
//    recovers it as out - LN(q) from the bf16 out, one rounding of O + LN(q)
//    more), and writes (lse, delta) per row padded to whole 64-row tiles;
//    then it runs the dq loop of the plain backward (flash_bwd.cuh: wgmma,
//    the normalized K/V tiles through a TMA ring), adds dO for the
//    residual, and applies the row-LN VJP in its epilogue (a row's columns
//    lie in one quad of lanes). It writes dq channel-major and per-block
//    dgamma_q / dbeta_q partials.
// 3. flash_bwd_dkv_kernel (flash_bwd.cuh) on the scaled LN(q) rows: f32
//    partial d(LN k) / d(LN v) per query split.
// 4. kv_vjp_kernel takes 64 keys of k or v a block: it sums their rows of
//    the split partials in split order (16-byte loads, a warp on 512
//    contiguous bytes), copies the raw d-major tile in, and applies the
//    row-LN VJP two lanes a key (the statistics as pass 1 takes them), dk /
//    dv going back d-major through the tile in shared memory by 16-byte
//    stores, and the block's dgamma / dbeta partials as column sums over
//    its keys. Bound by the partials' bytes.
// 5. flash_ln_bwd_sum_kernel sums the dgamma / dbeta partials of q, k and
//    v, three jobs of one launch (ln_bwd.cuh:sum_partials); the thousands
//    of per-block partials (G * Lq / 64 of q: 12,544 at MViT-v2-L's first
//    blocks) go through a tree of 64-split chunks spread over the card
//    (ln_bwd.cuh:add_tree_sum), latency- rather than byte-bound.
// Layout: q, k, v come d-major ([G][d][L], the pool convolutions' NCDHW
// output) and dq, dk, dv go back the same way, so the training path pays no
// transposes around the attention; O and dO are token rows [G][L][d].
//
// Head dim 72 (MViT-v2-L; the kernels' D): as in flash_bwd.cuh, the
// products keep the tiles of 96. The TMA maps of LN(k), LN(v), the scaled
// LN(q) rows and dO have inner extent 72, so TMA fills columns 72-95 of
// every streamed tile with zeros; the dq kernel's A fragments of its LN(q)
// and dO rows are zeros past 72 (its shared-memory rows keep the stride of
// 96 and are never read past 72). So the logits, dP and dq's product run
// as at 96 and give dq zero columns past 72, which are not stored. Only
// loads, the LayerNorms and their VJPs (means over 72 columns, gamma and
// beta read at 72), delta, the column sums and the stores see 72.
#include <math.h>

#include "common.cuh"
#include "flash_bwd.cuh"
#include "flash_ln.cuh"
#include "ln_bwd.cuh"

namespace aicity {

// the row stride (bf16) of the dq kernel's LN(q), dO and O rows: the 96
// columns of the products and 8 of padding, at either head dim
constexpr int LN_DQ_LD = BW_D + 8;

template <int D>
__host__ __device__ constexpr int ln_dq_xs_elems() {
  return D * (BW_T + 8) > BW_T * LN_DQ_LD ? D * (BW_T + 8) : BW_T * LN_DQ_LD;
}

// Dynamic shared memory of the dq kernel: alignment slack, the K/V ring,
// the LN(q) and dO rows, the raw q tile (D rows), the O rows / dq staging,
// the row statistics, delta and the column sums.
template <int D>
__host__ __device__ constexpr int ln_dq_smem_bytes() {
  return 1024 + KvRing<DQ_LN_STAGES>::ring_bytes() +
         (2 * BW_T * LN_DQ_LD + D * (BW_T + 8) + ln_dq_xs_elems<D>()) *
             (int)sizeof(bf16) +
         (3 * BW_T + 8 * D) * (int)sizeof(float);
}

// dq of a 64-row q tile, one warpgroup (warp w owns rows 16w + g, 16w + g +
// 8). q is d-major [G][D][Lq] (Lq % 8 == 0); oa (the attention output
// before the residual) and dout are token rows; the LN(k) / LN(v) rows come
// through the TMA maps kmap / vmap. Writes the scaled LN(q) rows qn and
// ld [G][Lqp] = (lse, delta), (+inf, 0) past Lq. D: the head dim, 96 or 72
// (the products over 96 columns either way).
template <int D>
__global__ void __launch_bounds__(BW_THREADS, 2)
    flash_ln_bwd_dq_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const bf16* __restrict__ q,
                           const bf16* __restrict__ oa,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const bf16* __restrict__ gq,
                           const bf16* __restrict__ bq, bf16* __restrict__ qn,
                           float2* __restrict__ ld, bf16* __restrict__ dq,
                           float* __restrict__ part, int Lq, int Lk, int Lqp,
                           float scale, float eps, int fq, int add_qn) {
  constexpr int LD = LN_DQ_LD, LDT = BW_T + 8;
  // k16 steps and n8 column blocks of the products (96 columns); the
  // column blocks the head dim fills
  constexpr int KS = BW_D / 16, NA = BW_D / 8, ND = D / 8;
  constexpr int TILE = BW_T * LD;
  extern __shared__ unsigned char bw_smem_raw[];
  unsigned char* ring_base = align1024(bw_smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(
      ring_base + KvRing<DQ_LN_STAGES>::ring_bytes());  // [64][LD] LN(q) s
  bf16* dos = qs + TILE;                                 // [64][LD] dO rows
  bf16* qt = dos + TILE;                                 // [D][LDT] raw q
  bf16* xs = qt + D * LDT;  // oa rows [64][LD], then dq staging [D][LDT]
  float* s_mean = reinterpret_cast<float*>(xs + ln_dq_xs_elems<D>());
  float* s_rstd = s_mean + BW_T;
  float* s_delta = s_rstd + BW_T;
  float* s_col = s_delta + BW_T;  // [4 warps][2][D] column sums

  const int grp = blockIdx.y;
  const int q0 = blockIdx.x * BW_T;
  const bf16* qg = q + (size_t)grp * D * Lq;
  const bf16* og = oa + (size_t)grp * Lq * D;
  const bf16* dg = dout + (size_t)grp * Lq * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  // the first K/V tiles, dO and O are in flight while q is normalized
  const KvRing<DQ_LN_STAGES> ring(ring_base, &kmap, &vmap, grp, Lk);
  ring.start();
  load_tile_async(dos, LD, dg, D, q0, Lq, 0, BW_T, D);
  load_tile_async(xs, LD, og, D, q0, Lq, 0, BW_T, D);
  cp_async_commit();
  load_tile_cols(qt, LDT, qg, Lq, q0, Lq, D, BW_T);
  __syncthreads();
  norm_cols_to_rows<D>(qt, LDT, qs, LD, BW_T, gq, bq, eps, fq, threadIdx.x,
                       blockDim.x, s_mean, s_rstd);
  cp_async_wait<0>();
  __syncthreads();

  // bf16(LN(q) * s) in place, the operand of the logits and of dk as the
  // Pallas kernels round it, and its rows for the dk/dv kernel
  bf16* qng = qn + (size_t)grp * Lq * D;
  for (int i = threadIdx.x; i < BW_T * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
    uint4* p = reinterpret_cast<uint4*>(qs + r * LD + c);
    const uint4 x = *p;
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    uint32_t y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = pack_bf16(bf16_lo(w[e]) * scale, bf16_hi(w[e]) * scale);
    *p = make_uint4(y[0], y[1], y[2], y[3]);
    if (q0 + r < Lq)
      *reinterpret_cast<uint4*>(qng + (size_t)(q0 + r) * D + c) = *p;
  }
  // delta = rowsum(dO * O), one warp per row (rows past Lq: 0), and the
  // rows' (lse, delta) for the dk/dv kernel
  for (int r = warp; r < BW_T; r += BW_THREADS / 32) {
    float sum = 0.f;
    for (int c = lane; c < D; c += 32)
      sum += __bfloat162float(dos[r * LD + c]) *
             __bfloat162float(xs[r * LD + c]);
    sum = warp_sum(sum);
    if (lane == 0) {
      s_delta[r] = sum;
      ld[(size_t)grp * Lqp + q0 + r] =
          q0 + r < Lq ? make_float2(lse[(size_t)grp * Lq + q0 + r], sum)
                      : make_float2(INFINITY, 0.f);
    }
  }
  __syncthreads();

  // the A fragments of the LN(q) s and dO rows (load_a_frag's layout),
  // zeros past column D
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 16 * kk + 8 * (i >> 1);
      const int off = (wr + g + 8 * (i & 1)) * LD + col + 2 * t;
      qa[kk][i] = col < D ? *reinterpret_cast<const uint32_t*>(qs + off) : 0u;
      da[kk][i] = col < D ? *reinterpret_cast<const uint32_t*>(dos + off) : 0u;
    }
  // rows past Lq get lse = +inf: P = 0 there
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  const float lse0 = r0 < Lq ? lse[(size_t)grp * Lq + r0] : INFINITY;
  const float lse1 = r1 < Lq ? lse[(size_t)grp * Lq + r1] : INFINITY;
  float acc[NA][4];
#pragma unroll
  for (int nd = 0; nd < NA; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  dq_tile_loop(qa, da, ring, Lk, lse0, lse1, s_delta[wr + g],
               s_delta[wr + g + 8], acc);

  // epilogue: d(LN q) = s * dS k (+ dO), then the row-LN VJP of q over the
  // first D columns (acc is zero past them)
  float cg[ND][2], cb[ND][2];  // this thread's column sums over its rows
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    cg[nd][0] = cg[nd][1] = cb[nd][0] = cb[nd][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr + g + 8 * h;
    const float mean = s_mean[r], rstd = s_rstd[r];
    float dy[ND][2], xh[ND][2];
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nd * 8 + 2 * t + e;
        float y = acc[nd][2 * h + e] * scale;
        if (add_qn) y += __bfloat162float(dos[r * LD + c]);
        dy[nd][e] = y;
        xh[nd][e] = (__bfloat162float(qt[c * LDT + r]) - mean) * rstd;
        const float yg = y * __bfloat162float(gq[c]);
        p1 += yg;
        p2 += yg * xh[nd][e];
      }
    // the row's D columns lie in the quad of lanes sharing g
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      p1 += __shfl_xor_sync(0xffffffffu, p1, off);
      p2 += __shfl_xor_sync(0xffffffffu, p2, off);
    }
    const float m1 = p1 / D, m2 = p2 / D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nd * 8 + 2 * t + e;
        float v = dy[nd][e];
        if (fq) {
          v = (v * __bfloat162float(gq[c]) - m1 - xh[nd][e] * m2) * rstd;
          cg[nd][e] += dy[nd][e] * xh[nd][e];
          cb[nd][e] += dy[nd][e];
        }
        xs[c * LDT + r] = __float2bfloat16(v);  // dq staging, d-major
      }
  }
  // column sums over the warp's 16 rows (the lanes sharing t), one slab
  // per warp
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = cg[nd][e], b = cb[nd][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (g == 0) {
        const int c = nd * 8 + 2 * t + e;
        s_col[warp * 2 * D + c] = a;
        s_col[warp * 2 * D + D + c] = b;
      }
    }
  __syncthreads();

  float* pb = part + ((size_t)grp * gridDim.x + blockIdx.x) * 2 * D;
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < BW_THREADS / 32; ++w) sum += s_col[w * 2 * D + c];
    pb[c] = sum;  // zeros when !fq
  }
  bf16* dqg = dq + (size_t)grp * D * Lq;
  for (int i = threadIdx.x; i < D * (BW_T / 8); i += blockDim.x) {
    const int c = i / (BW_T / 8), r = (i - c * (BW_T / 8)) * 8;
    if (q0 + r < Lq)
      *reinterpret_cast<uint4*>(dqg + (size_t)c * Lq + q0 + r) =
          *reinterpret_cast<const uint4*>(xs + c * LDT + r);
  }
}

// dk or dv (blockIdx.z 0 or 1) of KV_TILE keys of group blockIdx.y from
// the split partials of d(LN k) / d(LN v) [nsplit][G][Lk][D] f32: the
// tile's rows of every split summed in split order by 16-byte loads into
// registers (a thread's float4s at fixed places), kept as rows in shared
// memory; the raw d-major k / v tile [D][KV_TILE] copied in beside them;
// the row-LN VJP two lanes a key (col_stats, as kv_norm_kernel takes the
// statistics; a copy where the flag is off), dx written over the raw tile
// (each lane over the values it read) and stored d-major by 16-byte
// vectors; the block's dgamma / dbeta partial part[z][G * nkt][2][D] as
// column sums over the tile's keys in key order (dbeta first, then dy *
// xhat written over dy). No thread holds more than D / 2 channels.
template <int D>
__global__ void __launch_bounds__(KV_THREADS)
    kv_vjp_kernel(const float* __restrict__ dk_part,
                  const float* __restrict__ dv_part,
                  const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ gk, const bf16* __restrict__ gv,
                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                  float* __restrict__ part, int G, int Lk, int nsplit,
                  float eps, int fk, int fv) {
  constexpr int LDY = D + 4;                             // f32 row stride
  constexpr int NV = KV_TILE * (D / 4) / KV_THREADS;     // float4s a thread
  constexpr int DL = D / 2;                              // channels a lane
  static_assert(KV_TILE * (D / 4) % KV_THREADS == 0 && DL % 2 == 0,
                "the tile's float4s and channels split evenly");
  __shared__ __align__(16) bf16 xs[D * KV_LDX];    // raw x, then dx
  __shared__ __align__(16) float dys[KV_TILE * LDY];  // dy, then dy * xhat
  const int z = blockIdx.z, grp = blockIdx.y, t0 = blockIdx.x * KV_TILE;
  const size_t off = (size_t)grp * D * Lk;
  const int flag = z ? fv : fk;
  load_cols_tile<D, KV_TILE>(xs, KV_LDX, (z ? v : k) + off, Lk, t0);

  const int nvec = min(KV_TILE, Lk - t0) * (D / 4);
  const float4* p4 = reinterpret_cast<const float4*>(
      (z ? dv_part : dk_part) + ((size_t)grp * Lk + t0) * D);
  const size_t slab = (size_t)G * Lk * (D / 4);
  float4 acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsplit; ++s) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = threadIdx.x + j * KV_THREADS;
      if (i < nvec) {
        const float4 a = p4[s * slab + i];
        acc[j].x += a.x;
        acc[j].y += a.y;
        acc[j].z += a.z;
        acc[j].w += a.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x + j * KV_THREADS;
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    *reinterpret_cast<float4*>(dys + r * LDY + c) = acc[j];  // 0 past Lk
  }
  cp_async_wait<0>();
  __syncthreads();

  // dbeta's column sums; then the rows' VJP overwrites dy with dy * xhat
  float cb = 0.f;
  if (flag && threadIdx.x < D)
    for (int r = 0; r < KV_TILE; ++r) cb += dys[r * LDY + threadIdx.x];
  __syncthreads();
  {
    const int tok = threadIdx.x >> 1, c0 = DL * (threadIdx.x & 1);
    const bf16* gamma = (z ? gv : gk) + c0;
    bf16* xc = xs + c0 * KV_LDX + tok;
    float* dy = dys + tok * LDY + c0;
    float x[DL];
#pragma unroll
    for (int c = 0; c < DL; ++c) x[c] = __bfloat162float(xc[c * KV_LDX]);
    const float2 st = col_stats<D, 2>(x, eps, flag);
    float m1 = 0.f, m2 = 0.f;
    if (flag) {
#pragma unroll
      for (int c = 0; c < DL; ++c) {
        const float xh = (x[c] - st.x) * st.y;
        const float yg = dy[c] * __bfloat162float(gamma[c]);
        m1 += yg;
        m2 += yg * xh;
      }
      m1 += __shfl_xor_sync(~0u, m1, 1);
      m2 += __shfl_xor_sync(~0u, m2, 1);
      m1 /= D;
      m2 /= D;
    }
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      float dx = dy[c];
      if (flag) {
        const float xh = (x[c] - st.x) * st.y;
        dx = (dy[c] * __bfloat162float(gamma[c]) - m1 - xh * m2) * st.y;
        dy[c] *= xh;
      }
      xc[c * KV_LDX] = __float2bfloat16(dx);
    }
  }
  __syncthreads();
  if (threadIdx.x < D) {
    float cg = 0.f;
    if (flag)
      for (int r = 0; r < KV_TILE; ++r) cg += dys[r * LDY + threadIdx.x];
    float* pb =
        part + (((size_t)z * G + grp) * gridDim.x + blockIdx.x) * 2 * D;
    pb[threadIdx.x] = cg;  // zeros where the flag is off
    pb[D + threadIdx.x] = cb;
  }
  store_cols_tile<D, KV_TILE>((z ? dv : dk) + off, Lk, t0, xs, KV_LDX);
}

// The dgamma / dbeta of q, k and v from their per-block f32 partials,
// three jobs of one launch (ln_bwd.cuh:sum_partials), rounded to bf16.
__global__ void __launch_bounds__(256)
    flash_ln_bwd_sum_kernel(const PartialSums p) {
  sum_partials(p);
}

// The sums' jobs of a backward of G groups, Lq queries and Lk keys at
// head dim D: part_q [G * nqt][2][D] and part_kv [2][G * nkt][2][D] into
// dgb [6][D]; returns the tickets the jobs take.
inline int ln_bwd_sums(PartialSums& sums, int G, int Lq, int Lk, int D,
                       void* part_q, void* part_kv, void* dgb,
                       void* tickets) {
  const int nqt = (Lq + BW_T - 1) / BW_T, nkt = (Lk + KV_TILE - 1) / KV_TILE;
  float* pkv = (float*)part_kv;
  bf16* g6 = (bf16*)dgb;
  int jobs = 0, ticket = 0;
  add_tree_sum(sums, jobs, (float*)part_q, g6, G * nqt, 2L * D,
               (unsigned*)tickets, ticket);
  add_tree_sum(sums, jobs, pkv, g6 + 2 * D, G * nkt, 2L * D,
               (unsigned*)tickets, ticket);
  add_tree_sum(sums, jobs, pkv + (size_t)G * nkt * 2 * D, g6 + 4 * D,
               G * nkt, 2L * D, (unsigned*)tickets, ticket);
  return ticket;
}

// The five passes at head dim D (the entry point's arguments).
template <int D>
int launch_flash_ln_bwd(const void* q, const void* k, const void* v,
                        const void* gq, const void* bq, const void* gk,
                        const void* bk, const void* gv, const void* bv,
                        const void* oa, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* dgb, void* qn,
                        void* kn, void* vn, void* ld, void* part_q,
                        void* dk_part, void* dv_part, void* part_kv,
                        void* tickets, int ntickets, int G, int Lq, int Lk,
                        float scale, float eps, int fq, int fk, int fv,
                        int add_qn, int qps, cudaStream_t s) {
  PartialSums sums;
  if (ln_bwd_sums(sums, G, Lq, Lk, D, part_q, part_kv, dgb, tickets) >
      ntickets)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      launch_kv_norm<D>(k, v, gk, bk, gv, bv, kn, vn, G, Lk, eps, fk, fv, s);
  if (err != cudaSuccess) return (int)err;

  CUtensorMap mk, mv;
  if (make_tmap3_sw64(&mk, kn, G, Lk, D, BW_T) ||
      make_tmap3_sw64(&mv, vn, G, Lk, D, BW_T))
    return (int)cudaErrorInvalidValue;
  const int nqt = (Lq + BW_T - 1) / BW_T;
  constexpr int smem_dq = ln_dq_smem_bytes<D>();
  err = set_smem(flash_ln_bwd_dq_kernel<D>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  flash_ln_bwd_dq_kernel<D><<<dim3(nqt, G), BW_THREADS, smem_dq, s>>>(
      mk, mv, (const bf16*)q, (const bf16*)oa, (const bf16*)dout,
      (const float*)lse, (const bf16*)gq, (const bf16*)bq, (bf16*)qn,
      (float2*)ld, (bf16*)dq, (float*)part_q, Lq, Lk, nqt * BW_T, scale, eps,
      fq, add_qn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_dkv<D>(qn, dout, kn, vn, (const float2*)ld, (float*)dk_part,
                      (float*)dv_part, G, Lq, Lk, nqt * BW_T, qps, s);
  if (err != cudaSuccess) return (int)err;

  const int nsplit = (Lq + qps - 1) / qps;
  kv_vjp_kernel<D><<<dim3((Lk + KV_TILE - 1) / KV_TILE, G, 2), KV_THREADS, 0,
                     s>>>(
      (const float*)dk_part, (const float*)dv_part, (const bf16*)k,
      (const bf16*)v, (const bf16*)gk, (const bf16*)gv, (bf16*)dk, (bf16*)dv,
      (float*)part_kv, G, Lk, nsplit, eps, fk, fv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  flash_ln_bwd_sum_kernel<<<sums.start[SUM_JOBS], 256, 0, s>>>(sums);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// Shared memory of the dq kernel at head dim d (96 or 72; else -1), for
// the wrapper's plan to check its own against.
extern "C" int aicity_flash_ln_bwd_dq_smem_bytes(int d) {
  return d == 96   ? aicity::ln_dq_smem_bytes<96>()
         : d == 72 ? aicity::ln_dq_smem_bytes<72>()
                   : -1;
}

// The host-side plan of a backward of G groups, Lq queries, Lk keys at
// head dim d, for the wrapper to hold its own against: out[0] the keys a
// block of the K/V passes, out[1] the sums' blocks, out[2] their tickets.
extern "C" void aicity_flash_ln_bwd_plan(int G, int Lq, int Lk, int d,
                                         int* out) {
  using namespace aicity;
  PartialSums sums;
  out[0] = KV_TILE;
  out[2] = ln_bwd_sums(sums, G, Lq, Lk, d, nullptr, nullptr, nullptr,
                       nullptr);
  out[1] = sums.start[SUM_JOBS];
}

// q, k, v d-major [G, d, L] (d 96 or 72, Lq % 8 == 0), gamma / beta [d]
// each; oa (the forward's attention output before the residual) and dout
// [G, Lq, d] token rows; lse [G, Lq] f32. Outputs: dq, dk, dv d-major like
// q, k, v; dgb [6, d] (dgamma, dbeta of q, k, v) bf16. Scratch: qn
// [G, Lq, d], kn, vn [G, Lk, d] bf16; ld [G, Lqp] float2 (Lqp = Lq rounded
// up to 64), part_q [G * ceil(Lq / 64), 2, d], dk_part / dv_part [nsplit, G,
// Lk, d] with nsplit = ceil(Lq / qps) query splits of qps rows (a multiple
// of 64), and part_kv [2, G * ceil(Lk / 64), 2, d], all f32 (the sums
// overwrite part_q and part_kv); tickets: ntickets uint32 counters at zero,
// which the launch leaves at zero (aicity_flash_ln_bwd_plan says how many
// it takes).
extern "C" int aicity_flash_attention_ln_bwd(
    const void* q, const void* k, const void* v, const void* gq,
    const void* bq, const void* gk, const void* bk, const void* gv,
    const void* bv, const void* oa, const void* lse, const void* dout,
    void* dq, void* dk, void* dv, void* dgb, void* qn, void* kn, void* vn,
    void* ld, void* part_q, void* dk_part, void* dv_part, void* part_kv,
    void* tickets, int ntickets, int G, int Lq, int Lk, int d, float scale,
    float eps, int fq, int fk, int fv, int add_qn, int qps, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if ((d != BW_D && d != 72) || Lq % 8 || qps <= 0 || qps % BW_T)
    return (int)cudaErrorInvalidValue;
  if (G <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaSuccess;
  const auto launch =
      d == 72 ? launch_flash_ln_bwd<72> : launch_flash_ln_bwd<96>;
  return launch(q, k, v, gq, bq, gk, bk, gv, bv, oa, lse, dout, dq, dk, dv,
                dgb, qn, kn, vn, ld, part_q, dk_part, dv_part, part_kv,
                tickets, ntickets, G, Lq, Lk, scale, eps, fq, fk, fv, add_qn,
                qps, s);
}
