// The attention backward core for Hopper, shared by the plain backward
// (flash_attention.cu, PERF rows 3-4) and the fused-LN backward
// (flash_attention_ln_bwd.cu, row 7): the K/V loop of a 64-row dq tile
// (dq_tile_loop, with its TMA ring KvRing) and the dk/dv kernel over a
// 64-key tile with query splits into f32 partials (flash_bwd_dkv_kernel),
// both on wgmma, their streamed tiles loaded by TMA.
//
// Operand discipline, the Pallas kernels': the logits are f32 products of
// bf16(q * s) with k (so they match the saved lse); P and dS are rounded to
// bf16 for dv and dk; dq takes dS as the bf16 pair hi + lo (split_bf16) and
// is scaled by s in f32; no atomics: dk and dv are f32 partials per query
// split, summed in a fixed order, so the result does not depend on block
// order. The callers hand both pieces q already scaled, qs = bf16(q * s) as
// token rows (row 3's pre-pass, row 7's dq kernel), and every query row's
// (lse, delta = rowsum(dO * O)) as float2 rows padded to whole 64-row tiles
// with (+inf, 0), so rows past Lq get P = 0 and dS = 0.
//
// Layout: every operand tile is 64 token rows of the head dim 96, stored
// as three TMA boxes of [64 rows][32 columns] in the 64-byte swizzle (4 KB
// a box, 12 KB a tile). 96 is not a multiple of the 128-byte swizzle's
// 64-column atom; the 64-byte swizzle's atom (8 rows x 32 columns) serves
// both ways a product reads a tile without padding: K-major, the head dim
// the reduction (S = qs k^T and dP = dO v^T, and their transposes in the
// dk/dv kernel), two k16 steps a box; MN-major through wgmma's transpose
// bit, the tokens the reduction (dq += dS k, dv += P^T dO, dk += dS^T qs),
// three 32-column atoms along N, one box apart. The tensor maps are 3-D
// [G][L][96] (make_tmap3_sw64), so rows past L load as zero and never come
// from the next group.
//
// Blocks: one warpgroup (128 threads, one m64 tile of rows) a block, and
// two blocks an SM (__launch_bounds__(128, 2): up to 255 registers a
// thread, shared memory under half the SM's), so one block's exponentials
// run while the other's products are in flight. Thread 0 keeps TMA loads of
// the streamed tiles in flight through a ring of stages, each completed by
// an mbarrier; a block barrier after a tile's last product frees its stage
// for the load STAGES tiles on. Timed on an H100 against this layout
// (PERF.md): two warpgroups a block sharing the streamed tiles were barely
// faster at the large shapes and slower at the small ones, and issuing the
// next tile's logits ahead of the softmax in one warpgroup was slower; the
// dk/dv kernel's K and V as A fragments in registers (rather than in
// shared memory) were faster, and are kept.
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace aicity {

constexpr int BW_T = 64, BW_THREADS = 128, BW_D = 96;
constexpr int BW_BOX = BW_T * 64;    // one [64 rows][32 columns] box, bytes
constexpr int BW_TILE = 3 * BW_BOX;  // one [64][96] tile
constexpr int DQ_STAGES = 3;         // the plain dq kernel's K/V ring
constexpr int DQ_LN_STAGES = 2;      // the fused-LN dq kernel's (its LN
                                     // tiles take the rest of the room)
constexpr int DKV_STAGES = 3;        // the dk/dv kernel's (qs, dO) ring

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(((uintptr_t)p + 1023) &
                                          ~(uintptr_t)1023);
}

// Descriptors of step kk of a [64][96] tile: K-major (columns [16kk, 16kk +
// 16), box kk / 2) and MN-major (rows [16kk, 16kk + 16)).
__device__ __forceinline__ uint64_t tile_k(const unsigned char* tile,
                                           int kk) {
  return desc_sw64_k(tile + (kk >> 1) * BW_BOX) + 2 * (kk & 1);
}

__device__ __forceinline__ uint64_t tile_mn(const unsigned char* tile,
                                            int kk) {
  return desc_sw64_mn(tile + kk * 1024, BW_BOX);
}

// Rows [row0, row0 + 64) of group grp into a tile: three boxes, BW_TILE
// bytes completing on bar.
__device__ __forceinline__ void load_rows_tile(unsigned char* tile,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int row0,
                                               int grp) {
#pragma unroll
  for (int b = 0; b < 3; ++b)
    tma_load3(tile + b * BW_BOX, map, bar, 32 * b, row0, grp);
}

// (x0, x1) as packed bf16 hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y));
}

// The A fragments of step kk (columns [16kk, 16kk + 16)) of a 64 x 64 f32
// accumulator (WgmmaRS's layout) rounded to bf16: the next product's A.
__device__ __forceinline__ void acc_to_a(const float* d, int kk,
                                         uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(d[8 * kk + 2 * i],
                                               d[8 * kk + 2 * i + 1]);
}

// The A fragments of the 16 rows [r0 - g, r0 - g + 16) of a [rows][96]
// bf16 token-row matrix x (this lane's rows r0 and r0 + 8, columns 2t,
// 2t + 1 and 2t + 8, 2t + 9 of every 16), read from global memory; rows
// at or past `rows` as zeros.
__device__ __forceinline__ void rows_to_a(const bf16* x, int r0, int rows,
                                          int t, uint32_t (&a)[6][4]) {
  const bf16* p0 = x + (size_t)r0 * BW_D + 2 * t;
  const bf16* p1 = p0 + 8 * BW_D;
#pragma unroll
  for (int kk = 0; kk < 6; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = r0 + 8 * (i & 1) < rows;
      a[kk][i] = ok ? *reinterpret_cast<const uint32_t*>(
                          ((i & 1) ? p1 : p0) + 16 * kk + 8 * (i >> 1))
                    : 0u;
    }
}

// The K/V ring of a dq loop: STAGES stages of one K and one V tile of 64
// keys each (tiles, 1024-byte aligned), stage s completing on full[s].
template <int STAGES>
struct KvRing {
  unsigned char* tiles;
  uint64_t* full;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  int grp, ntiles;

  __device__ __forceinline__ unsigned char* k_tile(int s) const {
    return tiles + s * 2 * BW_TILE;
  }

  __device__ __forceinline__ void issue(int j) const {
    const int s = j % STAGES;
    mbar_arrive_expect_tx(&full[s], 2 * BW_TILE);
    load_rows_tile(k_tile(s), kmap, &full[s], j * BW_T, grp);
    load_rows_tile(k_tile(s) + BW_TILE, vmap, &full[s], j * BW_T, grp);
  }

  // The ring laid out at `base` (1024-byte aligned): the tiles, then the
  // barriers; ring_bytes() of shared memory.
  __host__ __device__ static constexpr int ring_bytes() {
    return STAGES * (2 * BW_TILE + 8);
  }

  __device__ __forceinline__ KvRing(unsigned char* base, const CUtensorMap* k,
                                    const CUtensorMap* v, int group, int Lk)
      : tiles(base),
        full(reinterpret_cast<uint64_t*>(base + STAGES * 2 * BW_TILE)),
        kmap(k), vmap(v), grp(group), ntiles((Lk + BW_T - 1) / BW_T) {}

  // Thread 0 sets up the barriers and puts the first STAGES tiles in
  // flight; the caller syncs the block before dq_tile_loop.
  __device__ __forceinline__ void start() const {
    if (threadIdx.x != 0) return;
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int j = 0; j < STAGES && j < ntiles; ++j) issue(j);
  }
};

// The K/V loop of a 64-row dq tile, one warpgroup (warp w owns rows 16w +
// g and 16w + g + 8 of the tile, g = lane / 4): for every 64-key tile of
// the ring, S = qs k^T and dP = dO v^T (wgmma m64n64k16, A from registers:
// qa holds the A fragments of qs, da those of dO), P = exp(S - lse), dS =
// P (dP - delta) in f32 (keys past Lk get P = 0), then acc += dS_hi k +
// dS_lo k (m64n96k16, A from registers, the K tile read MN-major). dS as a
// bf16 pair: dq = sum dS (k - mean k) cancels (each row of dS sums to
// zero), so one bf16 rounding of dS is amplified in dq; the second product
// keeps it near f32. acc is the m64n96 accumulator in WgmmaRS's layout
// (acc[j] holds columns 8j + 2t, 8j + 2t + 1 of rows g and g + 8), the
// layout of mma.sync's m16n8 tiles that the callers' epilogues read.
template <int STAGES>
__device__ __forceinline__ void dq_tile_loop(const uint32_t (&qa)[6][4],
                                             const uint32_t (&da)[6][4],
                                             const KvRing<STAGES>& ring,
                                             int Lk, float lse0, float lse1,
                                             float dl0, float dl1,
                                             float (&acc)[12][4]) {
  const int t = threadIdx.x & 3;
  float* d = &acc[0][0];
  for (int j = 0; j < ring.ntiles; ++j) {
    const int s = j % STAGES;
    const unsigned char* kt = ring.k_tile(s);
    const unsigned char* vt = kt + BW_TILE;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    mbar_wait(&ring.full[s], (j / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 6; ++kk) WgmmaRS<64>::mma(sc, qa[kk], tile_k(kt, kk));
#pragma unroll
    for (int kk = 0; kk < 6; ++kk) WgmmaRS<64>::mma(dp, da[kk], tile_k(vt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(dp);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * BW_T + 8 * jb + 2 * t + (e & 1);
        const float p =
            key < Lk ? __expf(sc[4 * jb + e] - (e < 2 ? lse0 : lse1)) : 0.f;
        sc[4 * jb + e] = p * (dp[4 * jb + e] - (e < 2 ? dl0 : dl1));  // dS
      }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], hi[kk][i],
                   lo[kk][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      WgmmaRS<96>::mma<1>(d, hi[kk], tile_mn(kt, kk));
      WgmmaRS<96>::mma<1>(d, lo[kk], tile_mn(kt, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<48>(d);
    fence_regs<16>(&hi[0][0]);
    fence_regs<16>(&lo[0][0]);
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && j + STAGES < ring.ntiles) ring.issue(j + STAGES);
  }
}

// Dynamic shared memory of the dk/dv kernel: alignment slack, the K and V
// tiles, the ring of (qs, dO) tiles with their (lse, delta) rows, the
// barriers.
template <int STAGES = DKV_STAGES>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 1024 + STAGES * (2 * BW_TILE + BW_T * 8) + STAGES * 8;
}

// dk / dv of a 64-key tile over the queries [split * qps, (split + 1) *
// qps) (qps a multiple of 64): the A fragments of the block's K and V rows
// stay in registers (rows past Lk as zeros); (qs, dO) tiles of 64 query
// rows stream through the ring with their (lse, delta) rows (one bulk copy
// from ld [G][Lqp]). Computed transposed, keys as rows: S^T = k qs^T and
// dP^T = v dO^T (wgmma m64n64k16, A from registers, B K-major), P^T =
// exp(S^T - lse), dS^T = P^T (dP^T - delta) in f32, then dv += bf16(P^T) dO
// and dk += bf16(dS^T) qs (m64n96k16, A from registers, B MN-major). Writes
// f32 partials [split][G][Lk][96]; rows past Lk are not written. (A
// template, on the ring's depth, so that both backwards' sources may
// instantiate it.)
template <int STAGES>
__global__ void __launch_bounds__(BW_THREADS, 2)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap dmap,
                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const float2* __restrict__ ld,
                         float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int G, int Lk, int Lqp,
                         int qps) {
  extern __shared__ unsigned char bw_smem_raw[];
  unsigned char* ring = align1024(bw_smem_raw);  // stage s: qs, dO tiles
  float2* lds = reinterpret_cast<float2*>(ring + STAGES * 2 * BW_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(lds + STAGES * BW_T);

  const int k0 = blockIdx.x * BW_T, grp = blockIdx.y, split = blockIdx.z;
  const int q0 = split * qps;
  const int ntq = (min(Lqp, q0 + qps) - q0) / BW_T;
  const float2* ldg = ld + (size_t)grp * Lqp;

  auto issue = [&](int i) {
    const int s = i % STAGES, row0 = q0 + i * BW_T;
    unsigned char* qt = ring + s * 2 * BW_TILE;
    mbar_arrive_expect_tx(&full[s], 2 * BW_TILE + BW_T * 8);
    load_rows_tile(qt, &qmap, &full[s], row0, grp);
    load_rows_tile(qt + BW_TILE, &dmap, &full[s], row0, grp);
    bulk_load(lds + s * BW_T, ldg + row0, BW_T * 8, &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int i = 0; i < STAGES && i < ntq; ++i) issue(i);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t ka[6][4], va[6][4];
  rows_to_a(k + (size_t)grp * Lk * BW_D, k0 + warp * 16 + g, Lk, t, ka);
  rows_to_a(v + (size_t)grp * Lk * BW_D, k0 + warp * 16 + g, Lk, t, va);
  float dka[48], dva[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) dka[i] = dva[i] = 0.f;
  __syncthreads();  // the ring's barriers are set up

  for (int i = 0; i < ntq; ++i) {
    const int s = i % STAGES;
    const unsigned char* qt = ring + s * 2 * BW_TILE;
    const unsigned char* dt = qt + BW_TILE;
    const float2* lt = lds + s * BW_T;
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    mbar_wait(&full[s], (i / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 6; ++kk) WgmmaRS<64>::mma(st, ka[kk], tile_k(qt, kk));
#pragma unroll
    for (int kk = 0; kk < 6; ++kk) WgmmaRS<64>::mma(dpt, va[kk], tile_k(dt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(st);
    fence_regs<32>(dpt);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const float2 l0 = lt[8 * jb + 2 * t], l1 = lt[8 * jb + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 l = (e & 1) ? l1 : l0;
        const float p = __expf(st[4 * jb + e] - l.x);
        st[4 * jb + e] = p;
        dpt[4 * jb + e] = p * (dpt[4 * jb + e] - l.y);  // dS^T
      }
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(st, kk, pa[kk]);
      acc_to_a(dpt, kk, sa[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      WgmmaRS<96>::mma<1>(dva, pa[kk], tile_mn(dt, kk));
      WgmmaRS<96>::mma<1>(dka, sa[kk], tile_mn(qt, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<48>(dva);
    fence_regs<48>(dka);
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&sa[0][0]);
    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0 && i + STAGES < ntq) issue(i + STAGES);
  }

  const size_t base = ((size_t)split * G + grp) * Lk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    if (key >= Lk) continue;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dk_part + (base + key) * BW_D + col) =
          make_float2(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dv_part + (base + key) * BW_D + col) =
          make_float2(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

// The dk/dv kernel's launch on a grid of (key tiles, G, query splits):
// the tensor maps of qs and dO ([G][Lq][96] token rows), K and V as token
// rows [G][Lk][96], ld with lqp rows a group.
inline cudaError_t launch_dkv(const void* qs, const void* dout,
                              const void* k, const void* v, const float2* ld,
                              float* dk_part, float* dv_part, int G, int Lq,
                              int Lk, int lqp, int qps, cudaStream_t stream) {
  CUtensorMap mq, md;
  if (make_tmap3_sw64(&mq, qs, G, Lq, BW_D, BW_T) ||
      make_tmap3_sw64(&md, dout, G, Lq, BW_D, BW_T))
    return cudaErrorInvalidValue;
  const int nsplit = (Lq + qps - 1) / qps;
  const cudaError_t err =
      set_smem(flash_bwd_dkv_kernel<DKV_STAGES>, dkv_smem_bytes());
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DKV_STAGES><<<dim3((Lk + BW_T - 1) / BW_T, G, nsplit),
                                     BW_THREADS, dkv_smem_bytes(), stream>>>(
      mq, md, (const bf16*)k, (const bf16*)v, ld, dk_part, dv_part, G, Lk,
      lqp, qps);
  return cudaGetLastError();
}

}  // namespace aicity
