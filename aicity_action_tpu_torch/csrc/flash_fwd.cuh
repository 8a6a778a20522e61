// The attention forward core for Hopper, shared by the plain forward
// (flash_attention.cu: flash_fwd_kernel, PERF rows 1, 2 and 4's forward)
// and the fused-LN forward (flash_attention_ln.cu: flash_ln_kernel, rows 5
// and 6): a block owns 128 query rows and streams 64-key K/V tiles
// through a TMA ring under the running max and sum of online softmax, on
// wgmma.
//
// Operand discipline, the Pallas kernels': the logits are f32 products of
// bf16(q * s) with k; P is rounded to bf16 for the product with V while
// its row sum l stays f32; out = bf16(acc / l), lse = m + log l. exp(S - m)
// runs as ex2(S log2e - m log2e) (one FFMA and the MUFU's ex2): the f32
// logits are the Pallas kernel's, only the exponential's argument moves by
// an f32 rounding.
//
// Why 128 rows a block: the forward does half the backward's products per
// K/V byte it streams, and every block re-reads its group's K and V from
// L2. At 64 rows a block that is 64 flop a byte of L2, ~15 TB/s at the
// bf16 peak, far above what the L2 gives; 128 rows halve it.
//
// Block: two consumer warpgroups and a producer warp, 288 threads, one
// block an SM. The producer warp's first thread keeps TMA loads of the K
// and V tiles in flight through a ring of FW_STAGES stages (full barrier:
// the stage's bytes landed; empty barrier: all eight consumer warps are
// done with it). The consumers (warps 0-3 and 4-7) own 64 query rows each
// and share every stage. Their loop is FlashAttention 3's: the logits of
// tile j are issued with the product P V of tile j - 1 behind them, so the
// softmax of tile j runs while P V is in flight, and one consumer's
// softmax runs under the other's products. (FlashAttention 3's ping-pong,
// the consumers taking turns to issue through two named barriers, read
// ~4% slower and is not kept.) A consumer's registers: the output rows
// (48), S (32), P of the tile before (16) and its query fragments (24).
//
// Why 64-key tiles and a producer warp (timed on an H100, PERF.md): nine
// warps put three on one of the SM's four sub-partitions, whose 16K
// registers cap every thread at 168, and a 128-key tile's S (64), P (32),
// output rows and query fragments spilled there, with a producer warp or
// with a producer warpgroup and setmaxnreg alike; without a producer (256
// threads, thread 0 refilling the ring) 128-key tiles fit in 194
// registers but ran ~9% slower than this design.
//
// The last key tile: where Lk leaves it at most 16 or 32 keys (v1's Lk =
// 393 leaves 9, v2's 1568 leaves 32), its logits and P V run at that
// width (fwd_tile_loop's LAST, a template argument: chosen behind a
// runtime branch, the narrow products left ptxas too few registers for
// the wgmma pipeline and it serialized every wgmma, ~40% slower). A
// persistent grid (a block an SM walking every 132nd query tile, the
// next tile's K/V and q loaded under this one's end) ran 7-10% slower at
// the 448 shapes and is not kept.
//
// Layout: a K or V tile is flash_bwd.cuh's: 64 token rows of the head dim
// 96 in three TMA boxes of [64 rows][32 columns] in the 64-byte swizzle,
// loaded through 3-D maps [G][Lk][96] (make_tmap3_sw64) so that keys past
// Lk load as zero (and are masked to -inf in the last tile) and never come
// from the next group. K is read K-major for S = qs K^T (wgmma m64n64k16,
// A from registers, tile_k), V MN-major through the transpose bit for O +=
// P V (m64n96k16, tile_mn). The epilogue stages each consumer's 64 output
// rows in shared memory and stores them with 16-byte vectors (the rows are
// 12 KB contiguous in global memory).
#pragma once

#include <math.h>

#include "flash_bwd.cuh"

namespace aicity {

constexpr int FW_ROWS = 128;     // query rows a block (two consumers of 64)
constexpr int FW_STAGES = 3;     // the K/V ring's depth (a K and a V tile)
constexpr int FW_THREADS = 288;  // two consumer warpgroups, a producer warp
constexpr int FW_LDS = 104;  // row stride (bf16) of a consumer's staging
                             // tile: 16-byte rows, conflict-free pairs
constexpr int FW_STAGE = 64 * FW_LDS * 2;
constexpr int FW_QRAW = 96 * 64 * 2;  // the fused LN's raw q tile: [96
                                      // channels][64 tokens], a TMA box
constexpr float FW_LOG2E = 1.4426950408889634f;

// Dynamic shared memory of a forward block: alignment slack, the K/V ring,
// each consumer's staging tile and raw d-major q tile (the fused LN's; the
// plain kernel leaves it unused), the ring's barriers and the raw q's.
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 1024 + FW_STAGES * 2 * BW_TILE + 2 * FW_STAGE + 2 * FW_QRAW +
         (2 * FW_STAGES + 1) * 8;
}
static_assert(fwd_smem_bytes() <= 227 * 1024,
              "a forward block's shared memory exceeds the SM's 227 KB");

// The K/V ring at a 1024-byte aligned base: stage s holds a K tile and a V
// tile; the consumers' tiles, then the barriers, come after the ring.
struct FwdRing {
  unsigned char* tiles;
  uint64_t* full;   // [FW_STAGES], one arrival (the producer's) + bytes
  uint64_t* empty;  // [FW_STAGES], one arrival per consumer warp
  uint64_t* qfull;  // the fused LN's raw q tiles landed
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  int grp, ntiles;

  __device__ __forceinline__ FwdRing(unsigned char* base,
                                     const CUtensorMap* k,
                                     const CUtensorMap* v, int group, int Lk)
      : tiles(base),
        full(reinterpret_cast<uint64_t*>(base + fwd_smem_bytes() - 1024 -
                                         (2 * FW_STAGES + 1) * 8)),
        empty(full + FW_STAGES), qfull(empty + FW_STAGES), kmap(k), vmap(v),
        grp(group),
        ntiles((Lk + BW_T - 1) / BW_T) {}

  // Consumer cw's staging tile (64 x FW_LDS bf16) and raw q tile ([96][64]
  // bf16, 1024-byte aligned).
  __device__ __forceinline__ bf16* staging(int cw) const {
    return reinterpret_cast<bf16*>(tiles + FW_STAGES * 2 * BW_TILE) +
           cw * 64 * FW_LDS;
  }
  __device__ __forceinline__ bf16* raw_q(int cw) const {
    return reinterpret_cast<bf16*>(tiles + FW_STAGES * 2 * BW_TILE +
                                   2 * FW_STAGE + cw * FW_QRAW);
  }

  __device__ __forceinline__ unsigned char* k_tile(int s) const {
    return tiles + s * 2 * BW_TILE;
  }
  __device__ __forceinline__ unsigned char* v_tile(int s) const {
    return k_tile(s) + BW_TILE;
  }

  // Thread 0, before the block's first barrier.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qfull, 1);
    mbar_fence_init();
  }

  // The producer warp's first thread: every K/V tile, each into the stage
  // that the consumers freed FW_STAGES tiles before.
  __device__ __forceinline__ void produce() const {
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % FW_STAGES, round = j / FW_STAGES;
      if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
      mbar_arrive_expect_tx(&full[s], 2 * BW_TILE);
      load_rows_tile(k_tile(s), kmap, &full[s], j * BW_T, grp);
      load_rows_tile(v_tile(s), vmap, &full[s], j * BW_T, grp);
    }
  }
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scales this lane's A fragments of token rows in place: bf16(x * s), as
// the Pallas kernels round the scaled queries.
__device__ __forceinline__ void scale_a(uint32_t (&a)[6][4], float scale) {
#pragma unroll
  for (int kk = 0; kk < 6; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(bf16_lo(a[kk][i]) * scale,
                           bf16_hi(a[kk][i]) * scale);
}

// The online softmax of key tile j, in place: S (64 x N f32 in WgmmaRS's
// layout; this lane's rows g and g + 8) becomes P = exp(S - m_new), keys
// past Lk masked to -inf where the tile runs past Lk (never a whole tile:
// every tile starts below Lk, so the running max never falls); m and this
// lane's partial row sums l move on, and al gets the factor the output
// rows take before this tile's P V. N: the tile's key columns in S, 64, or
// 16 or 32 for a last tile that holds no more keys (fwd_tile_loop).
template <int N>
__device__ __forceinline__ void fwd_softmax(float* s, int j, int Lk, int t,
                                            float (&m)[2], float (&l)[2],
                                            float (&al)[2]) {
  constexpr int NJ = N / 8;
  // keys this lane may keep in the tile: all but past Lk (a select, so
  // that no register of the next product is written on a divergent path)
  const int keep = Lk - j * BW_T - 2 * t;
  if ((j + 1) * BW_T > Lk)
#pragma unroll
    for (int jb = 0; jb < NJ; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * jb + e] = 8 * jb + (e & 1) < keep ? s[4 * jb + e] : -INFINITY;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jb = 0; jb < NJ; ++jb)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jb + e]);
  float nb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    al[h] = fast_exp2((m[h] - mn) * FW_LOG2E);  // 0 on the first tile
    m[h] = mn;
    nb[h] = -mn * FW_LOG2E;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int jb = 0; jb < NJ; ++jb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[4 * jb + e], FW_LOG2E, nb[e >> 1]));
      s[4 * jb + e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * al[h] + rs[h];
}

// S = qs K^T over the first N keys of the K tile kt (WgmmaRS<N>: the first
// N / 2 registers of s).
template <int N>
__device__ __forceinline__ void fwd_issue_s(float* s,
                                            const uint32_t (&qa)[6][4],
                                            const unsigned char* kt) {
#pragma unroll
  for (int kk = 0; kk < 6; ++kk)
    WgmmaRS<N>::mma(s, qa[kk], tile_k(kt, kk), kk > 0);
}

// acc += P V over the first N keys of the V tile vt (N / 16 steps).
template <int N>
__device__ __forceinline__ void fwd_issue_pv(float (&acc)[48],
                                             const uint32_t (&pa)[4][4],
                                             const unsigned char* vt) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    WgmmaRS<96>::mma<1>(acc, pa[kk], tile_mn(vt, kk));
}

// Output rows times al, skipped where no row of the warp's max moved.
__device__ __forceinline__ void fwd_rescale(float (&acc)[48],
                                            const float (&al)[2]) {
  if (__any_sync(~0u, al[0] != 1.f || al[1] != 1.f))
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] *= al[(i >> 1) & 1];
}

// One step of the loop at key tile j >= 1: its logits (N key columns, in
// s) issued with P V of the whole tile j - 1 (pa) behind them, the softmax
// of tile j while that product is in flight (al: the output rows' factor
// before the next P V), then tile j - 1's stage freed and P of tile j made
// A fragments in pa.
template <int N>
__device__ __forceinline__ void fwd_step(
    const uint32_t (&qa)[6][4], const FwdRing& ring, int Lk, int j,
    float (&acc)[48], float (&m)[2], float (&l)[2], float (&s)[BW_T / 2],
    uint32_t (&pa)[BW_T / 16][4], float (&al)[2]) {
  const int t = threadIdx.x & 3, lane = threadIdx.x & 31;
  const int sp = (j - 1) % FW_STAGES;
  mbar_wait(&ring.full[j % FW_STAGES], (j / FW_STAGES) & 1);
  fwd_rescale(acc, al);
  wgmma_fence();
  fwd_issue_s<N>(s, qa, ring.k_tile(j % FW_STAGES));
  wgmma_commit();
  fwd_issue_pv<BW_T>(acc, pa, ring.v_tile(sp));
  wgmma_commit();
  wgmma_wait<1>();  // S of tile j; P V of tile j - 1 still in flight
  fence_regs<BW_T / 2>(s);
  fwd_softmax<N>(s, j, Lk, t, m, l, al);
  wgmma_wait<0>();
  fence_regs<48>(acc);
  fence_regs<BW_T / 4>(&pa[0][0]);
  if (lane == 0) mbar_arrive(&ring.empty[sp]);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) acc_to_a(s, kk, pa[kk]);
}

// The K/V loop of one consumer's 64 query rows (qa: their A fragments,
// already scaled). acc (WgmmaRS's m64n96 layout: acc[4j + e], columns 8j +
// 2t + (e & 1), row g for e < 2 and g + 8 else) gets sum P V unnormalized,
// m the rows' max and l this lane's partial row sums. The logits of tile j
// are issued with P V of tile j - 1 behind them; the softmax of tile j
// runs while that product is in flight. LAST: the key columns of the last
// tile's products, 16 or 32 where Lk leaves it no more keys past whole
// tiles (the launch picks it; then Lk > 64), else 64. Which width runs is
// fixed at compile time: a wgmma under a runtime branch makes ptxas
// serialize every wgmma of the loop.
template <int LAST>
__device__ __forceinline__ void fwd_tile_loop(const uint32_t (&qa)[6][4],
                                              const FwdRing& ring, int Lk,
                                              float (&acc)[48],
                                              float (&m)[2], float (&l)[2]) {
  const int t = threadIdx.x & 3, lane = threadIdx.x & 31;
  const int ntiles = ring.ntiles;
  float s[BW_T / 2];
  uint32_t pa[BW_T / 16][4];
  float al[2];
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  mbar_wait(&ring.full[0], 0);
  wgmma_fence();
  fwd_issue_s<BW_T>(s, qa, ring.k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<BW_T / 2>(s);
  fwd_softmax<BW_T>(s, 0, Lk, t, m, l, al);
#pragma unroll
  for (int kk = 0; kk < BW_T / 16; ++kk) acc_to_a(s, kk, pa[kk]);
  const int jend = LAST == BW_T ? ntiles : ntiles - 1;
  for (int j = 1; j < jend; ++j)
    fwd_step<BW_T>(qa, ring, Lk, j, acc, m, l, s, pa, al);
  if constexpr (LAST < BW_T)
    fwd_step<LAST>(qa, ring, Lk, ntiles - 1, acc, m, l, s, pa, al);
  fwd_rescale(acc, al);
  wgmma_fence();
  fwd_issue_pv<LAST>(acc, pa, ring.v_tile((ntiles - 1) % FW_STAGES));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<48>(acc);
  fence_regs<BW_T / 4>(&pa[0][0]);
  if (lane == 0) mbar_arrive(&ring.empty[(ntiles - 1) % FW_STAGES]);
}

// The last key tile's product width (fwd_tile_loop's LAST) for Lk keys:
// the fewest of 16 or 32 columns that hold the keys past whole tiles, else
// 64 (whole tiles, more than 32 keys left, or a single tile).
inline int fwd_last_width(int Lk) {
  const int r = Lk % BW_T;
  return Lk <= BW_T || r == 0 || r > 32 ? BW_T : r <= 16 ? 16 : 32;
}

// Rows [row0, row0 + 64) of a group's [L][96] bf16 output from a
// consumer's staging tile, 16 bytes a thread at a time (the rows are 12 KB
// contiguous in global memory); rows at or past L are not written. wt: the
// thread's index in its warpgroup; the caller syncs the warpgroup before.
__device__ __forceinline__ void fwd_store_rows(bf16* out, int row0, int L,
                                               const bf16* st, int wt) {
  for (int c = wt; c < 64 * 12; c += 128) {
    const int r = c / 12, c8 = (c - r * 12) * 8;
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * BW_D + c8) =
          *reinterpret_cast<const uint4*>(st + r * FW_LDS + c8);
  }
}

// Where a consumer's epilogue writes, per group: out [L][96]; oa, the
// output before the residual, [L][96] or null; lse [L] f32 or null; with
// add_rows, out = bf16(bf16(acc / l) + the rows the staging tile holds).
struct FwdOut {
  bf16* out;
  bf16* oa;
  float* lse;
  bool add_rows;
};

// The end of consumer cw's rows [row0, row0 + 64): l summed over each
// row's four lanes, lse = m + log l, y = bf16(acc / l) (and the residual)
// staged in st (its 64 x FW_LDS bf16 tile) and stored by fwd_store_rows.
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[48],
                                             const float (&m)[2],
                                             float (&l)[2], bf16* st,
                                             int row0, int L, int cw,
                                             const FwdOut& o) {
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;  // this lane's rows r and r + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(~0u, l[h], 1);
    l[h] += __shfl_xor_sync(~0u, l[h], 2);
  }
  if (o.lse != nullptr && t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row0 + r + 8 * h < L) o.lse[row0 + r + 8 * h] = m[h] + logf(l[h]);
  uint32_t y[12][2], z[12][2];
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      y[j][h] = pack_bf16(acc[4 * j + 2 * h] / l[h],
                          acc[4 * j + 2 * h + 1] / l[h]);
  uint32_t* p[2] = {reinterpret_cast<uint32_t*>(st + r * FW_LDS + 2 * t),
                    reinterpret_cast<uint32_t*>(st + (r + 8) * FW_LDS + 2 * t)};
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      z[j][h] = y[j][h];
      if (o.add_rows) {
        const uint32_t q = p[h][4 * j];
        z[j][h] = pack_bf16(bf16_lo(y[j][h]) + bf16_lo(q),
                            bf16_hi(y[j][h]) + bf16_hi(q));
      }
    }
  if (o.oa != nullptr) {
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) p[h][4 * j] = y[j][h];
    named_sync(3 + cw, 128);
    fwd_store_rows(o.oa, row0, L, st, wt);
    named_sync(3 + cw, 128);
  }
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) p[h][4 * j] = z[j][h];
  named_sync(3 + cw, 128);
  fwd_store_rows(o.out, row0, L, st, wt);
}

}  // namespace aicity
