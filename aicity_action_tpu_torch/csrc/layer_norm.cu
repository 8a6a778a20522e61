// Grouped LayerNorm for Hopper: the forward (row 12) and its backward (row
// 13), each in two instances.
//
// Replaces aicity_action_tpu/ops/pallas/layer_norm.py:_ln_fwd_kernel and
// _ln_bwd_kernel (fused_layer_norm and its custom VJP): each channel group
// of a row is normalized with f32 statistics (xc = x - mean, var =
// mean(xc^2)) and scaled by the shared gamma / beta, rounded to bf16; the
// backward gives dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
// with dxhat = dy gamma, and dgamma / dbeta summed over every row and group.
// A LayerNorm does ~2 flops a byte against the ~295 the card needs before
// its compute is the limit: it is bound by device memory, so the design
// moves each byte once.
//
// The rows instance ([M, C], groups of dg = C / groups channels, contiguous
// segments of dg): the final norm [B*1568, 768] (MViT-v2-L's [B*1568,
// 1152]), the cls-token models' pool norms (odd lengths 1 + L'), the pool
// norms of head dim 72 and MViT-v1's separate norm2. A segment is held in
// registers by the fewest lanes that cover it with three 16-byte vectors
// each (4 lanes for dg = 96, a warp for 768; past 768 the wide instances
// give a warp's lanes five each): one read of x, one
// write of y, statistics as every row LayerNorm of the port computes them
// (hopper.cuh:row_stats, ln_vec8). The forward launches one group of lanes a
// segment (no loop: registers stay few and blocks many, ~96 KB a SM in
// flight); the backward walks the segments with a persistent grid (one
// block of 12 warps an SM), keeps each lane's dgamma / dbeta sums in
// registers (the wide instance: in its warp's shared memory), joins them
// per block in a fixed order and writes one f32 slab a block.
//
// The channel-major instance (the v2 pool norms): the pool convolution
// leaves t [B, h*d, L] (d = 96, L % 8 == 0, no cls token), and the attention
// takes head-major rows [B*h, L, d]. The forward reads tiles of (group
// b*h + head, TL tokens) as TMA boxes [d][TL] of the [B*h*d, L] view
// through an mbarrier ring, normalizes each token over its d channels
// (flash_ln.cuh:norm_cols_to_rows, four lanes a token) into a staged
// [TL][d] tile, and writes it with one bulk copy (the tile's rows are
// contiguous in [B*h, L, d]). The backward reads the x box and the tile's
// dy rows by TMA in the 128-byte swizzle (64-token tiles), so that
// ldmatrix (.trans for x) gives each lane one token's channels 8m + 2q and
// + 1 of both without bank conflicts; it recomputes the statistics, stores
// dx through stmatrix.trans into a swizzled box and a TMA store in t's
// layout, the one the convolution's backward takes, and keeps each lane's
// dgamma / dbeta sums in registers across the block's tiles. Either way the
// [B, h*d, L] <-> [B*h, L, d] copies around the norm are gone. A ragged
// last tile loads zeros past L (TMA's fill), adds nothing to the sums and
// stores only its tokens.
//
// Both backwards sum their per-block slabs in the same launch, through a
// tree of tickets (counters the last taker leaves at 0 again): the last
// block of each group of 16 to finish sums the group's slabs, and the last
// of those the groups' sums (sum_slab_tree), each in a fixed order; so no
// sum's order depends on the order the blocks ran in, no second launch
// waits on the first, and no block sums more than a few slabs.
#include "flash_ln.cuh"
#include "hopper.cuh"

namespace aicity {

constexpr int LN_THREADS = 256;      // rows forward
constexpr int LN_BWD_THREADS = 384;  // rows backward: one block an SM
constexpr int LN_VPL = 3;            // 16-byte vectors a lane
constexpr int LN_WIDE_VPL = 5;       // the wide instances' (a warp a
                                     // segment past 768 channels)
constexpr int COL_D = 96;            // channel-major: channels a group
constexpr int COL_LANES = 4;         // lanes a token
constexpr int COL_THREADS = 256;
constexpr int COL_MAX_STAGES = 8;
// the backward's tile: 64 tokens, 128-byte rows of its swizzled boxes, 8
// tokens a warp
constexpr int COL_BWD_TILE = 64;
// barriers and gamma / beta ahead of the 1024-byte aligned boxes
constexpr int COL_HEAD = 1024;

// An x (or dx) box [COL_D][tile] and, for the backward, a dy box [tile][64]
// (its rows' channels 0-63 or 64-127, 96-127 zero).
__host__ __device__ inline int col_box_bytes(int tile) {
  return COL_D * tile * 2;
}
__host__ __device__ inline int dy_box_bytes() { return COL_BWD_TILE * 128; }

// Dynamic shared memory of a channel-major launch: 1024 bytes of alignment
// slack, the head, the ring (x boxes; the backward's also the tile's two dy
// boxes) and two staged output tiles.
__host__ __device__ inline int pool_norm_smem_bytes(int bwd, int tile,
                                                    int stages) {
  const int stage = col_box_bytes(tile) + (bwd ? 2 * dy_box_bytes() : 0);
  return 1024 + COL_HEAD + stages * stage + 2 * col_box_bytes(tile);
}

__host__ __device__ inline int rows_bwd_smem_bytes(int dg) {
  return (LN_BWD_THREADS / 32) * 2 * dg * 4;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(((uintptr_t)p + 1023) &
                                          ~(uintptr_t)1023);
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Blocks whose slabs one block of the group sums first (the slab tree).
constexpr int SLAB_GROUP = 16;

// The sum of nslab f32 slabs [nslab][n] (n % 4 == 0) by one block, into
// out: P = min(8, threads / (n / 4)) phases of threads each sum the slabs
// p, p + P, ... of four columns in order, then the phases in order (red:
// P * n floats of shared memory); with fewer threads than n / 4, a thread
// sums its columns over every slab in order. Out is f32 or, rounded, bf16.
template <class Out>
__device__ __forceinline__ void sum_slabs(const float* part, int nslab, int n,
                                          Out* out, float* red) {
  const int n4 = n / 4, T = blockDim.x, t = threadIdx.x;
  const int P = min(8, T / n4);
  const float4* p4 = reinterpret_cast<const float4*>(part);
  auto put = [&](int c4, float4 a) {
    if constexpr (sizeof(Out) == 2)
      reinterpret_cast<uint2*>(out)[c4] =
          make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
    else
      reinterpret_cast<float4*>(out)[c4] = a;
  };
  auto add = [](float4& a, float4 v) {
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  };
  if (P <= 1) {
    for (int c4 = t; c4 < n4; c4 += T) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < nslab; k += 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = k + u < nslab ? __ldcg(p4 + (size_t)(k + u) * n4 + c4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 4; ++u) add(a, v[u]);
      }
      put(c4, a);
    }
    return;
  }
  const int c4 = t % n4, ph = t / n4;
  if (ph < P) {
    // four slabs' loads in flight at a time, added in slab order
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = ph; k < nslab; k += 4 * P) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = k + u * P < nslab ? __ldcg(p4 + (size_t)(k + u * P) * n4 + c4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) add(a, v[u]);
    }
    reinterpret_cast<float4*>(red)[ph * n4 + c4] = a;
  }
  __syncthreads();
  if (t < n4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < P; ++k)
      add(a, reinterpret_cast<const float4*>(red)[k * n4 + t]);
    put(t, a);
  }
}

// Called by every thread of every block once its slab [n] is in part
// [gridDim.x][n]: the slab tree. The last block of each group of
// SLAB_GROUP blocks to finish sums the group's slabs into part2 [groups]
// [n]; the last of those sums part2 into out (bf16). Every sum's order is
// fixed by the grid. tickets: [0] the groups', [1 + j] group j's.
__device__ __forceinline__ void sum_slab_tree(const float* part,
                                              float* part2, int n, bf16* out,
                                              unsigned* tickets, float* red) {
  const int groups = (gridDim.x + SLAB_GROUP - 1) / SLAB_GROUP;
  const int j = blockIdx.x / SLAB_GROUP;
  const int members = min(SLAB_GROUP, (int)gridDim.x - SLAB_GROUP * j);
  if (!last_of(tickets + 1 + j, members)) return;
  sum_slabs(part + (size_t)SLAB_GROUP * j * n, members, n,
            part2 + (size_t)j * n, red);
  if (!last_of(tickets, groups)) return;
  sum_slabs(part2, groups, n, out, red);
}

// ------------------------------------------------------------- rows forward

// LANES lanes a segment of dg = 8 nv channels (nv <= VPL LANES), lane q
// holding vectors q + LANES i; every lane of the warp reaches the shuffles.
// VPL: LN_VPL, or LN_WIDE_VPL for segments past 768 channels (a warp of
// five vectors a lane: MViT-v2-L's final norm over 1152).
template <int LANES, int VPL = LN_VPL>
__global__ void __launch_bounds__(LN_THREADS)
    ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                   const bf16* __restrict__ beta, bf16* __restrict__ y,
                   long segments, int dg, float eps) {
  const int q = threadIdx.x & (LANES - 1), nv = dg / 8;
  const long seg = ((long)blockIdx.x * LN_THREADS + threadIdx.x) / LANES;
  const bool live = seg < segments;
  const size_t off = (size_t)(live ? seg : 0) * dg;
  uint4 v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = q + LANES * i;
    v[i] = live && c < nv ? load16(x + off + 8 * c)
                          : make_uint4(0u, 0u, 0u, 0u);
  }
  const float2 st = row_stats<LANES, VPL>(v, q, nv, dg, eps);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = q + LANES * i;
    if (c < nv)
      *reinterpret_cast<uint4*>(y + off + 8 * c) = ln_vec8(
          v[i], st.x, st.y, load16(gamma + 8 * c), load16(beta + 8 * c));
  }
}

// ------------------------------------------------------------ rows backward

// The backward over segments, grid-stride from this warp's first group of
// lanes (a loop that every lane of a warp runs alike); part [gridDim.x][2]
// [dg]: the block's dgamma, then dbeta sums, which the slab tree sums into
// dgb [2][dg]. VPL: LN_VPL, or LN_WIDE_VPL past 768 channels (MViT-v2-L's
// final norm over 1152), a warp a segment: there each lane adds its
// columns' dgamma / dbeta straight into its warp's sums in shared memory
// (no lane shares a column), where LN_VPL keeps them in registers (80 of
// them at five vectors would pass the 168 a thread of 384 gets).
template <int LANES, int VPL = LN_VPL>
__global__ void __launch_bounds__(LN_BWD_THREADS, 1)
    ln_rows_bwd_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ gamma,
                       const bf16* __restrict__ dy, bf16* __restrict__ dx,
                       float* __restrict__ part, float* __restrict__ part2,
                       bf16* __restrict__ dgb, unsigned* __restrict__ tickets,
                       long segments, int dg, float eps) {
  extern __shared__ __align__(16) float warp_sums[];  // [warps][2][dg]
  constexpr bool WIDE = VPL != LN_VPL;
  static_assert(!WIDE || LANES == 32, "the wide instance: a warp a segment");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & (LANES - 1), nv = dg / 8;
  const long groups = (long)gridDim.x * LN_BWD_THREADS / LANES;
  float* mine = warp_sums + warp * 2 * dg;
  uint4 gv[VPL];
  float ag[WIDE ? 1 : VPL][8], ab[WIDE ? 1 : VPL][8];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = q + LANES * i;
    gv[i] = c < nv ? load16(gamma + 8 * c) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (WIDE) {
      if (c < nv)
#pragma unroll
        for (int k = 0; k < 8; k += 4) {
          *reinterpret_cast<float4*>(mine + 8 * c + k) =
              make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(mine + dg + 8 * c + k) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) ag[i][k] = ab[i][k] = 0.f;
    }
  }
  for (long first = ((long)blockIdx.x * LN_BWD_THREADS + warp * 32) / LANES;
       first < segments; first += groups) {
    const long seg = first + lane / LANES;
    const bool live = seg < segments;
    const size_t off = (size_t)(live ? seg : 0) * dg;
    uint4 xv[VPL], dv[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = q + LANES * i;
      const bool in = live && c < nv;
      xv[i] = in ? load16(x + off + 8 * c) : make_uint4(0u, 0u, 0u, 0u);
      dv[i] = in ? load16(dy + off + 8 * c) : make_uint4(0u, 0u, 0u, 0u);
    }
    const float2 st = row_stats<LANES, VPL>(xv, q, nv, dg, eps);
    // xhat = (x - mean) rstd, e = dy gamma: the sums of e and e xhat, as
    // ln_bwd.cuh:ln_bwd_rows (the second pass recomputes both from the
    // packed registers rather than keep them)
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
      const uint32_t d[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
      const uint32_t g[4] = {gv[i].x, gv[i].y, gv[i].z, gv[i].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xs = k & 1 ? bf16_hi(w[k / 2]) : bf16_lo(w[k / 2]);
        const float ds = k & 1 ? bf16_hi(d[k / 2]) : bf16_lo(d[k / 2]);
        const float gs = k & 1 ? bf16_hi(g[k / 2]) : bf16_lo(g[k / 2]);
        const float xh = (xs - st.x) * st.y, e = ds * gs;
        p1 += e;
        p2 += e * xh;
      }
    }
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) {
      p1 += __shfl_xor_sync(~0u, p1, o);
      p2 += __shfl_xor_sync(~0u, p2, o);
    }
    const float m1 = p1 / dg, m2 = p2 / dg;
    // dx, and the lane's dgamma / dbeta (dy is zero where not live)
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = q + LANES * i;
      const uint32_t w[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
      const uint32_t d[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
      const uint32_t g[4] = {gv[i].x, gv[i].y, gv[i].z, gv[i].w};
      uint32_t o[4];
      float sg[WIDE ? 8 : 1], sb[WIDE ? 8 : 1];  // the wide instance's adds
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float r[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xs = h ? bf16_hi(w[e]) : bf16_lo(w[e]);
          const float ds = h ? bf16_hi(d[e]) : bf16_lo(d[e]);
          const float gs = h ? bf16_hi(g[e]) : bf16_lo(g[e]);
          const float xh = (xs - st.x) * st.y;
          r[h] = st.y * (ds * gs - m1 - xh * m2);
          if constexpr (WIDE) {
            sg[2 * e + h] = ds * xh;
            sb[2 * e + h] = ds;
          } else {
            ag[i][2 * e + h] += ds * xh;
            ab[i][2 * e + h] += ds;
          }
        }
        o[e] = pack_bf16(r[0], r[1]);
      }
      if constexpr (WIDE) {
        if (c < nv)
#pragma unroll
          for (int k = 0; k < 8; k += 4) {
            float4* pg = reinterpret_cast<float4*>(mine + 8 * c + k);
            float4* pb = reinterpret_cast<float4*>(mine + dg + 8 * c + k);
            const float4 a = *pg, b = *pb;
            *pg = make_float4(a.x + sg[k], a.y + sg[k + 1], a.z + sg[k + 2],
                              a.w + sg[k + 3]);
            *pb = make_float4(b.x + sb[k], b.y + sb[k + 1], b.z + sb[k + 2],
                              b.w + sb[k + 3]);
          }
      }
      if (live && c < nv)
        *reinterpret_cast<uint4*>(dx + off + 8 * c) =
            make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  if constexpr (!WIDE) {
    // the warp's groups of lanes in order of their bits, then the block's
    // warps in order: a fixed order
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int o = LANES; o < 32; o <<= 1) {
          ag[i][k] += __shfl_xor_sync(~0u, ag[i][k], o);
          ab[i][k] += __shfl_xor_sync(~0u, ab[i][k], o);
        }
    if (lane < LANES) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = q + LANES * i;
        if (c >= nv) continue;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          mine[8 * c + k] = ag[i][k];
          mine[dg + 8 * c + k] = ab[i][k];
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * dg; c += LN_BWD_THREADS) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < LN_BWD_THREADS / 32; ++w)
      total += warp_sums[w * 2 * dg + c];
    part[(size_t)blockIdx.x * 2 * dg + c] = total;
  }
  sum_slab_tree(part, part2, 2 * dg, dgb, tickets, warp_sums);
}

// ------------------------------------------------- the channel-major tiles

// A block's k-th tile of the queue (group, then TL-token runs) and the
// ring of TMA loads: stage s holds the x box [COL_D][TL] (and, for the
// backward, the tile's dy rows as two boxes [TL][64]); thread 0 starts the
// loads, the block's barrier after a tile frees its stage.
struct ColTiles {
  int L, tl, tiles_per_group, ntiles, stages;
  __device__ ColTiles(int groups, int L_, int tl_, int stages_)
      : L(L_), tl(tl_), tiles_per_group((L_ + tl_ - 1) / tl_),
        ntiles(groups * ((L_ + tl_ - 1) / tl_)), stages(stages_) {}
  __device__ int tile(int k) const { return blockIdx.x + k * gridDim.x; }
  __device__ int group(int t) const { return t / tiles_per_group; }
  __device__ int tok0(int t) const { return (t % tiles_per_group) * tl; }
  __device__ int tokens(int t) const { return min(tl, L - tok0(t)); }
};

struct ColSmem {
  uint64_t* full;     // [stages]
  bf16* params;       // gamma (and beta) [2][COL_D]
  unsigned char* ring;
  bf16* out;          // [2] staged output tiles
  int box_bytes, stage_bytes;
  __device__ ColSmem(unsigned char* raw, int tl, int stages, bool bwd) {
    unsigned char* base = align1024(raw);
    full = reinterpret_cast<uint64_t*>(base);
    params = reinterpret_cast<bf16*>(base + 64);
    ring = base + COL_HEAD;
    box_bytes = col_box_bytes(tl);
    stage_bytes = box_bytes + (bwd ? 2 * dy_box_bytes() : 0);
    out = reinterpret_cast<bf16*>(ring + stages * stage_bytes);
  }
  __device__ bf16* x_box(int s) const {
    return reinterpret_cast<bf16*>(ring + s * stage_bytes);
  }
  // dy box h (channels 64 h .. 64 h + 63) of stage s
  __device__ unsigned char* dy_box(int s, int h) const {
    return ring + s * stage_bytes + box_bytes + h * dy_box_bytes();
  }
  __device__ bf16* staged(int k) const {
    return reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(out) +
                                   (k & 1) * box_bytes);
  }
};

// Thread 0: the loads of the block's k-th tile into stage k % stages: the x
// box at (token l0, row group * COL_D) and, given dymap ([groups][L][COL_D]
// in boxes [TL][64], 128-byte swizzle), the tile's dy rows, channels 0-63
// and 64-127 (96-127 and tokens past L zero).
__device__ __forceinline__ void col_load(const ColTiles& ct,
                                          const ColSmem& sm,
                                          const CUtensorMap* xmap,
                                          const CUtensorMap* dymap, int k) {
  const int t = ct.tile(k);
  if (t >= ct.ntiles) return;
  const int s = k % ct.stages, g = ct.group(t), l0 = ct.tok0(t);
  mbar_arrive_expect_tx(&sm.full[s],
                        sm.box_bytes + (dymap ? 2 * dy_box_bytes() : 0));
  tma_load(sm.x_box(s), xmap, &sm.full[s], l0, g * COL_D);
  if (dymap)
    for (int h = 0; h < 2; ++h)
      tma_load3(sm.dy_box(s, h), dymap, &sm.full[s], 64 * h, l0, g);
}

// The forward: y [groups][L][COL_D] rows from the x boxes of the
// [groups * COL_D, L] view (xmap, box [COL_D][tl], no swizzle).
__global__ void __launch_bounds__(COL_THREADS)
    ln_cols_kernel(const __grid_constant__ CUtensorMap xmap,
                   const bf16* __restrict__ gamma,
                   const bf16* __restrict__ beta, bf16* __restrict__ y,
                   int groups, int L, int tl, int stages, float eps) {
  extern __shared__ unsigned char col_smem[];
  const ColTiles ct(groups, L, tl, stages);
  const ColSmem sm(col_smem, tl, stages, false);
  const int tid = threadIdx.x;
  if (tid < COL_D) {
    sm.params[tid] = gamma[tid];
    sm.params[COL_D + tid] = beta[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
    for (int k = 0; k < stages; ++k) col_load(ct, sm, &xmap, nullptr, k);
  }
  for (int k = 0; ct.tile(k) < ct.ntiles; ++k) {
    const int t = ct.tile(k), s = k % stages;
    bf16* o = sm.staged(k);
    if (tid == 0) bulk_wait_read<1>();  // tile k - 2's store has left o
    __syncthreads();
    mbar_wait(&sm.full[s], (k / stages) & 1);
    norm_cols_to_rows<COL_D, COL_LANES>(sm.x_box(s), tl, o, COL_D, tl,
                                        sm.params, sm.params + COL_D, eps, 1,
                                        tid, COL_THREADS);
    fence_proxy_async();  // the staged rows, visible to the bulk copy
    __syncthreads();      // (and stage s read: it may be refilled)
    if (tid == 0) {
      const int g = ct.group(t), l0 = ct.tok0(t);
      bulk_store(y + ((size_t)g * L + l0) * COL_D, o,
                 ct.tokens(t) * COL_D * 2);
      bulk_commit();
      col_load(ct, sm, &xmap, nullptr, k + stages);
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // the staged rows outlive the stores
}

// The backward: dx (dxmap: the view and box of xmap, which here reads x in
// the 128-byte swizzle, box [COL_D][64]) and the block's dgamma / dbeta slab
// part [gridDim.x][2][COL_D] from x and dy rows (dymap), summed by the slab
// tree into dgb. Warp w takes tokens [8w, 8w + 8) of a tile: ldmatrix.trans
// reads its x columns from the swizzled box and ldmatrix its dy rows, so
// that lane l holds token 8w + l / 4, channels 8m + 2 (l % 4) and + 1 (m =
// 0..11) of both, with no bank conflicts; stmatrix.trans stores dx back
// into a swizzled box for the TMA store. The lane's dgamma / dbeta sums
// stay on its channels.
__global__ void __launch_bounds__(COL_THREADS, 2)
    ln_cols_bwd_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap dymap,
                       const __grid_constant__ CUtensorMap dxmap,
                       const bf16* __restrict__ gamma,
                       float* __restrict__ part, float* __restrict__ part2,
                       bf16* __restrict__ dgb, unsigned* __restrict__ tickets,
                       int groups, int L, int stages, float eps) {
  extern __shared__ unsigned char col_smem[];
  constexpr int TL = COL_BWD_TILE, NM = COL_D / 8;  // 8-channel matrices
  const ColTiles ct(groups, L, TL, stages);
  const ColSmem sm(col_smem, TL, stages, true);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane & 7;  // the row this lane addresses in an ldmatrix
  if (tid < COL_D) sm.params[tid] = gamma[tid];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
    for (int k = 0; k < stages; ++k) col_load(ct, sm, &xmap, &dymap, k);
  }
  const uint32_t* gw = reinterpret_cast<const uint32_t*>(sm.params);
  float ag[NM][2], ab[NM][2];
#pragma unroll
  for (int m = 0; m < NM; ++m) ag[m][0] = ag[m][1] = ab[m][0] = ab[m][1] = 0.f;
  for (int k = 0; ct.tile(k) < ct.ntiles; ++k) {
    const int t = ct.tile(k), s = k % stages;
    unsigned char* o = reinterpret_cast<unsigned char*>(sm.staged(k));
    if (tid == 0) bulk_wait_read<1>();  // tile k - 2's store has left o
    __syncthreads();
    mbar_wait(&sm.full[s], (k / stages) & 1);
    // x box row c (a channel), the 16 bytes of this warp's 8 tokens
    const unsigned char* xs =
        reinterpret_cast<const unsigned char*>(sm.x_box(s));
    auto x_row = [&](int c) { return c * 128 + ((warp ^ (c & 7)) << 4); };
    uint32_t xw[NM], dw[NM];
#pragma unroll
    for (int j = 0; j < NM / 4; ++j) {
      const int m = 4 * j + (lane >> 3);  // this lane's matrix of the four
      ldmatrix_x4<true>(xw + 4 * j, xs + x_row(8 * m + r));
      // dy box row 8 warp + r (a token), its channels [8m, 8m + 8)
      ldmatrix_x4<false>(dw + 4 * j, sm.dy_box(s, m >> 3) +
                                         (8 * warp + r) * 128 +
                                         (((m & 7) ^ r) << 4));
    }
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) sum += bf16_lo(xw[m]) + bf16_hi(xw[m]);
    sum += __shfl_xor_sync(~0u, sum, 1);
    sum += __shfl_xor_sync(~0u, sum, 2);
    const float mean = sum / COL_D;
    float sq = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float a = bf16_lo(xw[m]) - mean, b = bf16_hi(xw[m]) - mean;
      sq += a * a + b * b;
    }
    sq += __shfl_xor_sync(~0u, sq, 1);
    sq += __shfl_xor_sync(~0u, sq, 2);
    const float rstd = rsqrtf(sq / COL_D + eps);
    // each pass converts x and dy from the packed words again (the fences
    // keep no f32 copies alive between passes: registers, not spills)
    fence_regs<NM>(xw);
    // xhat, e = dy gamma: the sums of e and e xhat, and the lane's dgamma /
    // dbeta (tokens past L load zero dy, so add nothing)
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const uint32_t g2 = gw[4 * m + (lane & 3)];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float xh =
            ((h ? bf16_hi(xw[m]) : bf16_lo(xw[m])) - mean) * rstd;
        const float ds = h ? bf16_hi(dw[m]) : bf16_lo(dw[m]);
        const float e = ds * (h ? bf16_hi(g2) : bf16_lo(g2));
        p1 += e;
        p2 += e * xh;
        ag[m][h] += ds * xh;
        ab[m][h] += ds;
      }
    }
    p1 += __shfl_xor_sync(~0u, p1, 1);
    p1 += __shfl_xor_sync(~0u, p1, 2);
    p2 += __shfl_xor_sync(~0u, p2, 1);
    p2 += __shfl_xor_sync(~0u, p2, 2);
    const float m1 = p1 / COL_D, m2 = p2 / COL_D;
    fence_regs<NM>(xw);
    fence_regs<NM>(dw);
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const uint32_t g2 = gw[4 * m + (lane & 3)];
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float xh =
            ((h ? bf16_hi(xw[m]) : bf16_lo(xw[m])) - mean) * rstd;
        const float e = (h ? bf16_hi(dw[m]) : bf16_lo(dw[m])) *
                        (h ? bf16_hi(g2) : bf16_lo(g2));
        v[h] = rstd * (e - m1 - xh * m2);
      }
      xw[m] = pack_bf16(v[0], v[1]);  // dx, in x's place
    }
#pragma unroll
    for (int j = 0; j < NM / 4; ++j)
      stmatrix_x4<true>(o + x_row(8 * (4 * j + (lane >> 3)) + r), xw + 4 * j);
    fence_proxy_async();  // the staged dx box, visible to TMA
    __syncthreads();      // (and stage s read: it may be refilled)
    if (tid == 0) {
      // columns past L are not written
      tma_store(&dxmap, o, ct.tok0(t), ct.group(t) * COL_D);
      bulk_commit();
      col_load(ct, sm, &xmap, &dymap, k + stages);
    }
  }
  // the block's slab: every lane's 48 sums go to the ring (every load has
  // been consumed; [warp][48][36] f32, padded so that neither the stores
  // nor the loads below conflict), then thread v adds value v's 64 sums,
  // warps in order, each warp's eight tokens in order
  float* sums = reinterpret_cast<float*>(sm.ring);
  {
    float* mine = sums + warp * 48 * 36 + lane;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mine[(2 * m + h) * 36] = ag[m][h];
        mine[(24 + 2 * m + h) * 36] = ab[m][h];
      }
  }
  __syncthreads();
  if (tid < 2 * COL_D) {  // value v: dgamma (v < 96) or dbeta of channel c
    const int c = tid % COL_D, q = (c & 7) >> 1;
    const int slot = (tid / COL_D) * 24 + 2 * (c >> 3) + (c & 1);
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < COL_THREADS / 32; ++w)
#pragma unroll
      for (int tk = 0; tk < 8; ++tk)
        total += sums[(w * 48 + slot) * 36 + 4 * tk + q];
    part[(size_t)blockIdx.x * 2 * COL_D + tid] = total;
  }
  __syncthreads();  // sums read: the ring takes sum_slabs' phases
  sum_slab_tree(part, part2, 2 * COL_D, dgb, tickets, sums);
  if (tid == 0) bulk_wait_read<0>();  // the staged boxes outlive the stores
}

// The x (or dx) view [groups * COL_D, L] of a channel-major tensor, in
// boxes [COL_D][tl]: unswizzled (the forward's), or in the 128-byte swizzle
// (tl = 64: the backward's).
inline int col_tmap(CUtensorMap* map, const void* base, int groups, int L,
                    int tl, bool swizzled) {
  return swizzled
             ? make_tmap(map, base, (uint64_t)groups * COL_D, L, L, COL_D)
             : make_tmap(map, base, (uint64_t)groups * COL_D, L, L, COL_D,
                         tl);
}

// dy [groups][L][COL_D] in boxes [COL_BWD_TILE tokens][64 channels] of one
// group, 128-byte swizzle; tokens past L and channels past COL_D load zero.
inline int dy_tmap(CUtensorMap* map, const void* base, int groups, int L) {
  EncodeTiledFn enc = encode_tiled_fn();
  if (!enc || (uintptr_t)base % 16) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)COL_D, (cuuint64_t)L,
                              (cuuint64_t)groups};
  const cuuint64_t strides[2] = {COL_D * 2, (cuuint64_t)L * COL_D * 2};
  const cuuint32_t box[3] = {64, COL_BWD_TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline bool col_plan_ok(int groups, int d, int L, int tl, int stages,
                        int blocks) {
  return d == COL_D && groups > 0 && L > 0 && L % 8 == 0 && tl > 0 &&
         tl % 8 == 0 && tl <= 256 && stages > 0 &&
         stages <= COL_MAX_STAGES && blocks > 0;
}

}  // namespace aicity

using namespace aicity;

// Dynamic shared memory of a launch: kind 0 the rows backward (dg), 1 the
// channel-major forward, 2 its backward (tile, stages).
extern "C" int aicity_layer_norm_smem_bytes(int kind, int dg, int tile,
                                            int stages) {
  return kind == 0 ? rows_bwd_smem_bytes(dg)
                   : pool_norm_smem_bytes(kind == 2, tile, stages);
}

// The rows forward: y = LN(x) over groups of dg = cols / groups channels,
// `lanes` lanes a segment (4, 8, 16 or 32, with dg <= 24 lanes * 8; or 32
// lanes of LN_WIDE_VPL vectors for dg up to 1280), in `blocks` blocks of
// 256 threads (plan: ops/layer_norm.py:_ln_plan).
extern "C" int aicity_layer_norm(const void* x, const void* gamma,
                                 const void* beta, void* y, long rows,
                                 int cols, int groups, int lanes, int blocks,
                                 float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (groups < 1 || cols % groups) return (int)cudaErrorInvalidValue;
  const int dg = cols / groups;
  const long segments = rows * groups;
  const bool wide = lanes == 32 && dg > 8 * LN_VPL * lanes;
  if (dg % 8 || dg > 8 * (wide ? LN_WIDE_VPL : LN_VPL) * lanes ||
      blocks < 1 || (long)blocks * (LN_THREADS / lanes) < segments)
    return (int)cudaErrorInvalidValue;
#define AICITY_LN_ROWS(...)                                                  \
  ln_rows_kernel<__VA_ARGS__><<<blocks, LN_THREADS, 0, s>>>(                 \
      (const bf16*)x, (const bf16*)gamma, (const bf16*)beta, (bf16*)y,       \
      segments, dg, eps)
  switch (wide ? 0 : lanes) {
    case 0: AICITY_LN_ROWS(32, LN_WIDE_VPL); break;
    case 4: AICITY_LN_ROWS(4); break;
    case 8: AICITY_LN_ROWS(8); break;
    case 16: AICITY_LN_ROWS(16); break;
    case 32: AICITY_LN_ROWS(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef AICITY_LN_ROWS
  return (int)cudaGetLastError();
}

// The rows backward: dx [rows, cols]; dgb [2, dg] bf16 (dgamma, then dbeta);
// part [blocks + ceil(blocks / 16)][2][dg] f32 scratch; tickets: 1 +
// ceil(blocks / 16) unsigned counters at 0 that no other launch uses at the
// same time (the launch leaves them at 0); `blocks` persistent blocks of
// 384 threads; `lanes` as the forward's (32 lanes of LN_WIDE_VPL vectors
// for dg up to 1280).
extern "C" int aicity_layer_norm_bwd(const void* x, const void* gamma,
                                     const void* dy, void* dx, void* dgb,
                                     void* part, void* tickets, long rows,
                                     int cols, int groups, int lanes,
                                     int blocks, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (groups < 1 || cols % groups) return (int)cudaErrorInvalidValue;
  const int dg = cols / groups;
  const bool wide = lanes == 32 && dg > 8 * LN_VPL * lanes;
  if (dg % 8 || dg > 8 * (wide ? LN_WIDE_VPL : LN_VPL) * lanes || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long segments = rows * groups;
  const int smem = rows_bwd_smem_bytes(dg);
  cudaError_t err = cudaSuccess;
#define AICITY_LN_ROWS_BWD(...)                                              \
  err = set_smem(ln_rows_bwd_kernel<__VA_ARGS__>, smem);                     \
  if (err == cudaSuccess) {                                                  \
    ln_rows_bwd_kernel<__VA_ARGS__><<<blocks, LN_BWD_THREADS, smem, s>>>(    \
        (const bf16*)x, (const bf16*)gamma, (const bf16*)dy, (bf16*)dx,      \
        (float*)part, (float*)part + (size_t)blocks * 2 * dg, (bf16*)dgb,     \
        (unsigned*)tickets, segments, dg, eps);                              \
    err = cudaGetLastError();                                                \
  }
  switch (wide ? 0 : lanes) {
    case 0: AICITY_LN_ROWS_BWD(32, LN_WIDE_VPL); break;
    case 4: AICITY_LN_ROWS_BWD(4); break;
    case 8: AICITY_LN_ROWS_BWD(8); break;
    case 16: AICITY_LN_ROWS_BWD(16); break;
    case 32: AICITY_LN_ROWS_BWD(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef AICITY_LN_ROWS_BWD
  return (int)err;
}

// The channel-major forward: t [groups * d, L] (the pool convolution's
// [B, h*d, L], groups = B*h, d = 96, L % 8 == 0) -> y [groups][L][d] rows,
// tiles of `tile` tokens through a ring of `stages`, `blocks` persistent
// blocks of 256 threads.
extern "C" int aicity_pool_norm(const void* t, const void* gamma,
                                const void* beta, void* y, int groups, int d,
                                int L, int tile, int stages, int blocks,
                                float eps, void* stream) {
  if (!col_plan_ok(groups, d, L, tile, stages, blocks))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  int err = col_tmap(&xmap, t, groups, L, tile, false);
  if (err) return err;
  const int smem = pool_norm_smem_bytes(0, tile, stages);
  cudaError_t e = set_smem(ln_cols_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ln_cols_kernel<<<blocks, COL_THREADS, smem, (cudaStream_t)stream>>>(
      xmap, (const bf16*)gamma, (const bf16*)beta, (bf16*)y, groups, L, tile,
      stages, eps);
  return (int)cudaGetLastError();
}

// The channel-major backward: dx [groups * d, L] (t's layout) from t and
// dy [groups][L][d] rows; dgb [2, d] bf16; part and tickets as
// aicity_layer_norm_bwd's (dg = d).
extern "C" int aicity_pool_norm_bwd(const void* t, const void* gamma,
                                    const void* dy, void* dx, void* dgb,
                                    void* part, void* tickets, int groups,
                                    int d, int L, int tile, int stages,
                                    int blocks, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!col_plan_ok(groups, d, L, tile, stages, blocks) ||
      tile != COL_BWD_TILE)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, dymap, dxmap;
  int err = col_tmap(&xmap, t, groups, L, tile, true);
  if (!err) err = dy_tmap(&dymap, dy, groups, L);
  if (!err) err = col_tmap(&dxmap, dx, groups, L, tile, true);
  if (err) return err;
  const int smem = pool_norm_smem_bytes(1, tile, stages);
  cudaError_t e = set_smem(ln_cols_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ln_cols_bwd_kernel<<<blocks, COL_THREADS, smem, s>>>(
      xmap, dymap, dxmap, (const bf16*)gamma, (float*)part,
      (float*)part + (size_t)blocks * 2 * COL_D, (bf16*)dgb,
      (unsigned*)tickets, groups, L, stages, eps);
  return (int)cudaGetLastError();
}
