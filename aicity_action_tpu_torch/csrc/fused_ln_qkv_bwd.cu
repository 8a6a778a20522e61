// Backward of the fused LayerNorm + qkv projection for Hopper:
// (q, k, v) = split(LN(x) W^T + b)  ->  dx, dW, db, dgamma, dbeta.
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_qkv_bwd_kernel
// (:175, reached through fused_ln_qkv's custom VJP, :285), which every MViT
// block runs in training. At 448 and batch 4 it sees x [M, D] with M from
// 401408 (blocks 0-1) down to 6272, D in {96, 192, 384, 768} and 3C in
// {288, ..., 2304} (MViT-v2-L: D in {144, 288, 576, 1152}, 3C in {432,
// ..., 3456}); the cls-token MViT-v1 adds odd token counts (1 + T*H*W).
// dxn = G W and dW = G^T xn are 4*M*D*3C flops against 2*M*(2D + 3C)
// bytes: the narrow blocks are bound by memory, the wide ones by the tensor
// cores.
//
// The Pallas kernel adds dW, db, dgamma and dbeta into blocks that stay
// resident across its sequential grid. Here every product runs once on the
// wgmma mainloop of hopper.cuh (TMA loads through an mbarrier ring, both
// operands K-major in shared memory), which takes operands in one layout
// only; the gradients of q, k, v arrive channel-major ([B, C, tokens] each,
// the forward's layout for the pool convolutions), so a pre-pass writes the
// copies the products read:
//  1. qkv_bwd_prep_kernel: W^T [D][3C] (the K-major operand of launch 2),
//     the LN statistics (mean, rstd) of every row and xn^T = bf16(LN(x))^T
//     channel-major ([D][ld], ld = M rounded up to 8 so that TMA's strides
//     are whole 16 bytes), transposed through shared memory;
//     qkv_bwd_grad_kernel: the gradients G, read once (16 bytes at a time
//     where tokens % 8 == 0, else one element at a time: odd token counts
//     are paid here only), into g [M][3C] token-major (transposed through
//     shared memory, stored by TMA) and, unless tokens % 64 == 0, gT
//     [3C][ld] (the clips side by side), and db = colsum(G) as per-block
//     partials (persistent blocks, so that they are few).
//  2. qkv_bwd_gemm_kernel: dxn [M, D] = g W, K = 3C, f32 out.
//  3. qkv_bwd_ln_kernel: the LN backward of each row (ln_bwd.cuh:
//     ln_bwd_rows, shared with the LN+MLP backward) from dxn and the
//     statistics -> dx; per block of rows the dgamma and dbeta partials.
//  4. split over K = M, dW [3C, D] = G^T xn, each split an f32 partial, B
//     xn^T: qkv_bwd_dw_kernel where tokens % 64 == 0 (every v2 shape but
//     block 15's), its A read in place from dq, dk, dv through TMA views
//     (a 64-token chunk lies in one clip), else qkv_bwd_gemm_kernel from gT.
// Every cross-block sum is a set of f32 partials summed in a fixed order
// (qkv_bwd_reduce_kernel, one launch; no atomics), rounded to bf16 at the
// end, as the Pallas wrapper rounds the gradients to the weights' compute
// type. Rounding points are the Pallas kernel's: xn bf16, dxn and every sum
// f32.
#include "ln_bwd.cuh"

namespace aicity {

// ------------------------------------------------ launch 1: the pre-passes

// The x tile [PREP_ROWS][D + 8] bf16.
__host__ __device__ inline int qkv_prep_smem_bytes(int D) {
  return PREP_ROWS * (D + 8) * 2;
}

// PREP_ROWS rows of x a block (ln_bwd.cuh:ln_prep_rows): the statistics,
// then xn^T; the blocks past ceil(M / PREP_ROWS) transpose the weight, a
// 32 x 32 tile each.
template <int VPL>
__global__ void __launch_bounds__(PREP_THREADS)
    qkv_bwd_prep_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta,
                        float2* __restrict__ stats, bf16* __restrict__ xnT,
                        const Transpose wt, int M, int D, int ld, float eps) {
  extern __shared__ __align__(16) unsigned char prep_smem[];
  bf16* tile = reinterpret_cast<bf16*>(prep_smem);
  const int blocks = (M + PREP_ROWS - 1) / PREP_ROWS;
  if ((int)blockIdx.x >= blocks) {
    transpose_tile(wt, blockIdx.x - blocks);
    return;
  }
  const int row0 = blockIdx.x * PREP_ROWS;
  ln_prep_rows<VPL>(x, gamma, beta, stats, tile, nullptr, row0, M, D, eps);
  __syncthreads();
  store_transposed(tile, D, xnT, ld, row0, M);
}

typedef void (*QkvPrepKernel)(const bf16*, const bf16*, const bf16*,
                              float2*, bf16*, const Transpose, int, int, int,
                              float);

// The gradients' pass: a block owns QKV_GC channels of the 3C (blockIdx.y)
// and walks 128-token tiles with a stride of gridDim.x. Where 3C is no
// multiple of 96 (RAGGED: MViT-v2-L's 3C = 432), the last chunk's channels
// past 3C read as zeros and are neither stored (TMA clips the box) nor
// summed into db. A tile lands in shared memory as [channel][token] (rows
// of 65 words: the token-major reads below are free of bank conflicts), is
// transposed into a dense [token][channel] box and leaves by one TMA store:
// whole lines of g, where 16-byte stores to 128 rows ran at a third of the
// card's bandwidth. Every load of a tile is issued before its first store.
constexpr int QKV_GC = 96, QKV_GT = 128, QKV_GRAD_THREADS = 256;
constexpr int QKV_GLD = QKV_GT + 2;

// The [channel][token] tile, then (1024-byte aligned) the [token][channel]
// box of g; the slack for the alignment.
__host__ __device__ inline int qkv_grad_smem_bytes() {
  return QKV_GC * QKV_GLD * 2 + 1024 + QKV_GT * QKV_GC * 2;
}

// Where token row r of gradient channel n (of the 3C) lies in dq, dk, dv
// [M / L, C, L]; next(s) steps to channel n + s (s < C), a division only
// for the first (the odd-token path's 48 loads a thread a tile).
struct GradRow {
  const bf16 *dq, *dk, *dv;
  const bf16* p;
  size_t off;  // token row r's offset within a channel-major tensor
  int C, L, which, c;

  __device__ __forceinline__ GradRow(const bf16* q, const bf16* k,
                                     const bf16* v, int n, int C_, int L_,
                                     int r)
      : dq(q), dk(k), dv(v), C(C_), L(L_) {
    const int b = r / L;
    off = (size_t)b * C * L + (r - b * L);
    which = n / C;
    c = n - which * C;
    p = base() + off + (size_t)c * L;
  }
  __device__ __forceinline__ const bf16* base() const {
    return which == 0 ? dq : (which == 1 ? dk : dv);
  }
  __device__ __forceinline__ void next(int s) {
    c += s;
    p += (size_t)s * L;
    if (c >= C) {
      c -= C;
      ++which;
      p = base() + off + (size_t)c * L;
    }
  }
};

// G from dq, dk, dv [M / L, C, L] into g [M][3C] token-major (map_g: boxes
// of QKV_GT rows x QKV_GC columns) and, unless gT is null, gT [3C][ld] (the
// clips side by side); and db's partials, db_part [gridDim.x][3C]: this
// block's column sums over its tiles, in order.
template <bool RAGGED>
__global__ void __launch_bounds__(QKV_GRAD_THREADS)
    qkv_bwd_grad_kernel(const __grid_constant__ CUtensorMap map_g,
                        const bf16* __restrict__ dq,
                        const bf16* __restrict__ dk,
                        const bf16* __restrict__ dv, bf16* __restrict__ gT,
                        float* __restrict__ db_part, int M, int C, int L,
                        int ld) {
  extern __shared__ __align__(16) unsigned char grad_smem[];
  unsigned short* tile = reinterpret_cast<unsigned short*>(grad_smem);
  unsigned char* box = reinterpret_cast<unsigned char*>(
      ((uintptr_t)(grad_smem + QKV_GC * QKV_GLD * 2) + 1023) &
      ~(uintptr_t)1023);
  uint32_t* tw = reinterpret_cast<uint32_t*>(tile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N3 = 3 * C, n0 = blockIdx.y * QKV_GC;
  unsigned short* gTu = reinterpret_cast<unsigned short*>(gT);
  const int tiles = (M + QKV_GT - 1) / QKV_GT;
  // db: threads 2ch and 2ch + 1 sum the first and second half of the
  // tokens of channel n0 + ch of each tile
  float dbacc = 0.f;
  for (int tix = blockIdx.x; tix < tiles; tix += gridDim.x) {
    const int row0 = tix * QKV_GT;
    if (L % 8 == 0) {
      // thread: channels tid / 16 + 16 k, tokens [8 (tid % 16), + 8) of the
      // tile (16 bytes within one clip, as L % 8 == 0; M % 8 == 0)
      constexpr int NV = QKV_GC / 16;
      const int run = tid & 15, r = row0 + 8 * run, b = r / L;
      const size_t off = (size_t)b * C * L + (r - b * L);
      uint4 v[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {  // (faster here than GradRow's steps)
        const int n = n0 + (tid >> 4) + 16 * k, which = n / C;
        v[k] = r < M && (!RAGGED || n < N3) ? *reinterpret_cast<const uint4*>(
                           (which == 0 ? dq : which == 1 ? dk : dv) + off +
                           (size_t)(n - which * C) * L)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int ch = (tid >> 4) + 16 * k;
        if (gTu != nullptr && r < M && (!RAGGED || n0 + ch < N3))
          *reinterpret_cast<uint4*>(gTu + (size_t)(n0 + ch) * ld + r) = v[k];
        uint32_t* d = tw + ch * (QKV_GLD / 2) + 4 * run;
        d[0] = v[k].x;
        d[1] = v[k].y;
        d[2] = v[k].z;
        d[3] = v[k].w;
      }
    } else {
      // odd token counts: thread: token tid % 128, channels tid / 128 + 2 k
      constexpr int NE = QKV_GC / 2;
      const int r = row0 + (tid & 127);
      GradRow src(dq, dk, dv, n0 + (tid >> 7), C, L, r);
      unsigned short v[NE];
#pragma unroll
      for (int k = 0; k < NE; ++k, src.next(2)) {
        const bool in = !RAGGED || n0 + (tid >> 7) + 2 * k < N3;
        v[k] = r < M && in ? *reinterpret_cast<const unsigned short*>(src.p)
                           : (unsigned short)0;
      }
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        const int ch = (tid >> 7) + 2 * k;
        if (gTu != nullptr && r < M && (!RAGGED || n0 + ch < N3))
          gTu[(size_t)(n0 + ch) * ld + r] = v[k];
        tile[ch * QKV_GLD + (tid & 127)] = v[k];
      }
    }
    if (tid == 0) bulk_wait_read();  // the last tile's store has left box
    __syncthreads();
    if (tid < 2 * QKV_GC) {  // warps 0-5, whole
      const uint32_t* p = tw + (tid >> 1) * (QKV_GLD / 2) + (QKV_GT / 4) *
                                                                (tid & 1);
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < QKV_GT / 4; ++k) s += bf16_lo(p[k]) + bf16_hi(p[k]);
      dbacc += s + __shfl_xor_sync(~0u, s, 1);
    }
    // the box: row t (a token) holds channels n0 .. + 96; a warp fills 8
    // tokens x 4 groups of 8 channels, a quarter-warp 2 tokens x 4 groups
    // (32 distinct banks)
#pragma unroll
    for (int k = 0; k < (QKV_GT / 8) * (QKV_GC / 32) / 8; ++k) {
      const int task = warp + 8 * k;
      const int t = 8 * (task % (QKV_GT / 8)) + 2 * (lane >> 3) +
                    ((lane >> 2) & 1);
      const int j = 4 * (task / (QKV_GT / 8)) + (lane & 3);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (uint32_t)tile[(8 * j + 2 * e) * QKV_GLD + t] |
               ((uint32_t)tile[(8 * j + 2 * e + 1) * QKV_GLD + t] << 16);
      *reinterpret_cast<uint4*>(box + t * (QKV_GC * 2) + 16 * j) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    fence_proxy_async();  // the box, visible to TMA
    __syncthreads();      // (and the tile read before the next one lands)
    if (tid == 0) {
      tma_store(&map_g, box, n0, row0);  // rows past M are not written
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_done();
  if (tid < 2 * QKV_GC && (tid & 1) == 0 &&
      (!RAGGED || n0 + (tid >> 1) < N3))
    db_part[(size_t)blockIdx.x * N3 + n0 + (tid >> 1)] = dbacc;
}

// ------------------------------ launches 2 and 4: the K-major mainloop

template <int TN>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    qkv_bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const DenseArgs args, float* out) {
  dense_block<TN, false>(map_a, map_b, args, F32Store{out});
}

// dW's A operand read in place where L % 64 == 0: rows n of the product are
// the 3C channels of the channel-major gradients (the forward's layout),
// through TMA views [B*C rows][L] of q, k, v, one 64-token chunk at a time
// (within one clip, as L % 64 == 0), in boxes of `box` rows (a multiple of
// 32 that divides C, so that a box lies in one of q, k, v) placed
// where one 128-row box would land, so that the 128-byte swizzle is the one
// wgmma expects. Rows past 3C are not loaded; their products are rows the
// epilogue drops.
struct ChannelMajorA {
  const CUtensorMap* maps;  // q, k, v
  int C, L, box;

  __device__ __forceinline__ int boxes(int row0) const {
    return min(DENSE_BM, 3 * C - row0) / box;
  }
  __device__ __forceinline__ uint32_t bytes(int row0) const {
    return boxes(row0) * box * 128;
  }
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int kc,
                                       int row0) const {
    const int m0 = kc * 64, b = m0 / L;
    for (int i = 0; i < boxes(row0); ++i) {
      const int n = row0 + box * i, which = n / C;
      tma_load(static_cast<unsigned char*>(dst) + i * box * 128, maps + which,
               bar, m0 - b * L, b * C + n - which * C);
    }
  }
};

template <int TN>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    qkv_bwd_dw_kernel(const __grid_constant__ QkvMaps maps,
                      const __grid_constant__ CUtensorMap map_b,
                      const DenseArgs args, int C, int L, int box,
                      float* out) {
  dense_block<TN, false>(ChannelMajorA{maps.m, C, L, box}, map_b, args,
                         F32Store{out});
}

// ------------------------------------------ launch 3: the LN backward

template <int NI>
__global__ void __launch_bounds__(LNB_THREADS)
    qkv_bwd_ln_kernel(const bf16* __restrict__ x,
                      const float2* __restrict__ stats,
                      const float* __restrict__ dxn,
                      const bf16* __restrict__ gamma,
                      const bf16* __restrict__ /*gout: none*/,
                      bf16* __restrict__ dx, float* __restrict__ part, int M,
                      int D, int rpb) {
  extern __shared__ __align__(16) float ln_sums[];
  ln_bwd_rows<NI, 2>(x, stats, dxn, gamma, nullptr, dx, part, M, D, rpb,
                     ln_sums);
}

// ------------------------------------------------------ the partial sums

__global__ void __launch_bounds__(256)
    qkv_bwd_reduce_kernel(const PartialSums p) {
  sum_partials(p);
}

// ------------------------------------------------------------- host side

inline cudaError_t launch_qkv_prep(const void* const* ptr, void* stats,
                                   void* xnT, const Transpose& wt, int M,
                                   int D, int ld, float eps, cudaStream_t s) {
  const QkvPrepKernel k = prep_kernel_for(
      [](int vpl) -> QkvPrepKernel {
        switch (vpl) {
          case 3: return qkv_bwd_prep_kernel<3>;
          case 6: return qkv_bwd_prep_kernel<6>;
          case 12: return qkv_bwd_prep_kernel<12>;
          case 24: return qkv_bwd_prep_kernel<24>;
          default: return qkv_bwd_prep_kernel<36>;
        }
      },
      D);
  const int smem = qkv_prep_smem_bytes(D);
  cudaError_t err = set_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<(M + PREP_ROWS - 1) / PREP_ROWS + transpose_tiles(wt), PREP_THREADS,
      smem, s>>>((const bf16*)ptr[0], (const bf16*)ptr[1],
                 (const bf16*)ptr[2], (float2*)stats, (bf16*)xnT, wt, M, D,
                 ld, eps);
  return cudaGetLastError();
}

template <int TN>
inline cudaError_t launch_qkv_gemm(const CUtensorMap& ma,
                                   const CUtensorMap& mb, const DenseArgs& a,
                                   float* out, int grid, cudaStream_t s) {
  static bool ready = false;
  cudaError_t err = prepare_dense(qkv_bwd_gemm_kernel<TN>, ready);
  if (err != cudaSuccess) return err;
  qkv_bwd_gemm_kernel<TN><<<grid, DENSE_THREADS,
                            dense_smem_bytes(TN, a.stages, a.K, false), s>>>(
      ma, mb, a, out);
  return cudaGetLastError();
}

template <int TN>
inline cudaError_t launch_qkv_dw(const QkvMaps& maps, const CUtensorMap& mb,
                                 const DenseArgs& a, int C, int L, int box,
                                 float* out, int grid, cudaStream_t s) {
  static bool ready = false;
  cudaError_t err = prepare_dense(qkv_bwd_dw_kernel<TN>, ready);
  if (err != cudaSuccess) return err;
  qkv_bwd_dw_kernel<TN><<<grid, DENSE_THREADS,
                          dense_smem_bytes(TN, a.stages, a.K, false), s>>>(
      maps, mb, a, C, L, box, out);
  return cudaGetLastError();
}

inline cudaError_t launch_qkv_gemm_tn(int tn, const CUtensorMap& ma,
                                      const CUtensorMap& mb,
                                      const DenseArgs& a, float* out,
                                      int grid, cudaStream_t s) {
  switch (tn) {
    case 128: return launch_qkv_gemm<128>(ma, mb, a, out, grid, s);
    case 192: return launch_qkv_gemm<192>(ma, mb, a, out, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace aicity

// Shared memory of a launch of the plan (ops/fused_dense.py:_qkv_bwd_plan):
// variant 1 a K-major GEMM (tn, stages), 2 the x pre-pass (D), 3 the
// gradients' pass.
extern "C" int aicity_ln_qkv_bwd_smem_bytes(int variant, int D, int tn,
                                            int stages) {
  using namespace aicity;
  switch (variant) {
    case 1: return dense_smem_bytes(tn, stages, 64, false);
    case 2: return qkv_prep_smem_bytes(D);
    default: return qkv_grad_smem_bytes();
  }
}

// ptr[]: the inputs x [M, D], gamma, beta [D], w [3C, D], dq, dk, dv
// [M / tokens, C, tokens] (the forward's channel-major layout); the outputs
// (bf16) dx [M, D], dw [3C, D], db [3C], dgb [2][D] (dgamma, dbeta); the
// scratch wt (W^T [D][3C]), stats [ceil(M / 128) * 128][2] f32, xnT
// [D][ld], g [M][3C], gT [3C][ld] (bf16; unused where tokens % 64 == 0:
// dW then reads dq, dk, dv in place), dxn [M, D] f32, and the f32 partials
// db [blocks1][3C], dgb [blocks3][2][D], dw [splits4][3C][D].
// plan[]: ld (M rounded up to 8), blocks1 (the gradients' pass: blocks over
// the tokens, each for every 96-channel chunk, the last ragged where 3C is
// no multiple of 96), tn2, stages2,
// grid2 (dxn), blocks3, rows3 (the LN backward), then for dW tn, stages,
// grid, splits, split_chunks (64-deep K chunks a split) and box: the rows
// of a box of its A read in place from dq, dk, dv (a multiple of 8 that
// divides C and 128; tokens % 64 == 0), or 0 for A from gT.
extern "C" int aicity_ln_qkv_bwd(const void* const* ptr, const int* plan,
                                 int M, int D, int C, int tokens, float eps,
                                 void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || D % 8 || D > DENSE_MAX_LN_K || C <= 0 || C % 8 ||
      tokens <= 0 || M % tokens)
    return (int)cudaErrorInvalidValue;
  const int N3 = 3 * C;
  const void* w = ptr[3];
  void *dx = (void*)ptr[7], *dw = (void*)ptr[8], *db = (void*)ptr[9],
       *dgb = (void*)ptr[10];
  void *wt = (void*)ptr[11], *stats = (void*)ptr[12], *xnT = (void*)ptr[13],
       *g = (void*)ptr[14], *gT = (void*)ptr[15], *dxn = (void*)ptr[16];
  float *db_part = (float*)ptr[17], *dgb_part = (float*)ptr[18],
        *dw_part = (float*)ptr[19];
  const int ld = plan[0], blocks1 = plan[1], tn2 = plan[2], stages2 = plan[3],
            grid2 = plan[4], blocks3 = plan[5], rows3 = plan[6];
  const int* pw = plan + 7;  // tn, stages, grid, splits, split_chunks
  const int box = plan[12];
  const bool in_place = box > 0;
  if (ld < M || ld % 8 || blocks1 < 1 || (long)blocks3 * rows3 < M ||
      (in_place && (tokens % 64 || C % box || box % 8 || DENSE_BM % box)))
    return (int)cudaErrorInvalidValue;

  // descriptors: g's stores, then dxn's operands and dW's (K-major;
  // columns past M load as zero): dW's A in place, views [B*C rows][tokens]
  // of dq, dk, dv, or the packed gT
  CUtensorMap m_gs, m_g, m_wt, m_gt, m_xnt;
  QkvMaps views;
  int err = make_tmap(&m_gs, g, M, N3, N3, QKV_GT, QKV_GC);
  if (!err) err = make_tmap(&m_g, g, M, N3, N3, DENSE_BM);
  if (!err) err = make_tmap(&m_wt, wt, D, N3, N3, tn2);
  for (int i = 0; i < 3 && !err && in_place; ++i)
    err = make_tmap(&views.m[i], ptr[4 + i], (uint64_t)(M / tokens) * C,
                    tokens, tokens, box);
  if (!err && !in_place) err = make_tmap(&m_gt, gT, N3, M, ld, DENSE_BM);
  if (!err) err = make_tmap(&m_xnt, xnT, D, M, ld, pw[0]);
  if (err) return err;

  cudaError_t e = launch_qkv_prep(
      ptr, stats, xnT, Transpose{(const bf16*)w, (bf16*)wt, N3, D}, M, D, ld,
      eps, s);
  const bool ragged = N3 % QKV_GC != 0;
  auto grad_kernel = ragged ? qkv_bwd_grad_kernel<true>
                            : qkv_bwd_grad_kernel<false>;
  if (e == cudaSuccess) e = set_smem(grad_kernel, qkv_grad_smem_bytes());
  if (e == cudaSuccess) {
    grad_kernel<<<dim3(blocks1, (N3 + QKV_GC - 1) / QKV_GC), QKV_GRAD_THREADS,
                  qkv_grad_smem_bytes(), s>>>(
        m_gs, (const bf16*)ptr[4], (const bf16*)ptr[5], (const bf16*)ptr[6],
        in_place ? nullptr : (bf16*)gT, db_part, M, C, tokens, ld);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {  // dxn [M, D] = g W
    const DenseArgs a{nullptr, nullptr, nullptr, nullptr, M, D, N3, stages2,
                      (D + tn2 - 1) / tn2, 1, 0};
    e = launch_qkv_gemm_tn(tn2, m_g, m_wt, a, (float*)dxn, grid2, s);
  }
  if (e == cudaSuccess)
    e = launch_ln_bwd<2>(
        [](int ni) -> LnBwdKernel {
          switch (ni) {
            case 1: return qkv_bwd_ln_kernel<1>;
            case 2: return qkv_bwd_ln_kernel<2>;
            case 3: return qkv_bwd_ln_kernel<3>;
            case 6: return qkv_bwd_ln_kernel<6>;
            default: return qkv_bwd_ln_kernel<9>;
          }
        },
        ptr[0], stats, dxn, ptr[1], nullptr, dx, dgb_part, M, D, rows3,
        blocks3, s);
  if (e == cudaSuccess) {  // dW [3C, D] = G^T xn
    const DenseArgs a{nullptr, nullptr, nullptr, nullptr, N3, D, M, pw[1],
                      (D + pw[0] - 1) / pw[0], pw[3], pw[4]};
    if (!in_place)
      e = launch_qkv_gemm_tn(pw[0], m_gt, m_xnt, a, dw_part, pw[2], s);
    else if (pw[0] == 128)
      e = launch_qkv_dw<128>(views, m_xnt, a, C, tokens, box, dw_part, pw[2],
                             s);
    else if (pw[0] == 192)
      e = launch_qkv_dw<192>(views, m_xnt, a, C, tokens, box, dw_part, pw[2],
                             s);
    else
      e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  PartialSums sums;
  int jobs = 0;
  add_sum(sums, jobs, dgb_part, (bf16*)dgb, blocks3, 2L * D);
  add_sum(sums, jobs, db_part, (bf16*)db, blocks1, N3);
  add_sum(sums, jobs, dw_part, (bf16*)dw, pw[3], (long)N3 * D);
  qkv_bwd_reduce_kernel<<<sums.start[SUM_JOBS], 256, 0, s>>>(sums);
  return (int)cudaGetLastError();
}
