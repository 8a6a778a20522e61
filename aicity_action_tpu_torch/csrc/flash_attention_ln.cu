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
// and Lk in {1568, 6272} (MViT-v2-B), and head dim 72 (MViT-v2-L: q [B*h,
// Lq, 72] from [16, 100352] to [128, 1568] at inference batch 8, and in
// training from [8, 100352] to [64, 1568] at batch 4, with lse and oa
// stored as at 96; flash_fwd.cuh says how 72 rides the products of 96):
// 4*Lq*Lk*d flops against 2*(Lq + 2*Lk)*d bytes, far above the ridge, so
// it is bound by the tensor cores (and by the CUDA-core work of the
// softmax).
//
// Translation from the TPU design:
// - Pallas keeps one group's whole K/V resident in VMEM (up to 1.2 MB each)
//   and normalizes it once per group into scratch at grid step 0. GPU blocks
//   run in no order and share nothing, so the entry point normalizes K and V
//   once, in one pass (flash_ln.cuh:kv_norm_kernel: a d-major tile of 64
//   keys a block, copied in and stored as rows with 16-byte vectors, the
//   norm as the query tiles take it) into token-row scratch the caller
//   provides: Lk*d work per group, where normalizing inside every q tile
//   would repeat it Lq/128 times. The attention then runs flash_fwd.cuh's
//   core on those rows: a producer warp streams 64-key tiles of LN(k)
//   and LN(v) through a TMA ring that two consumer warpgroups of 64 query
//   rows share, on wgmma, FlashAttention 3's schedule.
// - Layout: the pool convolutions leave q, k, v d-major ([B, h*d, L],
//   NCDHW) where the TPU kernel reads head-major token rows. The kernel
//   reads the d-major layout as it lies: the producer warp loads each
//   consumer's [96][64] column tile by TMA with the first K/V tiles, and
//   the consumer LayerNorms each token in f32 (flash_ln.cuh's
//   norm_cols_to_rows, two lanes a token, as the backward's recompute) into
//   bf16 token rows in shared memory, which give its A fragments of
//   bf16(bf16(LN q) * s) and stay there for the residual; K and V become
//   token rows in the pass that normalizes them.
// - The epilogue adds the residual in the staging tile that holds LN(q)
//   (out = bf16(bf16(acc / l) + LN q), as the Pallas kernel rounds it) and
//   stores out, and in training lse and oa, with 16-byte vectors.
#include <math.h>

#include "flash_fwd.cuh"
#include "flash_ln.cuh"

namespace aicity {

// Consumer cw's query rows of the fused-LN forward: its 64 tokens' raw
// d-major tile (raw: [D channels][64 tokens], loaded by the producer's TMA
// on qfull, tokens past Lq as zeros), LayerNormed over the D channels in
// f32 where fq (norm_cols_to_rows, two lanes a token), as bf16 token rows
// in st (64 x FwdDim<D>::LDS); then the A fragments of bf16(row * s)
// over the 96 columns of the products, zeros past D. wt: the thread's
// index in its warpgroup.
template <int D>
__device__ __forceinline__ void ln_query_rows(
    uint64_t* qfull, const bf16* __restrict__ gq, const bf16* __restrict__ bq,
    float eps, int fq, float scale, const bf16* raw, bf16* st, int cw, int wt,
    uint32_t (&qa)[6][4]) {
  constexpr int LDS = FwdDim<D>::LDS;
  mbar_wait(qfull, 0);
  norm_cols_to_rows<D>(raw, 64, st, LDS, 64, gq, bq, eps, fq, wt, 128);
  named_sync(3 + cw, 128);
  const int lane = wt & 31, t = lane & 3;
  const bf16* a0 = st + (16 * (wt >> 5) + (lane >> 2)) * LDS + 2 * t;
#pragma unroll
  for (int kk = 0; kk < 6; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qa[kk][i] = 16 * kk + 8 * (i >> 1) < D
                      ? *reinterpret_cast<const uint32_t*>(
                            a0 + (i & 1) * 8 * LDS + 16 * kk + 8 * (i >> 1))
                      : 0u;
  scale_a(qa, scale);
}

// The fused-LN forward of 128 query rows of group blockIdx.y: the producer
// warp loads each consumer's raw q tile through qmap ([G][D][Lq] d-major)
// and LN(k) / LN(v) token rows through kmap / vmap ([G][Lk][D],
// kv_norm_kernel's output); each consumer normalizes its 64 query tokens
// (ln_query_rows), runs the K/V loop and stores out [+ LN(q)], and in
// training lse and oa, the output before the residual. LAST: the last key
// tile's product width (fwd_last_width); D: the head dim (FwdDim).
template <int LAST, int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_ln_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap,
                    const bf16* __restrict__ gq,
                    const bf16* __restrict__ bq, bf16* __restrict__ o,
                    float* __restrict__ lse, bf16* __restrict__ oa, int Lq,
                    int Lk, float scale, float eps, int fq, int add_qn) {
  extern __shared__ unsigned char fw_smem_raw[];
  unsigned char* base = align1024(fw_smem_raw);
  const int grp = blockIdx.y, q0 = blockIdx.x * FW_ROWS;
  const FwdRing ring(base, &kmap, &vmap, grp, Lk);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warp: q, then K and V
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(ring.qfull, 2 * D * 64 * 2);
      for (int c = 0; c < 2; ++c)
        tma_load3(ring.raw_q(c), &qmap, ring.qfull, q0 + 64 * c, 0, grp);
      ring.produce();
    }
    return;
  }
  const int cw = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int row0 = q0 + 64 * cw;
  bf16* st = ring.staging(cw);
  bf16* raw = ring.raw_q(cw);
  uint32_t qa[6][4];
  ln_query_rows<D>(ring.qfull, gq, bq, eps, fq, scale, raw, st, cw, wt, qa);
  float acc[48], m[2], l[2];
  fwd_tile_loop<LAST>(qa, ring, Lk, acc, m, l);
  const size_t rows = (size_t)grp * Lq * D;
  const FwdOut out{o + rows, oa == nullptr ? nullptr : oa + rows,
                   lse == nullptr ? nullptr : lse + (size_t)grp * Lq,
                   add_qn != 0};
  fwd_epilogue<D>(acc, m, l, st, row0, Lq, cw, out);
}

// The LN(k) / LN(v) pass and the attention at head dim D.
template <int D>
int launch_flash_ln(const void* q, const void* k, const void* v,
                    const void* gq, const void* bq, const void* gk,
                    const void* bk, const void* gv, const void* bv, void* o,
                    void* lse, void* oa, void* kn, void* vn, int G, int Lq,
                    int Lk, float scale, float eps, int fq, int fk, int fv,
                    int add_qn, cudaStream_t s) {
  cudaError_t err =
      launch_kv_norm<D>(k, v, gk, bk, gv, bv, kn, vn, G, Lk, eps, fk, fv, s);
  if (err != cudaSuccess) return (int)err;
  const int last = fwd_last_width(Lk);
  auto kernel = last == 16   ? flash_ln_kernel<16, D>
                : last == 32 ? flash_ln_kernel<32, D>
                             : flash_ln_kernel<BW_T, D>;
  err = set_smem(kernel, fwd_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mk, mv, mq;
  if (make_tmap3_sw64(&mk, kn, G, Lk, D, BW_T) ||
      make_tmap3_sw64(&mv, vn, G, Lk, D, BW_T) ||
      make_tmap3_cols(&mq, q, G, D, Lq, 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Lq + FW_ROWS - 1) / FW_ROWS, G);
  kernel<<<grid, FW_THREADS, fwd_smem_bytes(), s>>>(
      mk, mv, mq, (const bf16*)gq, (const bf16*)bq, (bf16*)o,
      (float*)lse, (bf16*)oa, Lq, Lk, scale, eps, fq, add_qn);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// q, k, v come d-major, [G, d, L] (per head, the NCDHW output of the pool
// convolutions); kn / vn are [G, Lk, d] scratch for the token rows of
// LN(k) / LN(v) (of k / v where fk / fv is off). The output is [G, Lq, d].
// The training forward also stores lse [G, Lq] f32 (the logsumexp) and oa
// [G, Lq, d], the attention output before the residual, for the backward's
// delta; either may be null. d is 96 or 72 (MViT-v2-L), forward and
// backward (flash_attention_ln_bwd.cu).
extern "C" int aicity_flash_attention_ln(
    const void* q, const void* k, const void* v, const void* gq,
    const void* bq, const void* gk, const void* bk, const void* gv,
    const void* bv, void* o, void* lse, void* oa, void* kn, void* vn, int G,
    int Lq, int Lk, int d, float scale, float eps, int fq, int fk, int fv,
    int add_qn, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (d != 96 && d != 72) return (int)cudaErrorInvalidValue;
  if (G <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaSuccess;
  return d == 72 ? launch_flash_ln<72>(q, k, v, gq, bq, gk, bk, gv, bv, o,
                                       lse, oa, kn, vn, G, Lq, Lk, scale,
                                       eps, fq, fk, fv, add_qn, s)
                 : launch_flash_ln<96>(q, k, v, gq, bq, gk, bk, gv, bv, o,
                                       lse, oa, kn, vn, G, Lq, Lk, scale,
                                       eps, fq, fk, fv, add_qn, s);
}
