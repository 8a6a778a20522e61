// Fused LayerNorm + qkv projection for Hopper: (q, k, v) = split(LN(x) W^T + b).
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_qkv_kernel (reached
// through fused_ln_qkv), MViT's norm1 + attn.qkv. It sees x [B*L, D] with D
// in {96, 192, 384, 768} and 3C in {288, 576, 1152, 2304}: 2*D*3C flops per
// row against 2*(D + 3C) bytes, 64-400 flops/byte, so the narrow blocks are
// bound by memory (x read once, q/k/v written once) and the wide ones by the
// tensor cores and by how often a block re-reads the weight from L2.
//
// The Pallas kernel keeps the whole [D, 3C] weight in VMEM (3.5 MB at
// D=768, more than shared memory). Design (the mainloop of hopper.cuh): a
// pre-pass writes each row's LN statistics (f32, two passes; one read of
// x); then a 2-D queue of 128-row x TN-column tiles (TN from the plan in
// ops/fused_dense.py: 96 or 192, dividing C, so 1176 tiles at block 15
// where a row-tile grid had 98 blocks) is walked by persistent blocks of
// one producer warp (TMA loads of raw x and weight chunks, 64 deep, through
// a ring of at least 3 mbarrier stages, the tile's statistics copied in
// with its first chunk) and two consumer warpgroups (64 rows each), which
// normalize each A fragment in registers as they load it (ldmatrix from the
// swizzled chunk, (x - mean) * rstd * gamma + beta in f32, rounded to
// bf16) and issue wgmma with A from registers. The epilogue adds the bias
// in f32 and writes q, k, v channel-major, [B, C, L] each (the layout the
// depthwise pool convolutions read): through a [TN][64] shared-memory box
// per consumer and one TMA store where L % 64 == 0, 16-byte stores of each
// channel's run where L % 8 == 0, and 2-byte stores from registers at the
// odd L of cls-token models (a TMA store cannot write rows of odd length).
#include "hopper.cuh"

namespace aicity {

// The output descriptors of q, k, v (TMA stores), as one kernel argument.
struct QkvMaps {
  CUtensorMap m[3];
};

template <int TN>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    ln_qkv_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ QkvMaps maps, const DenseArgs args,
                  QkvStore out) {
  if (out.maps) out.maps = maps.m;
  dense_block<TN, true>(map_x, map_w, args, out);
}

// The LN statistics pre-pass.
template <int VPL>
__global__ void __launch_bounds__(256)
    ln_qkv_kernel_stats(const bf16* __restrict__ x, float2* __restrict__ stats,
                       int M, int D, float eps) {
  ln_stats_rows<VPL>(x, stats, M, D, eps);
}

StatsKernel ln_qkv_kernel_stats_for(int vpl) {
  switch (vpl) {
    case 3: return ln_qkv_kernel_stats<3>;
    case 6: return ln_qkv_kernel_stats<6>;
    case 12: return ln_qkv_kernel_stats<12>;
    default: return ln_qkv_kernel_stats<24>;
  }
}

template <int TN>
int launch_ln_qkv(const CUtensorMap& mx, const CUtensorMap& mw,
                  const QkvMaps& maps, const DenseArgs& a, const QkvStore& o,
                  int grid, cudaStream_t stream) {
  const size_t smem = dense_smem_bytes(TN, a.stages, a.K, true);
  static bool ready = false;
  cudaError_t err = prepare_dense(ln_qkv_kernel<TN>, ready);
  if (err != cudaSuccess) return (int)err;
  ln_qkv_kernel<TN><<<grid, DENSE_THREADS, smem, stream>>>(mx, mw, maps, a,
                                                           o);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// Shared memory of a launch with the plan (tn, stages), for the wrapper to
// hold against its own plan.
extern "C" int aicity_ln_qkv_smem_bytes(int D, int tn, int stages) {
  return aicity::dense_smem_bytes(tn, stages, D, true);
}

// x is [M, D] token rows of clips of `tokens` tokens; q, k, v are each
// [M / tokens, C, tokens]. The plan (ops/fused_dense.py:_qkv_plan): column
// tile tn, ring stages, persistent grid; the LN statistics pre-pass writes
// the wrapper's scratch stats [ceil(M / 128) * 128][2] f32.
extern "C" int aicity_ln_qkv(const void* x, const void* gamma, const void* beta,
                             const void* w, const void* bias, void* q, void* k,
                             void* v, void* stats, int M, int D, int C,
                             float eps, int tokens, int tn, int stages,
                             int grid, void* stream) {
  using namespace aicity;
  const int N = 3 * C;
  if (tokens <= 0 || M % tokens || D % 16 || D > 768 || C % tn ||
      stages < 3 || stages > DENSE_MAX_STAGES || grid < 1 || !stats)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  // q, k, v as [B*C rows][tokens], written in boxes of tn x 64 tokens
  // where each consumer's 64 rows lie in one clip
  const bool tma_out = tokens % 64 == 0;
  CUtensorMap mx, mw;
  QkvMaps maps;
  int err = make_tmap(&mx, x, M, D, D, DENSE_BM);
  if (!err) err = weight_tmap(&mw, w, N, D, D, tn);
  void* qkv[3] = {q, k, v};
  for (int i = 0; i < 3 && tma_out && !err; ++i)
    err = make_tmap(&maps.m[i], qkv[i], (uint64_t)(M / tokens) * C, tokens,
                    tokens, tn);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  err = (int)launch_stats(ln_qkv_kernel_stats_for, x, stats, M, D, eps, s);
  if (err) return err;
  const DenseArgs a{(const float2*)stats, (const bf16*)gamma,
                    (const bf16*)beta, (const bf16*)bias, M, N, D, stages,
                    (N + tn - 1) / tn};
  // (a non-null maps marks the TMA stores; the kernel points it at its
  // own copy of the descriptors)
  const QkvStore o{(bf16*)q, (bf16*)k, (bf16*)v,
                   tma_out ? maps.m : nullptr, C, tokens};
  switch (tn) {
    case 96: return launch_ln_qkv<96>(mx, mw, maps, a, o, grid, s);
    case 192: return launch_ln_qkv<192>(mx, mw, maps, a, o, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
