// Fused LayerNorm + MLP for Hopper: out = fc2(gelu(fc1(LN(x)))).
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_mlp_kernel (reached
// through fused_ln_mlp), MViT's norm2 + mlp. It sees x [B*Lq, C], hidden
// H = 4C, C in {96, 192, 384, 768} (MViT-v2-B) and {144, 288, 576, 1152}
// (MViT-v2-L): 16*C*C flops per row against 4*C bytes
// of activations, 4C flops/byte, above the H100's ridge, so the tensor cores
// bound it, and with them how often the weights are re-read from L2.
//
// The Pallas kernel holds both weights (9.4 MB at C=768) in VMEM. Here the
// output accumulator sets the design, and the plan (ops/fused_dense.py:
// _mlp_plan) picks one of two by width:
// - C <= 192 (96, 144 or 192), one fused kernel (ln_mlp_kernel_fused):
//   persistent blocks of
//   128 rows. The producer warp loads the block's raw x rows once by TMA,
//   the consumers normalize them in place (f32 statistics, rounded to bf16),
//   and the hidden dim streams through a ring in 64-wide chunks (W1 rows and
//   W2 columns, by TMA). Per chunk, fc1 runs on wgmma with both operands in
//   shared memory; b1 and the exact-erf GELU (erf by the Pallas kernel's
//   Abramowitz-Stegun formula, hopper.cuh:gelu_erf) are applied to the f32
//   accumulator, which is rounded to bf16 A fragments of fc2's wgmma (the
//   accumulator layout is the register-A layout: FlashAttention 3's P.V),
//   so the hidden activation never leaves registers. Each warpgroup's
//   output accumulator is 64 x C (48, 72 or 96 f32 a thread); the weights
//   are re-read once per 128 rows. C = 144 (MViT-v2-L's blocks 0 and 1,
//   802816 rows at batch 8) takes this kernel rather than the two launches
//   below: their h round trip would move 1.8 GB a call there.
// - C >= 288 (up to 1152, MViT-v2-L's last four blocks, where the JAX
//   package runs XLA: the port keeps one branch for every block), the LN
//   statistics pre-pass and two launches of the dense
//   mainloop of hopper.cuh in the one wrapper call: the 128 x C f32 output
//   accumulator (192 or 384 registers a thread over two warpgroups) cannot
//   stay on chip. Launch 1 (ln_mlp_kernel_fc1): LN + fc1 + b1 + GELU ->
//   h [M, 4C] bf16, the rounding the plain version and Pallas apply;
//   launch 2 (ln_mlp_kernel_fc2): h W2^T + b2, both on 128 x 128-192 tiles
//   stored by TMA. The round trip of h (M*4C*2 bytes written and read once)
//   costs far less than re-reading both weights per 32-64 row tile, which
//   the accumulator would otherwise force; at C = 96 it would cost three
//   times the block's operations bound, hence the fused kernel.
#include "hopper.cuh"

namespace aicity {

template <int TN>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    ln_mlp_kernel_fc1(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_h,
                      const DenseArgs args) {
  dense_block<TN, true>(map_x, map_w1, args, RowStore{&map_h, 1});
}

template <int TN>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    ln_mlp_kernel_fc2(const __grid_constant__ CUtensorMap map_h,
                      const __grid_constant__ CUtensorMap map_w2,
                      const __grid_constant__ CUtensorMap map_out,
                      const DenseArgs args) {
  dense_block<TN, false>(map_h, map_w2, args, RowStore{&map_out, 0});
}

// The statistics pre-pass of the fc1 launch.
template <int VPL>
__global__ void __launch_bounds__(256)
    ln_mlp_kernel_stats(const bf16* __restrict__ x, float2* __restrict__ stats,
                       int M, int D, float eps) {
  ln_stats_rows<VPL>(x, stats, M, D, eps);
}

StatsKernel ln_mlp_kernel_stats_for(int vpl) {
  switch (vpl) {
    case 3: return ln_mlp_kernel_stats<3>;
    case 6: return ln_mlp_kernel_stats<6>;
    case 12: return ln_mlp_kernel_stats<12>;
    case 24: return ln_mlp_kernel_stats<24>;
    default: return ln_mlp_kernel_stats<36>;
  }
}

constexpr int MLP_HC = 64;  // hidden chunk of the fused kernel

__host__ __device__ inline int fused_mlp_stage_bytes(int C) {
  return ((C + 63) / 64) * MLP_HC * 128 + C * 128;  // W1 boxes + W2 box
}

// alignment slack, the x panel (ceil(C/64) boxes of [128][64]), the ring,
// b1 and b2 in f32, the barriers (full and empty per stage, x full and x
// empty)
__host__ __device__ inline int fused_mlp_smem_bytes(int C, int H,
                                                    int stages) {
  return 1024 + ((C + 63) / 64) * DENSE_BM * 128 +
         stages * fused_mlp_stage_bytes(C) + (H + C) * 4 +
         (2 * DENSE_MAX_STAGES + 2) * 8;
}

template <int C>
__global__ void __launch_bounds__(DENSE_THREADS, 1)
    ln_mlp_kernel_fused(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w1,
                        const __grid_constant__ CUtensorMap map_w2,
                        const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta,
                        const bf16* __restrict__ b1,
                        const bf16* __restrict__ b2, bf16* __restrict__ out,
                        int M, int H, float eps, int stages) {
  constexpr int KB = (C + 63) / 64;  // 64-column boxes of x and of W1
  constexpr int K16 = C / 16;        // k16 steps of fc1
  extern __shared__ unsigned char fused_smem_raw[];
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      ((uintptr_t)fused_smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = xs + KB * DENSE_BM * 128;
  const int stage_bytes = fused_mlp_stage_bytes(C);
  float* b1s = reinterpret_cast<float*>(ring + stages * stage_bytes);
  float* b2s = b1s + H;
  uint64_t* full = reinterpret_cast<uint64_t*>(b2s + C);
  uint64_t* empty = full + DENSE_MAX_STAGES;
  uint64_t* x_full = empty + DENSE_MAX_STAGES;
  uint64_t* x_empty = x_full + 1;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int nchunks = H / MLP_HC;
  const int tiles = (M + DENSE_BM - 1) / DENSE_BM;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, 8);
    mbar_fence_init();
  }
  for (int i = tid; i < H + C; i += DENSE_THREADS)
    b1s[i] = __bfloat162float(i < H ? b1[i] : b2[i - H]);
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 0) return;
    int it = 0, tl = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tl) {
      if (tl > 0) mbar_wait(x_empty, (tl - 1) & 1);
      mbar_arrive_expect_tx(x_full, KB * DENSE_BM * 128);
      for (int kb = 0; kb < KB; ++kb)
        tma_load(xs + kb * DENSE_BM * 128, &map_x, x_full, kb * 64,
                 tile * DENSE_BM);
      for (int i = 0; i < nchunks; ++i, ++it) {
        const int s = it % stages, round = it / stages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* st = ring + s * stage_bytes;
        mbar_arrive_expect_tx(&full[s], stage_bytes);
        for (int kb = 0; kb < KB; ++kb)
          tma_load(st + kb * MLP_HC * 128, &map_w1, &full[s], kb * 64,
                   i * MLP_HC);
        tma_load(st + KB * MLP_HC * 128, &map_w2, &full[s], i * MLP_HC, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int rb = cw * 64 + ((tid >> 5) & 3) * 16;  // this warp's 16 rows
  const int t = lane & 3;
  int it = 0, tl = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tl) {
    mbar_wait(x_full, tl & 1);
    ln_rows_smem<(C / 8 + 1) / 2>(
        [&](int c) { return (void*)(xs + c * DENSE_BM * 128); }, C, rb, eps,
        gamma, beta, lane);
    fence_proxy_async();  // the normalized rows, visible to wgmma
    named_sync(2 + cw, 128);

    float acc[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < nchunks; ++i, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const unsigned char* st = ring + s * stage_bytes;

      // fc1: h = LN(x) W1[chunk]^T, 64 x 64 per warpgroup, both operands
      // from shared memory
      float hacc[MLP_HC / 2];
#pragma unroll
      for (int j = 0; j < MLP_HC / 2; ++j) hacc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < K16; ++k)
        WgmmaSS<MLP_HC>::mma(
            hacc,
            desc_sw128(xs + (k / 4) * DENSE_BM * 128 + cw * 64 * 128) +
                2 * (k % 4),
            desc_sw128(st + (k / 4) * MLP_HC * 128) + 2 * (k % 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<MLP_HC / 2>(hacc);
      if (i == nchunks - 1) {  // the x panel is free for the next tile
        __syncwarp();
        if (lane == 0) mbar_arrive(x_empty);
      }

      // b1 + GELU in f32, rounded to bf16 A fragments of fc2
      uint32_t ah[4][4];
#pragma unroll
      for (int j = 0; j < MLP_HC / 8; ++j) {
        const int col = i * MLP_HC + 8 * j + 2 * t;
        const float c0 = b1s[col], c1 = b1s[col + 1];
        ah[j / 2][2 * (j & 1)] = pack_bf16(gelu_erf(hacc[4 * j] + c0),
                                           gelu_erf(hacc[4 * j + 1] + c1));
        ah[j / 2][2 * (j & 1) + 1] =
            pack_bf16(gelu_erf(hacc[4 * j + 2] + c0),
                      gelu_erf(hacc[4 * j + 3] + c1));
      }

      // fc2: out += h W2[:, chunk]^T, 64 x C per warpgroup
      const uint64_t d2 = desc_sw128(st + KB * MLP_HC * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<C>::mma(acc, ah[kk], d2 + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<C / 2>(acc);
      fence_regs<16>(&ah[0][0]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    store_rows<C>(out, M, C, b2s, false, acc, tile * DENSE_BM + rb, 0, lane);
  }
}

template <int TN>
int launch_fc(bool fc1, const CUtensorMap& ma, const CUtensorMap& mb,
              const CUtensorMap& mo, const DenseArgs& a, int grid,
              cudaStream_t stream) {
  const size_t smem =
      dense_smem_bytes(TN, a.stages, a.K, fc1);
  auto kernel = fc1 ? ln_mlp_kernel_fc1<TN> : ln_mlp_kernel_fc2<TN>;
  static bool ready[2] = {false, false};
  cudaError_t err = prepare_dense(kernel, ready[fc1]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, DENSE_THREADS, smem, stream>>>(ma, mb, mo, a);
  return (int)cudaGetLastError();
}

int launch_fc_tn(int tn, bool fc1, const CUtensorMap& ma,
                 const CUtensorMap& mb, const CUtensorMap& mo,
                 const DenseArgs& a, int grid, cudaStream_t stream) {
  switch (tn) {
    case 128: return launch_fc<128>(fc1, ma, mb, mo, a, grid, stream);
    case 192: return launch_fc<192>(fc1, ma, mb, mo, a, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C>
int launch_fused(const void* x, const void* gamma, const void* beta,
                 const void* w1, const void* b1, const void* w2,
                 const void* b2, void* out, int M, int H, float eps,
                 int stages, int grid, cudaStream_t stream) {
  CUtensorMap mx, m1, m2;
  int err = make_tmap(&mx, x, M, C, C, DENSE_BM);
  if (!err) err = weight_tmap(&m1, w1, H, C, C, MLP_HC);
  if (!err) err = weight_tmap(&m2, w2, C, H, H, C);
  if (err) return err;
  const size_t smem = fused_mlp_smem_bytes(C, H, stages);
  static bool ready = false;
  cudaError_t e = prepare_dense(ln_mlp_kernel_fused<C>, ready);
  if (e != cudaSuccess) return (int)e;
  ln_mlp_kernel_fused<C><<<grid, DENSE_THREADS, smem, stream>>>(
      mx, m1, m2, (const bf16*)gamma, (const bf16*)beta, (const bf16*)b1,
      (const bf16*)b2, (bf16*)out, M, H, eps, stages);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// Shared memory of a launch of the plan: variant 0 the fused kernel
// (width C, stages), 1 the fc1 launch (tn, stages, K = C), 2 the fc2 launch
// (tn, stages, K = H).
extern "C" int aicity_ln_mlp_smem_bytes(int variant, int C, int H, int tn,
                                        int stages) {
  using namespace aicity;
  switch (variant) {
    case 0: return fused_mlp_smem_bytes(C, H, stages);
    case 1: return dense_smem_bytes(tn, stages, C, true);
    default: return dense_smem_bytes(tn, stages, H, false);
  }
}

// x [M, D], w1 [H, D], w2 [C, H], out [M, C]; h [M, H] and stats
// [ceil(M / 128) * 128][2] f32 are the wrapper's scratch for the two-launch
// variant (null for the fused one). The plan (ops/fused_dense.py:
// _mlp_plan): fused (C in {96, 144, 192}: stages1, grid1) or two launches
// after the statistics pre-pass (fc1: tn1, stages1, grid1; fc2: tn2, stages2,
// grid2).
extern "C" int aicity_ln_mlp(const void* x, const void* gamma, const void* beta,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, void* h, void* stats,
                             int M, int D, int H, int C, float eps, int fused,
                             int tn1, int stages1, int grid1, int tn2,
                             int stages2, int grid2, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (D != C || H % 64 || C % 16 || C > DENSE_MAX_LN_K || grid1 < 1 ||
      stages1 < 3 ||
      stages1 > DENSE_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (fused) {
    switch (C) {
      case 96:
        return launch_fused<96>(x, gamma, beta, w1, b1, w2, b2, out, M, H,
                                eps, stages1, grid1, s);
      case 144:
        return launch_fused<144>(x, gamma, beta, w1, b1, w2, b2, out, M, H,
                                 eps, stages1, grid1, s);
      case 192:
        return launch_fused<192>(x, gamma, beta, w1, b1, w2, b2, out, M, H,
                                 eps, stages1, grid1, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (!h || !stats || grid2 < 1 || stages2 < 3 ||
      stages2 > DENSE_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  // x and h read in 128-row boxes, h and out written in 64 x 64 boxes
  CUtensorMap mx, m1, mh, m2, mh_out, mo;
  int err = make_tmap(&mx, x, M, C, C, DENSE_BM);
  if (!err) err = weight_tmap(&m1, w1, H, C, C, tn1);
  if (!err) err = make_tmap(&mh, h, M, H, H, DENSE_BM);
  if (!err) err = weight_tmap(&m2, w2, C, H, H, tn2);
  if (!err) err = make_tmap(&mh_out, h, M, H, H, 64);
  if (!err) err = make_tmap(&mo, out, M, C, C, 64);
  if (err) return err;
  err = (int)launch_stats(ln_mlp_kernel_stats_for, x, stats, M, C, eps, s);
  if (err) return err;
  const DenseArgs a1{(const float2*)stats, (const bf16*)gamma,
                     (const bf16*)beta, (const bf16*)b1, M, H, C, stages1,
                     (H + tn1 - 1) / tn1};
  err = launch_fc_tn(tn1, true, mx, m1, mh_out, a1, grid1, s);
  if (err) return err;
  const DenseArgs a2{nullptr, nullptr, nullptr, (const bf16*)b2, M, C, H,
                     stages2, (C + tn2 - 1) / tn2};
  return launch_fc_tn(tn2, false, mh, m2, mo, a2, grid2, s);
}
