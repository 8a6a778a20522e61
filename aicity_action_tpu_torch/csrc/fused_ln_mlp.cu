// Fused LayerNorm + MLP for Hopper: out = fc2(gelu(fc1(LN(x)))).
//
// Replaces aicity_action_tpu/ops/pallas/fused_dense.py:_ln_mlp_kernel (reached
// through fused_ln_mlp), MViT's norm2 + mlp. At 448 it sees x [B*Lq, C],
// hidden H = 4C, C in {96, 192, 384, 768}: 16*C*C flops per row against
// 4*C bytes of activations, i.e. 4C flops/byte -- above the H100's ridge for
// C >= 96, so it is bound by the tensor cores, and by how often the weights
// are re-read from L2.
//
// The Pallas kernel holds both weights (9.4 MB at C=768) in VMEM; shared
// memory holds 227 KB. Design: one block owns a TM-row tile. It loads the
// rows, normalizes them once (f32 statistics) into shared memory, then loops
// over the hidden dim in HC-wide chunks: W1[chunk, :] and W2[:, chunk] stream
// through shared memory with cp.async (STAGES-deep ring where it fits),
// h = gelu(LN(x) W1_chunk^T + b1_chunk) uses the exact erff (the Pallas
// kernel's A&S polynomial exists only because Mosaic has no erf) and is
// rounded to bf16 in shared memory, and out += h W2_chunk^T accumulates in
// f32 registers. The hidden activation never reaches device memory. The f32
// accumulator (TM x C per block) is what bounds the row tile, so TM shrinks
// as C grows (TM * C <= 24576, at most 96 floats a thread); each row tile
// re-reads both weights from L2 once, TM flops per byte. Products run on
// mma.sync m16n8k16 bf16 tiles.
#include "common.cuh"

namespace aicity {

constexpr int MLP_THREADS = 256;

// C: input = output width; TM rows per block; HC hidden chunk; STAGES of the
// weight ring; WGM1 / WGM2: warps along the rows for fc1 / fc2 (the other
// 8 / WGM warps split the columns).
template <int C, int TM, int HC, int STAGES, int WGM1, int WGM2>
struct MlpCfg {
  static constexpr int LDX = C + 8, LDH = HC + 8;
  static constexpr int MT = TM / 16;
  static constexpr int MW1 = MT / WGM1, NW1 = (HC / 8) / (8 / WGM1);
  static constexpr int MW2 = MT / WGM2, NW2 = (C / 8) / (8 / WGM2);
  static constexpr int W1_ELEMS = HC * LDX, W2_ELEMS = C * LDH;
  static constexpr int STAGE_ELEMS = W1_ELEMS + W2_ELEMS;
  static constexpr size_t SMEM =
      (size_t)(TM * LDX + STAGES * STAGE_ELEMS + TM * LDH) * sizeof(bf16);
  static_assert(MT % WGM1 == 0 && (HC / 8) % (8 / WGM1) == 0, "fc1 grid");
  static_assert(MT % WGM2 == 0 && (C / 8) % (8 / WGM2) == 0, "fc2 grid");
  static_assert(MW2 * NW2 * 4 <= 96, "fc2 accumulator");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int C, int TM, int HC, int STAGES, int WGM1, int WGM2>
__global__ void __launch_bounds__(MLP_THREADS)
    ln_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ out, int M,
                  int H, float eps) {
  using K = MlpCfg<C, TM, HC, STAGES, WGM1, WGM2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [TM][LDX]
  bf16* ring = xs + TM * K::LDX;                 // STAGES x (w1s, w2s)
  bf16* hs = ring + STAGES * K::STAGE_ELEMS;     // [TM][LDH]

  const int row0 = blockIdx.x * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm1 = warp % WGM1, wn1 = warp / WGM1;
  const int wm2 = warp % WGM2, wn2 = warp / WGM2;
  const int nchunks = H / HC;

  // W1 rows [h0, h0+HC) x all C, and W2 all C rows x cols [h0, h0+HC)
  auto fetch = [&](int chunk) {
    bf16* w1s = ring + (chunk % STAGES) * K::STAGE_ELEMS;
    bf16* w2s = w1s + K::W1_ELEMS;
    load_tile_async(w1s, K::LDX, w1, C, chunk * HC, H, 0, HC, C);
    load_tile_async(w2s, K::LDH, w2, H, 0, C, chunk * HC, C, HC);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) fetch(s);
    cp_async_commit();
  }

  load_tile(xs, K::LDX, x, C, row0, M, 0, TM, C);
  __syncthreads();
  norm_rows(xs, K::LDX, TM, C, gamma, beta, eps);

  float acc[K::MW2][K::NW2][4];
#pragma unroll
  for (int mi = 0; mi < K::MW2; ++mi)
#pragma unroll
    for (int ni = 0; ni < K::NW2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int i = 0; i < nchunks; ++i) {
    if (i + STAGES - 1 < nchunks) fetch(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // chunk i has landed (and, at i == 0, xs is normed)
    const bf16* w1s = ring + (i % STAGES) * K::STAGE_ELEMS;
    const bf16* w2s = w1s + K::W1_ELEMS;
    const int h0 = i * HC;

    // fc1 + bias + GELU of this warp's MW1 x NW1 tiles -> hs
    {
      float hacc[K::MW1][K::NW1][4];
#pragma unroll
      for (int mi = 0; mi < K::MW1; ++mi)
#pragma unroll
        for (int ni = 0; ni < K::NW1; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[mi][ni][e] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[K::MW1][4];
#pragma unroll
        for (int mi = 0; mi < K::MW1; ++mi)
          load_a_frag(a[mi], xs, K::LDX, (wm1 * K::MW1 + mi) * 16, k0, lane);
#pragma unroll
        for (int ni = 0; ni < K::NW1; ++ni) {
          uint32_t b[2];
          load_b_frag(b, w1s, K::LDX, (wn1 * K::NW1 + ni) * 8, k0, lane);
#pragma unroll
          for (int mi = 0; mi < K::MW1; ++mi) mma_16816(hacc[mi][ni], a[mi], b);
        }
      }
#pragma unroll
      for (int ni = 0; ni < K::NW1; ++ni) {
        const int hc = (wn1 * K::NW1 + ni) * 8 + 2 * t;
        const float bb0 = __bfloat162float(b1[h0 + hc]);
        const float bb1 = __bfloat162float(b1[h0 + hc + 1]);
#pragma unroll
        for (int mi = 0; mi < K::MW1; ++mi) {
          float hv[4] = {hacc[mi][ni][0] + bb0, hacc[mi][ni][1] + bb1,
                         hacc[mi][ni][2] + bb0, hacc[mi][ni][3] + bb1};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hv[e] = 0.5f * hv[e] * (1.f + erff(hv[e] * 0.70710678118654752f));
          const int r = (wm1 * K::MW1 + mi) * 16 + g;
          *reinterpret_cast<uint32_t*>(hs + r * K::LDH + hc) =
              pack_bf16(hv[0], hv[1]);
          *reinterpret_cast<uint32_t*>(hs + (r + 8) * K::LDH + hc) =
              pack_bf16(hv[2], hv[3]);
        }
      }
    }
    __syncthreads();

    // fc2: out += h W2_chunk^T over this warp's MW2 x NW2 tiles
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      uint32_t a[K::MW2][4];
#pragma unroll
      for (int mi = 0; mi < K::MW2; ++mi)
        load_a_frag(a[mi], hs, K::LDH, (wm2 * K::MW2 + mi) * 16, kk, lane);
#pragma unroll
      for (int ni = 0; ni < K::NW2; ++ni) {
        uint32_t b[2];
        load_b_frag(b, w2s, K::LDH, (wn2 * K::NW2 + ni) * 8, kk, lane);
#pragma unroll
        for (int mi = 0; mi < K::MW2; ++mi) mma_16816(acc[mi][ni], a[mi], b);
      }
    }
    __syncthreads();  // this stage and hs are rewritten next iteration
  }

#pragma unroll
  for (int ni = 0; ni < K::NW2; ++ni) {
    const int col = (wn2 * K::NW2 + ni) * 8 + 2 * t;
    const float c0 = __bfloat162float(b2[col]);
    const float c1 = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int mi = 0; mi < K::MW2; ++mi) {
      const int r = row0 + (wm2 * K::MW2 + mi) * 16 + g;
      if (r < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * C + col) =
            pack_bf16(acc[mi][ni][0] + c0, acc[mi][ni][1] + c1);
      if (r + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * C + col) =
            pack_bf16(acc[mi][ni][2] + c0, acc[mi][ni][3] + c1);
    }
  }
}

template <int C, int TM, int HC, int STAGES, int WGM1, int WGM2>
int launch_ln_mlp(const void* x, const void* gamma, const void* beta,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int M, int H, float eps,
                  cudaStream_t stream) {
  using K = MlpCfg<C, TM, HC, STAGES, WGM1, WGM2>;
  auto kernel = ln_mlp_kernel<C, TM, HC, STAGES, WGM1, WGM2>;
  if (H % HC) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(kernel, K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + TM - 1) / TM;
  if (blocks > 0)
    kernel<<<blocks, MLP_THREADS, K::SMEM, stream>>>(
        (const bf16*)x, (const bf16*)gamma, (const bf16*)beta,
        (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
        (bf16*)out, M, H, eps);
  return (int)cudaGetLastError();
}

}  // namespace aicity

// Widths with a tile configuration: C (= D) in {96, 192, 384, 768}.
extern "C" int aicity_ln_mlp_supported(int D, int H, int C) {
  if (D != C) return 0;
  switch (C) {
    case 96: case 192: return H % 64 == 0;
    case 384: case 768: return H % 32 == 0;
    default: return 0;
  }
}

extern "C" int aicity_ln_mlp(const void* x, const void* gamma, const void* beta,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int M, int D, int H,
                             int C, float eps, void* stream) {
  using namespace aicity;
  cudaStream_t s = (cudaStream_t)stream;
  if (!aicity_ln_mlp_supported(D, H, C)) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 96:
      return launch_ln_mlp<96, 128, 64, 3, 8, 2>(x, gamma, beta, w1, b1, w2,
                                                 b2, out, M, H, eps, s);
    case 192:
      return launch_ln_mlp<192, 64, 64, 2, 4, 1>(x, gamma, beta, w1, b1, w2,
                                                 b2, out, M, H, eps, s);
    case 384:
      return launch_ln_mlp<384, 64, 32, 2, 4, 1>(x, gamma, beta, w1, b1, w2,
                                                 b2, out, M, H, eps, s);
    default:  // 768
      return launch_ln_mlp<768, 32, 32, 1, 2, 1>(x, gamma, beta, w1, b1, w2,
                                                 b2, out, M, H, eps, s);
  }
}
