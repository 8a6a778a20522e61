// Shared device helpers for the hand-written kernels of
// aicity_action_tpu_torch: warp reductions, a bf16 A-fragment load from
// shared memory, cooperative 16-byte tile copies (the fused-LN backward's
// dq kernel), the tickets of the backwards' cross-block sums and the
// shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aicity {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A fragment of the 16x16 tile at (row0, k0) of a row-major smem matrix.
__device__ __forceinline__ void load_a_frag(uint32_t* a, const bf16* s, int ld,
                                            int row0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (row0 + g) * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// 16-byte asynchronous copy global -> shared; with pred false the 16 bytes
// are zero-filled and global memory is not read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy columns [col0, col0 + ncols) of rows [0, nrows) of a row-major
// global matrix (leading dim ldg) into smem (leading dim lds) with 16-byte
// vectors, zero-filled from cols_total on (a multiple of 8).
__device__ __forceinline__ void load_tile_cols(bf16* s, int lds, const bf16* g,
                                               int ldg, int col0,
                                               int cols_total, int nrows,
                                               int ncols) {
  const int vpr = ncols / 8;
  const int nvec = nrows * vpr;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (col0 + c < cols_total)
      v = *reinterpret_cast<const uint4*>(g + (size_t)r * ldg + col0 + c);
    *reinterpret_cast<uint4*>(s + r * lds + c) = v;
  }
}

// Copy rows [row0, row0 + nrows) x cols [col0, col0 + ncols) of a row-major
// global matrix (leading dim ldg) into smem (leading dim lds) with 16-byte
// cp.async copies; rows past rows_total are zero-filled (their global
// address is clamped to row 0 and not read). ncols, col0, ldg and lds are
// multiples of 8 and the base is 16-byte aligned.
__device__ __forceinline__ void load_tile_async(bf16* s, int lds,
                                                const bf16* g, int ldg,
                                                int row0, int rows_total,
                                                int col0, int nrows,
                                                int ncols) {
  const int vpr = ncols / 8;
  const int nvec = nrows * vpr;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    const bool ok = row0 + r < rows_total;
    cp_async16(s + r * lds + c, g + (size_t)(ok ? row0 + r : 0) * ldg + col0 + c,
               ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Called by every thread after the block's writes: whether this block is
// the last of `count` blocks sharing `ticket` to finish (then their writes
// are visible to it). atomicInc wraps the ticket back to 0 on the last
// increment, so the counter is ready for the next launch on its stream.
__device__ __forceinline__ bool last_of(unsigned* ticket, int count) {
  __shared__ bool last;
  __threadfence();  // this block's writes, visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, count - 1) == count - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace aicity
