// Hopper building blocks of the dense kernels (fused_ln_qkv.cu,
// fused_ln_mlp.cu, fused_ln_mlp_bwd.cu, fused_ln_qkv_bwd.cu) and of the
// attention backward (flash_bwd.cuh): TMA descriptors and loads, mbarriers,
// wgmma with A from registers or shared memory (128- and 64-byte swizzles,
// B K-major or MN-major), setmaxnreg, and the warp-specialised GEMM
// mainloop the dense kernels share.
//
// The mainloop computes out[M, N] = A[M, K] B[N, K]^T + bias, A optionally
// LayerNorm'd on the fly (f32 statistics, rounded to bf16 before the
// product, as the Pallas kernels and the plain versions do). B is an
// nn.Linear weight, [N][K] K-major. A block has three warpgroups: warpgroup 0
// is the producer (one thread keeps TMA loads of the A and B tiles in flight
// through a ring of 64-deep K chunks, each stage completed by an mbarrier;
// the other producer threads exit), warpgroups 1 and 2 are consumers, 64
// rows each of the block's 128-row tile. With a LayerNorm, a consumer loads
// its A fragments from the 128-byte-swizzled chunk with ldmatrix, applies
// the LN in f32 in registers and issues wgmma with A from registers
// (FlashAttention 3's pattern for P); the fragments are double-buffered, so
// the next chunk is normalized while this chunk's group is in flight. The
// statistics come from a pre-pass over the rows (the product of a column
// tile needs all of the row before its first chunk), whose 128 rows of
// (mean, rstd) the producer copies in with the tile's first chunk. Without
// a LayerNorm, both operands come from shared memory. The epilogue stages
// the tile in shared memory for TMA stores. Blocks are persistent: each
// walks the (row tile, column tile) queue with a stride of the grid,
// column tiles fastest, so the blocks running together share the A rows in
// L2 and the producer prefetches the next tile while the consumers store
// this one. Without a LayerNorm, K may be split: each (tile, split) pair
// is a queue entry of its own that writes an f32 partial (the LN+MLP
// backward's weight gradients). The tile width TN, the ring depth, the
// splits and the grid are a plan computed in Python (ops/fused_dense.py)
// and passed in as launch arguments.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"

namespace aicity {

// ------------------------------------------------------ TMA descriptors (host)

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point so
// that the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Descriptor of a row-major bf16 matrix [rows][cols] (leading dim ld
// elements) read in boxes of box_rows x 64 columns (128 bytes, the
// 128-byte swizzle that the wgmma descriptors below expect), or, with
// box_cols given, written in unswizzled boxes of box_rows x box_cols (a
// dense row-major box in shared memory). Elements past the matrix's edge
// load as zero and are not stored. Returns a cudaError_t.
inline int make_tmap(CUtensorMap* map, const void* base, uint64_t rows,
                     uint64_t cols, uint64_t ld, uint32_t box_rows,
                     uint32_t box_cols = 0) {
  EncodeTiledFn enc = encode_tiled_fn();
  if (!enc || (uintptr_t)base % 16 || (ld * 2) % 16 || box_rows == 0 ||
      box_rows > 256 || box_cols > 256 || (box_cols * 2) % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols ? box_cols : 64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Descriptor of a bf16 tensor [groups][rows][cols] (rows and groups dense,
// cols * 2 a multiple of 16 bytes) read in boxes of box_rows x 32 columns
// of one group, in the 64-byte swizzle that desc_sw64_k / desc_sw64_mn
// expect. Rows past `rows` load as zero, so a box never reaches into the
// next group. Returns a cudaError_t.
inline int make_tmap3_sw64(CUtensorMap* map, const void* base,
                           uint64_t groups, uint64_t rows, uint64_t cols,
                           uint32_t box_rows) {
  EncodeTiledFn enc = encode_tiled_fn();
  if (!enc || (uintptr_t)base % 16 || (cols * 2) % 16 || box_rows == 0 ||
      box_rows > 256 || groups == 0 || rows == 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {cols, rows, groups};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {32, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Descriptor of a bf16 tensor [groups][rows][cols] (cols * 2 a multiple of
// 16 bytes) read in unswizzled boxes of all its rows by box_cols columns of
// one group (a dense [rows][box_cols] box in shared memory); columns past
// `cols` load as zero. Returns a cudaError_t.
inline int make_tmap3_cols(CUtensorMap* map, const void* base,
                           uint64_t groups, uint64_t rows, uint64_t cols,
                           uint32_t box_cols) {
  EncodeTiledFn enc = encode_tiled_fn();
  if (!enc || (uintptr_t)base % 16 || (cols * 2) % 16 || rows == 0 ||
      rows > 256 || groups == 0 || box_cols == 0 || box_cols > 256 ||
      (box_cols * 2) % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {cols, rows, groups};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {box_cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// make_tmap for a weight: a descriptor is a pure function of (pointer,
// dims, stride, box), so one cached under that key cannot go stale. The
// table keeps the last 64 (round robin); activations are encoded per call.
inline int weight_tmap(CUtensorMap* map, const void* base, uint64_t rows,
                       uint64_t cols, uint64_t ld, uint32_t box_rows) {
  struct Entry {
    const void* base;
    uint64_t rows, cols, ld;
    uint32_t box_rows;
    CUtensorMap map;
  };
  constexpr int SLOTS = 64;
  static std::mutex mu;
  static Entry table[SLOTS];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = table[i];
    if (e.base == base && e.rows == rows && e.cols == cols && e.ld == ld &&
        e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  }
  const int err = make_tmap(map, base, rows, cols, ld, box_rows);
  if (err) return err;
  table[next] = Entry{base, rows, cols, ld, box_rows, *map};
  next = (next + 1) % SLOTS;
  if (used < SLOTS) ++used;
  return 0;
}

// ------------------------------------------------------------ device helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarriers: a full barrier per ring stage completes when its TMA bytes
// have landed (one arrival, the producer's, plus the transaction count); an
// empty barrier completes when every consumer warp has released the stage.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait in these
// kernels lasts microseconds; one that outlasts 2^24 tries means a lost
// arrival, and trapping turns that into a launch error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (TMA, wgmma) that touches the same bytes after a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2-D TMA load of the box at (column c0, row c1) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 3-D TMA load of the box at (column c0, row c1, group c2) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Asynchronous stores from shared memory: a 2-D TMA store of a box at
// (column c0, row c1) (parts past the tensor's edges are not written),
// committed as this thread's bulk groups. wait_read: the sources may be
// rewritten; wait_done: the writes are complete.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16) from shared to global memory,
// committed with this thread's bulk groups like tma_store.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          (uint64_t)dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest bulk groups still read
// their shared-memory sources.
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Register rebalancing between the producer warpgroup (which needs few) and
// the consumers (whose wgmma accumulators need many). Both sides must run
// in every warp of their warpgroup, and the kernel must be compiled to the
// register count that __launch_bounds__(384, 1) allows (168): then 128 x 40
// + 256 x 232 registers fit the block's 384 x 168.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// wgmma ordering: fence before a wgmma that reads registers written since,
// commit the issued ones as a group, wait until at most N groups are pending.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma uses across the wait (and from reusing an A register
// while a wgmma still reads it).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma descriptor of a K-major [rows][64] bf16 tile as TMA writes it with
// the 128-byte swizzle (1024-byte aligned): rows of 128 bytes, 8-row groups
// 1024 bytes apart (stride byte offset 64 x 16 B), layout type 1 (128B
// swizzle). Step k16 of the 64-deep chunk starts 32 bytes on: add 2 * kk.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// wgmma descriptors of a [rows][32] bf16 box as TMA writes it with the
// 64-byte swizzle (512-byte aligned; the swizzle repeats every 8 rows of 64
// bytes): layout type 2 (64B swizzle), 8-row groups 512 bytes apart.
// K-major (the 32 columns are the reduction): the stride byte offset is the
// 8-row groups' 512 bytes (32 x 16 B), the leading one unused; step k16 of
// the box starts 32 bytes on (add 2). MN-major (the rows are the
// reduction, read through wgmma's transpose bit): atoms of 32 columns x 8
// rows; the leading byte offset is the distance from one 32-column atom to
// the next (the next box, `box_bytes` on), the stride byte offset the 8-row
// groups' 512 bytes; step k16 (16 rows) starts 1024 bytes on.
__device__ __forceinline__ uint64_t desc_sw64_k(const void* box) {
  return (uint64_t)((smem_u32(box) & 0x3FFFF) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}

__device__ __forceinline__ uint64_t desc_sw64_mn(const void* box,
                                                 uint32_t box_bytes) {
  return (uint64_t)((smem_u32(box) & 0x3FFFF) >> 4) |
         ((uint64_t)(box_bytes >> 4) << 16) | (32ull << 32) | (2ull << 62);
}

// The A fragment of wgmma m64k16 (see WgmmaRS) for this warp's 16 rows
// [r0, r0 + 16) and columns [16 kk, 16 kk + 16) of a [rows][64] bf16 tile
// in the 128-byte swizzle (r0 % 8 == 0), through one ldmatrix.x4.
__device__ __forceinline__ void ldmatrix_sw128(uint32_t* a, const void* tile,
                                               int r0, int kk, int lane) {
  const int r = r0 + (lane & 15);
  const int c = kk * 2 + (lane >> 4);
  const uint32_t addr = smem_u32(tile) + r * 128 + ((c ^ (r & 7)) << 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Stores four 8x8 bf16 matrices to shared memory: register i of every lane
// holds its pair of matrix i in the mma fragment layout (row lane / 4,
// columns 2 (lane % 4), + 1), and lanes 8i..8i+7 give the addresses of
// matrix i's eight 16-byte rows; with TRANS each matrix is stored
// transposed (row k holds column k).
template <bool TRANS>
__device__ __forceinline__ void stmatrix_x4(const void* row,
                                            const uint32_t* r) {
  if constexpr (TRANS)
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
        "{%1, %2, %3, %4};\n" ::"r"(smem_u32(row)),
        "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
        : "memory");
  else
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
        ::"r"(smem_u32(row)),
        "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
        : "memory");
}

// Loads four 8x8 bf16 matrices from shared memory, the layout stmatrix_x4
// stores: lanes 8i..8i+7 give the addresses of matrix i's eight 16-byte
// rows, and register i of every lane receives its pair of matrix i (row
// lane / 4, columns 2 (lane % 4), + 1; with TRANS, rows 2 (lane % 4), + 1 of
// column lane / 4).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(row))
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(row))
        : "memory");
}

// The 16 bytes (8 bf16) of row r, columns [8c, 8c + 8), of a [rows][64]
// bf16 tile in the 128-byte swizzle (1024-byte aligned), as TMA writes it.
__device__ __forceinline__ uint4* sw128_chunk(void* tile, int r, int c) {
  return reinterpret_cast<uint4*>(static_cast<unsigned char*>(tile) +
                                  r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ float sum8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s += bf16_lo(w[i]) + bf16_hi(w[i]);
  return s;
}

__device__ __forceinline__ float sqdev8(uint4 v, float mean) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = bf16_lo(w[i]) - mean, b = bf16_hi(w[i]) - mean;
    s += a * a + b * b;
  }
  return s;
}

// (mean, rstd) of a row of D channels held by LANES adjacent lanes of a
// warp, lane q of them holding the 16-byte vectors q + LANES i (zeros past
// the row's nv vectors): f32, two passes over the registers (the mean, then
// the mean squared deviation), the lanes' sums joined by shuffles. The
// statistics of every row LayerNorm of the port, so that they round alike.
// Every lane of the warp takes part.
template <int LANES, int VPL>
__device__ __forceinline__ float2 row_stats(const uint4 (&v)[VPL], int q,
                                            int nv, int D, float eps) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) s += sum8(v[i]);
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) s += __shfl_xor_sync(~0u, s, o);
  const float mu = s / D;
  float d2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    if (q + LANES * i < nv) d2 += sqdev8(v[i], mu);
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) d2 += __shfl_xor_sync(~0u, d2, o);
  return make_float2(mu, rsqrtf(d2 / D + eps));
}

// LayerNorm of 8 bf16 channels: (v - mean) * rstd * gamma + beta in f32,
// rounded to bf16.
__device__ __forceinline__ uint4 ln_vec8(uint4 v, float mu, float rs,
                                         uint4 gv, uint4 bv) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
  const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = pack_bf16(
        (bf16_lo(w[e]) - mu) * rs * bf16_lo(gw[e]) + bf16_lo(bw[e]),
        (bf16_hi(w[e]) - mu) * rs * bf16_hi(gw[e]) + bf16_hi(bw[e]));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// LayerNorm of a bf16 pair (columns k, k + 1 of one row): f32, rounded to
// bf16.
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float mean,
                                            float rstd, float2 g, float2 b) {
  return pack_bf16((bf16_lo(v) - mean) * rstd * g.x + b.x,
                   (bf16_hi(v) - mean) * rstd * g.y + b.y);
}

// LayerNorm of an A fragment (see ldmatrix_sw128) whose first column is k:
// mean / rstd of rows g and g + 8, gamma and beta f32 in shared memory.
__device__ __forceinline__ void ln_frag(uint32_t* a, const float* gam,
                                        const float* bet, int k,
                                        const float* mean,
                                        const float* rstd) {
  const float2 g0 = *reinterpret_cast<const float2*>(gam + k);
  const float2 g1 = *reinterpret_cast<const float2*>(gam + k + 8);
  const float2 b0 = *reinterpret_cast<const float2*>(bet + k);
  const float2 b1 = *reinterpret_cast<const float2*>(bet + k + 8);
  a[0] = ln_pair(a[0], mean[0], rstd[0], g0, b0);
  a[1] = ln_pair(a[1], mean[1], rstd[1], g0, b0);
  a[2] = ln_pair(a[2], mean[0], rstd[0], g1, b1);
  a[3] = ln_pair(a[3], mean[1], rstd[1], g1, b1);
}

// LayerNorm, in place, of this warp's 16 rows [r0, r0 + 16) of a tile held
// in shared memory as 128-byte-swizzled [128][64] column chunks (chunk(k)
// for columns [64k, 64k + 64)), D <= 16 * MAXV: f32 statistics in two
// passes over the row held in registers (the mean, then the mean squared
// deviation), two lanes a row, each holding every other 16-byte vector of
// it; gamma and beta in global memory; rounded to bf16. Rows TMA
// zero-filled stay finite.
template <int MAXV, class Chunk>
__device__ __forceinline__ void ln_rows_smem(Chunk chunk, int D, int r0,
                                             float eps, const bf16* gamma,
                                             const bf16* beta, int lane) {
  const int nv = D / 8, q = lane & 1;
  const int r = r0 + (lane >> 1);
  uint4* p[MAXV];
  uint4 v[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = q + 2 * i;
    p[i] = sw128_chunk(chunk(c >> 3), r, c & 7);
    v[i] = c < nv ? *p[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  const float2 st = row_stats<2, MAXV>(v, q, nv, D, eps);  // zeros past D
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = q + 2 * i;
    if (c >= nv) continue;
    *p[i] = ln_vec8(v[i], st.x, st.y,
                    *reinterpret_cast<const uint4*>(gamma + 8 * c),
                    *reinterpret_cast<const uint4*>(beta + 8 * c));
  }
  __syncwarp();
}

// The statistics pre-pass: (mean, rstd) of every row of x [M, D] (D <=
// 32 * VPL) into stats [Mpad][2] f32: f32, two passes over the row held in
// registers, four lanes a row, each holding VPL 16-byte vectors (blocks
// of 256 threads, 64 rows; Mpad a multiple of 64); rows [M, Mpad) are
// written as (0, 0).
template <int VPL>
__device__ __forceinline__ void ln_stats_rows(const bf16* __restrict__ x,
                                              float2* __restrict__ stats,
                                              int M, int D, float eps) {
  const int lane = threadIdx.x & 31, q = lane & 3, nv = D / 8;
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  uint4 v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = q + 4 * i;
    v[i] = r < M && c < nv ? *reinterpret_cast<const uint4*>(
                                 x + (size_t)r * D + 8 * c)
                           : make_uint4(0u, 0u, 0u, 0u);
  }
  const float2 st = row_stats<4, VPL>(v, q, nv, D, eps);
  if (q == 0) stats[r] = r < M ? st : make_float2(0.f, 0.f);
}

typedef void (*StatsKernel)(const bf16*, float2*, int, int, float);

// Launch of the pre-pass kernel pick(VPL) for the fewest vectors per lane
// that cover D (D <= 1152: VPL 3, 6, 12, 24 or 36), so that registers, and
// with them occupancy, follow D.
template <class Pick>
inline cudaError_t launch_stats(Pick pick, const void* x, void* stats, int M,
                                int D, float eps, cudaStream_t stream) {
  const int mpad = (M + 127) / 128 * 128, vpl = (D / 8 + 3) / 4;
  const StatsKernel kernel =
      pick(vpl <= 3    ? 3
           : vpl <= 6  ? 6
           : vpl <= 12 ? 12
           : vpl <= 24 ? 24
                       : 36);
  kernel<<<mpad / 64, 256, 0, stream>>>((const bf16*)x, (float2*)stats, M,
                                        D, eps);
  return cudaGetLastError();
}

// Exact-erf GELU, 0.5 v (1 + erf(v / sqrt 2)), with erf by Abramowitz and
// Stegun 7.1.26 (max abs error 1.5e-7, far below bf16's resolution): the
// formula of the Pallas kernel (fused_dense.py:_erf_f32), and about half
// the instructions of erff; one reciprocal and one exponential.
__device__ __forceinline__ float gelu_erf(float v) {
  const float x = v * 0.70710678118654752f, ax = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f),
                               1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float y = 1.f - poly * __expf(-ax * ax);
  return 0.5f * v * (1.f + copysignf(y, x));
}

// ------------------------------------------------------------- wgmma (RS)

// d[N/2] += A (64 x 16, this thread's fragment a[4]) * B (16 x N, K-major
// tile in shared memory through descriptor b): wgmma.m64nNk16, bf16 in, f32
// accumulate. Thread (warp w of the warpgroup, g = lane / 4, t = lane % 4)
// holds d[4j .. 4j+1] = row 16w + g, columns 8j + 2t, 8j + 2t + 1 and
// d[4j+2 .. 4j+3] = row 16w + g + 8, same columns; its A fragment is the
// same layout (a[0] row g, columns 2t, 2t+1 of the 16; a[1] row g + 8;
// a[2], a[3] the same rows, columns 2t + 8, 2t + 9), so an accumulator
// converts to the A of the next product in registers.
template <int N>
struct WgmmaRS;

// m64n16k16 and m64n32k16, for the logits of the attention forward's last
// key tile where it holds at most 16 or 32 keys (flash_fwd.cuh): the first
// 8 or 16 registers of WgmmaRS<64>'s layout. With accumulate 0, d = A * B.
template <>
struct WgmmaRS<16> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct WgmmaRS<32> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

// m64n64k16, for the attention's logits (flash_bwd.cuh, flash_fwd.cuh).
// With accumulate 0, d = A * B: the old d is not read.
template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct WgmmaRS<96> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// m64n144k16: the LN+qkv forward's 144-column tile (a third of C = 144's
// q, k, v) and the fused LN+MLP's output at C = 144.
template <>
struct WgmmaRS<144> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaRS<192> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// d[N/2] += A (64 x 16) * B (16 x N), both K-major tiles in shared memory
// through descriptors a and b (wgmma.m64nNk16, bf16 in, f32 accumulate),
// the accumulator laid out as WgmmaRS's.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<128> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<192> {
  __device__ __forceinline__ static void mma(float* d, uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ------------------------------------------------------- the dense mainloop

constexpr int DENSE_BM = 128;      // rows of a block tile (two warpgroups)
constexpr int DENSE_THREADS = 384;  // producer + two consumer warpgroups
constexpr int DENSE_MAX_STAGES = 8;
// the widest LayerNorm'd A the forwards take (gamma and beta in f32 in
// shared memory, the statistics pre-pass's 36 vectors a lane)
constexpr int DENSE_MAX_LN_K = 1152;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// A ring stage: A [128][64] + B [tn][64] (bf16), and with a LayerNorm the
// tile's 128 rows of (mean, rstd) from the pre-pass (1 KB, first chunk
// only).
__host__ __device__ inline int dense_stage_bytes(int tn, bool ln) {
  return DENSE_BM * 128 + tn * 128 + (ln ? 1024 : 0);
}

__host__ __device__ inline int dense_kpad(int K) { return (K + 63) / 64 * 64; }

// Dynamic shared memory of a dense block: 1024 bytes of alignment slack, the
// ring, the epilogue's staging (per consumer tn x 64 bf16 in TMA boxes with
// the 128-byte swizzle: [tn channels][64 tokens] for q, k, v, tn / 64 boxes
// of [64 rows][64 columns] for row-major outputs), gamma and beta in f32
// (LayerNorm), each consumer's f32 bias slice of its tile, the full and
// empty barriers.
__host__ __device__ inline int dense_smem_bytes(int tn, int stages, int K,
                                                bool ln) {
  return 1024 + stages * dense_stage_bytes(tn, ln) + 2 * tn * 128 +
         (ln ? 8 * dense_kpad(K) : 0) + 2 * tn * 4 +
         2 * DENSE_MAX_STAGES * 8;
}

struct DenseArgs {
  const float2* stats;  // LayerNorm: pre-pass (mean, rstd) per row, rows
                        // padded to whole tiles
  const bf16* gamma;    // LayerNorm of A
  const bf16* beta;
  const bf16* bias;     // [N] or null
  int M, N, K;          // A [M, K], B [N, K], out [M, N]
  int stages;           // ring depth
  int n_tiles;          // column tiles of TN
  // split-K (without a LayerNorm): K's 64-deep chunks cut into `splits`
  // runs of `split_chunks`, each a tile of its own that writes the split's
  // slab of the output (0: one split over all of K)
  int splits;
  int split_chunks;
};

// Epilogue: q, k, v channel-major [M / tokens, C, tokens] (columns [0, C)
// of out go to q, [C, 2C) to k, [2C, 3C) to v; C % TN == 0, so a tile
// writes one of them). Where tokens % 8 == 0, staged through shared memory
// as [TN channels][64 tokens] per consumer so that each channel's run of
// tokens is written contiguously: by one TMA store of the box
// (asynchronous) where tokens % 64 == 0 (a consumer's 64 rows lie in one
// clip; maps[3] view q, k, v as [B*C rows][tokens]), else by 16-byte
// stores (every run starts 16-byte aligned). At odd lengths (rows TMA
// cannot address: its strides are multiples of 16 bytes), 2-byte stores
// from the accumulator.
struct QkvStore {
  bf16 *q, *k, *v;
  const CUtensorMap* maps;  // q, k, v (TMA stores), or null
  int C, tokens;
};

// Epilogue: row-major out [M, N] (TMA descriptor `map`, boxes of 64 x 64),
// bias added in f32, then GELU if asked, rounded to bf16 into 128-byte-
// swizzled staging boxes that TMA stores asynchronously.
struct RowStore {
  const CUtensorMap* map;
  int gelu;
};

// This consumer's f32 copy of the tile's bias, bsm[i] = bias[n0 + i] (0
// past N or without a bias): each thread fetches its share into registers
// when the tile starts (the loads' latency hides behind the products) and
// publishes it between barriers of its warpgroup in the epilogue (the last
// tile's readers are done before it is rewritten, all of it is written
// before it is read).
template <int TN>
struct TileBias {
  float v[(TN + 127) / 128];

  __device__ __forceinline__ void fetch(const bf16* bias, int N, int n0) {
    const int tid = threadIdx.x & 127;
#pragma unroll
    for (int j = 0; j < (TN + 127) / 128; ++j) {
      const int i = tid + 128 * j, col = n0 + i;
      v[j] = bias && i < TN && col < N ? __bfloat162float(bias[col]) : 0.f;
    }
  }

  __device__ __forceinline__ void publish(float* bsm, int cw) const {
    const int tid = threadIdx.x & 127;
    named_sync(2 + cw, 128);
#pragma unroll
    for (int j = 0; j < (TN + 127) / 128; ++j)
      if (tid + 128 * j < TN) bsm[tid + 128 * j] = v[j];
    named_sync(2 + cw, 128);
  }
};

template <int TN>
__device__ __forceinline__ void store_tile(const QkvStore& st,
                                           const DenseArgs& p,
                                           const float* acc, bf16* stg,
                                           const TileBias<TN>& bias,
                                           float* bsm, int row0, int n0,
                                           int cw, int rb, int lane,
                                           int /*split*/) {
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
  const int C = st.C, L = st.tokens;
  const int r0 = row0 + cw * 64;  // this warpgroup's first token row
  if (L % 8) {
    // odd lengths: 2-byte stores straight from the accumulator, rows g and
    // g + 8 of this warp (their clip and token worked out once a tile)
    bias.publish(bsm, cw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + rb + g + 8 * h;
      if (row >= p.M) continue;
      const int b = row / L;
      const size_t base = (size_t)b * C * L + (row - b * L);
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int c = 8 * j + 2 * t, col = n0 + c;
        if (col >= p.N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int which = (col + e >= C) + (col + e >= 2 * C);
          bf16* out = which == 0 ? st.q : (which == 1 ? st.k : st.v);
          out[base + (size_t)(col + e - which * C) * L] =
              __float2bfloat16(acc[4 * j + 2 * h + e] + bsm[c + e]);
        }
      }
    }
    return;
  }
  unsigned char* box = reinterpret_cast<unsigned char*>(stg) + cw * TN * 128;
  if (st.maps && tid == 0) bulk_wait_read();  // the last tile's stores left
  bias.publish(bsm, cw);  // (after its first barrier, staging is free too)
  const int r = rb - cw * 64 + g;  // token within this warpgroup's 64
  // element (channel c, token r) of the box
  auto at = [&](int c, int rr) {
    return reinterpret_cast<bf16*>(box + c * 128 +
                                   ((((rr >> 3) ^ (c & 7))) << 4) +
                                   (rr & 7) * 2);
  };
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = bsm[c], b1 = bsm[c + 1];
    *at(c, r) = __float2bfloat16(acc[4 * j] + b0);
    *at(c + 1, r) = __float2bfloat16(acc[4 * j + 1] + b1);
    *at(c, r + 8) = __float2bfloat16(acc[4 * j + 2] + b0);
    *at(c + 1, r + 8) = __float2bfloat16(acc[4 * j + 3] + b1);
  }
  if (st.maps) {
    fence_proxy_async();  // the staged box, visible to TMA
    named_sync(2 + cw, 128);
    if (tid == 0 && r0 < p.M) {
      const int which = n0 / C, b0 = r0 / L;
      tma_store(st.maps + which, box, r0 - b0 * L,
                b0 * C + n0 - which * C);
      bulk_commit();
    }
    return;
  }
  named_sync(2 + cw, 128);
  // 16-byte stores: each thread keeps one 8-token offset of the warpgroup's
  // 64 rows for the whole tile (128 threads stride over channels), so its
  // clip b and token l are worked out once; a channel's q / k / v by
  // comparison.
  const int rr = (tid & 7) * 8, row = r0 + rr;
  if (row >= p.M) return;
  const int b = row / L, l = row - b * L;
  for (int ch = tid >> 3; ch < TN; ch += 16) {
    const int col = n0 + ch;
    if (col >= p.N) break;
    const int which = (col >= C) + (col >= 2 * C);
    bf16* out = which == 0 ? st.q : (which == 1 ? st.k : st.v);
    *reinterpret_cast<uint4*>(out + ((size_t)b * C + (col - which * C)) * L +
                              l) = *reinterpret_cast<const uint4*>(at(ch, rr));
  }
}

// Row-major stores of a 64 x TN accumulator with bias (f32, bsm[i] the
// bias of column n0 + i) and GELU, from registers: the fused narrow MLP's
// output.
template <int TN>
__device__ __forceinline__ void store_rows(bf16* out, int M, int N,
                                           const float* bsm, bool gelu,
                                           const float* acc, int row0,
                                           int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r = row0 + g;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = 8 * j + 2 * t, col = n0 + c;
    if (col >= N) continue;
    const float b0 = bsm[c], b1 = bsm[c + 1];
    float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                  acc[4 * j + 3] + b1};
    if (gelu) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
    }
    if (r < M)
      *reinterpret_cast<uint32_t*>(out + (size_t)r * N + col) =
          pack_bf16(v[0], v[1]);
    if (r + 8 < M)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * N + col) =
          pack_bf16(v[2], v[3]);
  }
}

template <int TN>
__device__ __forceinline__ void store_tile(const RowStore& st,
                                           const DenseArgs& p,
                                           const float* acc, bf16* stg,
                                           const TileBias<TN>& bias,
                                           float* bsm, int row0, int n0,
                                           int cw, int rb, int lane,
                                           int /*split*/) {
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
  unsigned char* boxes =
      reinterpret_cast<unsigned char*>(stg) + cw * TN * 128;
  if (tid == 0) bulk_wait_read();  // the last tile's stores left staging
  bias.publish(bsm, cw);
  const int r = rb - cw * 64 + g;  // row within this warpgroup's 64
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = bsm[c], b1 = bsm[c + 1];
    float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                  acc[4 * j + 3] + b1};
    if (st.gelu) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
    }
    unsigned char* box = boxes + (j / 8) * 8192;
    *reinterpret_cast<uint32_t*>(
        reinterpret_cast<unsigned char*>(sw128_chunk(box, r, j % 8)) +
        4 * t) = pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(
        reinterpret_cast<unsigned char*>(sw128_chunk(box, r + 8, j % 8)) +
        4 * t) = pack_bf16(v[2], v[3]);
  }
  fence_proxy_async();  // the staged boxes, visible to TMA
  named_sync(2 + cw, 128);
  if (tid == 0) {
    for (int b = 0; b < TN / 64; ++b)
      tma_store(st.map, boxes + b * 8192, n0 + 64 * b, row0 + cw * 64);
    bulk_commit();
  }
}

// Epilogue: the f32 accumulator as it is (no bias), row-major into split
// `split`'s slab of out [splits][M][N], 8-byte stores straight from the
// registers (each row's 8-column run is one 32-byte sector): the dxn and
// split-K weight-gradient partials of the LN+MLP backward.
struct F32Store {
  float* out;
};

template <int TN>
__device__ __forceinline__ void store_tile(const F32Store& st,
                                           const DenseArgs& p,
                                           const float* acc, bf16* /*stg*/,
                                           const TileBias<TN>& /*bias*/,
                                           float* /*bsm*/, int row0, int n0,
                                           int /*cw*/, int rb, int lane,
                                           int split) {
  const int g = lane >> 2, t = lane & 3;
  float* out = st.out + (size_t)split * p.M * p.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rb + g + 8 * h;
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col < p.N)
        *reinterpret_cast<float2*>(out + (size_t)r * p.N + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// The producer's loads of a ring stage's A chunk [128][64] (column kc * 64,
// rows from row0): bytes(row0), the bytes they bring, and load(...), the
// TMA loads that complete on the stage's barrier. The rule: one box of 128
// rows of a row-major A (rows past its edge load as zero).
struct TmaRowsA {
  const CUtensorMap* map;

  __device__ __forceinline__ uint32_t bytes(int /*row0*/) const {
    return DENSE_BM * 128;
  }
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int kc,
                                       int row0) const {
    tma_load(dst, map, bar, kc * 64, row0);
  }
};

// q, k, v's TMA maps, each viewing a channel-major [B, C, tokens] tensor as
// [B*C rows][tokens], as one kernel argument.
struct QkvMaps {
  CUtensorMap m[3];
};

// The whole block: barrier set-up, then the producer or a consumer for
// every tile of this block's share of the queue. With LN, a consumer loads
// its A fragments from the chunk with ldmatrix, normalizes them in
// registers and issues wgmma with A from registers; the fragments are
// double-buffered, so the next chunk is loaded and normalized while this
// chunk's group is in flight. Without, A and B come from shared memory.
// The producer loads A by a_load (TmaRowsA, or a policy of the same shape).
template <int TN, bool LN, class Store, class ALoad>
__device__ __forceinline__ void dense_block(const ALoad& a_load,
                                            const CUtensorMap& map_b,
                                            const DenseArgs& p,
                                            const Store& st) {
  extern __shared__ unsigned char dense_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ((uintptr_t)dense_smem_raw + 1023) & ~(uintptr_t)1023);
  const int stage_bytes = dense_stage_bytes(TN, LN);
  const int kpad = dense_kpad(p.K);
  bf16* stg = reinterpret_cast<bf16*>(ring + p.stages * stage_bytes);
  float* gam = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(stg) +
                                        2 * TN * 128);
  float* bet = gam + kpad;
  float* bias_sm = gam + (LN ? 2 * kpad : 0);  // [2][TN]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_sm + 2 * TN);
  uint64_t* empty = full + DENSE_MAX_STAGES;
  constexpr int B_OFF = DENSE_BM * 128;  // B tile within a stage
  const int stats_off = B_OFF + TN * 128;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int nk = (p.K + 63) / 64;
  const int mn_tiles = ((p.M + DENSE_BM - 1) / DENSE_BM) * p.n_tiles;
  // split-K only without a LayerNorm (whose consumers walk all of K)
  const int nsplit = !LN && p.splits > 1 ? p.splits : 1;
  const int kps = nsplit > 1 ? p.split_chunks : nk;
  const int tiles = mn_tiles * nsplit;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  if constexpr (LN)
    for (int i = tid; i < kpad; i += DENSE_THREADS) {
      gam[i] = i < p.K ? __bfloat162float(p.gamma[i]) : 0.f;
      bet[i] = i < p.K ? __bfloat162float(p.beta[i]) : 0.f;
    }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile % mn_tiles / p.n_tiles) * DENSE_BM;
      const int n0 = (tile % p.n_tiles) * TN;
      const int kc0 = tile / mn_tiles * kps, kc1 = min(nk, kc0 + kps);
      for (int kc = kc0; kc < kc1; ++kc, ++it) {
        const int s = it % p.stages, round = it / p.stages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* a_t = ring + s * stage_bytes;
        const bool stats = LN && kc == 0;
        mbar_arrive_expect_tx(&full[s], a_load.bytes(row0) + TN * 128 +
                                            (stats ? 1024 : 0));
        a_load.load(a_t, &full[s], kc, row0);
        tma_load(a_t + B_OFF, &map_b, &full[s], kc * 64, n0);
        if (stats) bulk_load(a_t + stats_off, p.stats + row0, 1024, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;                           // consumer 0 or 1
  const int rb = cw * 64 + ((tid >> 5) & 3) * 16;  // this warp's 16 rows
  const int t = lane & 3;
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile % mn_tiles / p.n_tiles) * DENSE_BM;
    const int n0 = (tile % p.n_tiles) * TN;
    const int split = tile / mn_tiles;
    const int kc0 = split * kps, kc1 = min(nk, kc0 + kps);
    TileBias<TN> bias;
    bias.fetch(p.bias, p.N, n0);
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

    if constexpr (LN) {
      // statistics of rows rb + g and rb + g + 8, from the first chunk
      float mean[2], rstd[2];
      {
        const int s = it % p.stages;
        mbar_wait(&full[s], (it / p.stages) & 1);
        const float2* sv = reinterpret_cast<const float2*>(
            ring + s * stage_bytes + stats_off);
        const float2 m0 = sv[rb + (lane >> 2)], m1 = sv[rb + (lane >> 2) + 8];
        mean[0] = m0.x;
        rstd[0] = m0.y;
        mean[1] = m1.x;
        rstd[1] = m1.y;
      }
      // chunk kc's normalized A fragments into buffer b
      uint32_t a[2][4][4];
      auto load_a = [&](int b, int kc, int s) {
        mbar_wait(&full[s], ((it + kc) / p.stages) & 1);
        const unsigned char* a_t = ring + s * stage_bytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // past K: zeros, LN'd to zeros
          ldmatrix_sw128(a[b][kk], a_t, rb, kk, lane);
          ln_frag(a[b][kk], gam, bet, kc * 64 + kk * 16 + 2 * t, mean, rstd);
        }
      };
      const int s0 = it % p.stages;
      load_a(0, 0, s0);
      int prev = -1;
#pragma unroll 1
      for (int kc = 0; kc < nk; kc += 2) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {  // b == kc & 1, a compile-time index
          const int k = kc + b;
          if (k < nk) {
            const int s = (it + k) % p.stages;
            const uint64_t db = desc_sw128(ring + s * stage_bytes + B_OFF);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              WgmmaRS<TN>::mma(acc, a[b][kk], db + 2 * kk);
            wgmma_commit();
            wgmma_wait<1>();  // chunk k - 1's group is done: its A
            fence_regs<16>(&a[b ^ 1][0][0]);  // buffer is free again
            if (prev >= 0) release(prev);
            prev = s;
            if (k + 1 < nk) load_a(b ^ 1, k + 1, (it + k + 1) % p.stages);
          }
        }
      }
      wgmma_wait<0>();
      fence_regs<16>(&a[0][0][0]);
      fence_regs<16>(&a[1][0][0]);
      release(prev);
      it += nk;
    } else {
      int prev = -1;
      for (int kc = kc0; kc < kc1; ++kc, ++it) {
        const int s = it % p.stages;
        mbar_wait(&full[s], (it / p.stages) & 1);
        const unsigned char* a_t = ring + s * stage_bytes;
        const uint64_t da = desc_sw128(a_t + cw * 64 * 128);
        const uint64_t db = desc_sw128(a_t + B_OFF);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // past K: TMA's zero fill
          WgmmaSS<TN>::mma(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done
        if (prev >= 0) release(prev);
        prev = s;
      }
      wgmma_wait<0>();
      if (prev >= 0) release(prev);
    }
    fence_regs<TN / 2>(acc);
    store_tile<TN>(st, p, acc, stg, bias, bias_sm + cw * TN, row0, n0, cw,
                   rb, lane, split);
  }
  bulk_wait_done();  // this thread's asynchronous stores are complete
}

template <int TN, bool LN, class Store>
__device__ __forceinline__ void dense_block(const CUtensorMap& map_a,
                                            const CUtensorMap& map_b,
                                            const DenseArgs& p,
                                            const Store& st) {
  dense_block<TN, LN>(TmaRowsA{&map_a}, map_b, p, st);
}

// Host side of a dense launch, once per kernel (`ready` is the caller's
// flag): the kernel must have been compiled to the 168 registers a thread
// that setmaxnreg assumes (else the consumers' inc could wait forever), and
// may use all of a block's shared memory.
template <typename K>
inline cudaError_t prepare_dense(K kernel, bool& ready) {
  if (ready) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != 168) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
  ready = err == cudaSuccess;
  return err;
}

}  // namespace aicity
