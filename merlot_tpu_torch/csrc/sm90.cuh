// Hopper building blocks of the attention kernels, K4 and K5: TMA tile
// loads and bulk copies with mbarriers, wgmma shared-memory descriptors and
// fences, and the tensor maps (built on the host through the driver's
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint so that
// nothing links against libcuda).
//
// Tiles. A tile is 64 rows x D columns of bf16 (D a multiple of 16), staged
// by TMA as column blocks of [64 rows][W columns]: W = 64 (128-byte rows,
// CU_TENSOR_MAP_SWIZZLE_128B) when D is a multiple of 64, else W = 16
// (32-byte rows and swizzle), so every head dim the kernels take has a
// layout. wgmma reads them through descriptors of the same swizzle:
//   - K-major operand (rows are M or N, D is the k dimension): k16 step ks
//     starts 32 bytes per step into its block, SBO = 8 rows;
//   - MN-major operand (rows are the k dimension, D is N): step kk starts
//     at row 16 kk, LBO = the block stride, SBO = 8 rows.
// Operands written by threads (K2's P and dS) use the interleaved layout
// (no swizzle): 8x8 core matrices of 128 contiguous bytes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace merlot {
namespace sm90 {

constexpr int kTileRows = 64;  // rows of a q, k or v tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transfers to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one plain arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into dst, both
// 16-byte aligned, counted on bar (announce them with mbar_expect_tx)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// waits for the barrier's phase of this parity; a load that never lands
// (a bad tensor map or byte count) traps after 10 s instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// box of the 3-D map at (column c0, row c1, batch c2) into dst; completion
// is counted on bar. Rows past the map's row count arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// tma_load into the same offset of every block of the cluster in `mask`
// (bit r: rank r), completion counted on the barrier at bar's offset in each
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1, int c2,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "h"(mask)
      : "memory");
}

// the 3-D map's box at (column c0, row c1, batch c2) from src, as a bulk
// group; rows and columns past the map's bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until at most N committed bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// waits until at most N committed bulk groups are still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// one arrival on the barrier at bar's offset in the cluster's block `rank`
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// the cluster barrier, in two halves: every thread of every block of the
// cluster arrives (release) and waits (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The column blocks of a D-column tile: 64 columns (128-byte rows, 128-byte
// swizzle) when D is a multiple of 64, else 16 (32-byte rows and swizzle).
__host__ __device__ constexpr int block_cols(int D) { return D % 64 == 0 ? 64 : 16; }

template <int D>
struct Tile {
  static constexpr int kCols = block_cols(D);
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr uint32_t kBlock = kTileRows * kRowBytes;  // one column block
  static constexpr uint32_t kBytes = (D / kCols) * kBlock;
};

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return Tile<D>::kBytes;
}

// rows [row0, row0 + 64) of one head's D columns (starting at column col0)
// of batch element b, as its column blocks
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int row0, int b) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < D / T::kCols; ++c)
    tma_load(dst + c * T::kBlock, map, bar, col0 + T::kCols * c, row0, b);
}

// thread writes to shared memory, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma

enum Layout : uint32_t { kInterleave = 0, kSwizzle128 = 1, kSwizzle32 = 3 };

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo,
                                         Layout layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

template <int D>
__host__ __device__ constexpr Layout tile_layout() {
  return Tile<D>::kCols == 64 ? kSwizzle128 : kSwizzle32;
}

// k16 step ks of a tile whose D columns are the k dimension: block
// 16 ks / cols, 32 bytes further per step inside a block's swizzled row
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int ks) {
  using T = Tile<D>;
  const int c = 16 * ks;
  return desc(tile + (c / T::kCols) * T::kBlock + (c % T::kCols) * 2, 16,
              8 * T::kRowBytes, tile_layout<D>());
}

// k16 step kk (rows 16 kk ..) of a tile whose rows are the k dimension and
// whose D columns are N: the blocks are LBO apart
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile, int kk) {
  using T = Tile<D>;
  return desc(tile + 16 * kk * T::kRowBytes, T::kBlock, 8 * T::kRowBytes,
              tile_layout<D>());
}

// k16 step kk of a 64 x 64 interleaved tile written as
// offset(k, m) = (m / 8) * 1024 + (k / 8) * 128 + (k % 8) * 16 + (m % 8) * 2:
// m (the output rows) contiguous in each 16-byte core-matrix row
__device__ __forceinline__ uint64_t desc_interleave_mn(const uint8_t* tile, int kk) {
  return desc(tile + kk * 256, 128, 1024, kInterleave);
}

__device__ __forceinline__ uint32_t interleave_offset(int k, int m) {
  return (m / 8) * 1024 + (k / 8) * 128 + (k % 8) * 16 + (m % 8) * 2;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers of this warpgroup's threads, raised or lowered to R (every
// warp of the warpgroup runs it; a warp-specialized kernel's roles must not
// reconverge afterwards)
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// keeps the compiler from moving accesses to an accumulator across a wait
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Accumulator layout of m64nNk16 (fp32): thread tid of the warpgroup holds
// rows acc_row(tid, half) for half 0, 1 and, for each 8-column group j,
// columns 8j + 2 (tid % 4) + e, e = 0, 1, at d[4j + 2 half + e].
__device__ __forceinline__ int acc_row(int tid, int half) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * half;
}
__device__ __forceinline__ int acc_col(int tid, int j, int e) {
  return 8 * j + 2 * (tid % 4) + e;
}

// ---------------------------------------------------------------------------
// Tensor maps (host)

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn load_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                       cudaEnableDefault, &found) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                              &found) != cudaSuccess)
    return nullptr;
#endif
  return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(fn)
                                              : nullptr;
}

// The 3-D map of a bf16 [batch, rows, cols] tensor (contiguous, 16-byte
// aligned, cols a multiple of 8) in boxes of 64 rows x one column block of a
// head dim D (block_cols(D), swizzled to match). Rows past `rows` of a batch
// element read as zeros, never as the next element's rows.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, int batch, int rows,
                                 int cols, int D) {
  static const EncodeTiledFn encode = load_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const int bc = block_cols(D);
  const cuuint32_t box[3] = {(cuuint32_t)bc, (cuuint32_t)kTileRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            bc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dynamic shared memory, its start rounded up to 1024 bytes (the swizzle
// patterns repeat on address bits; the caller adds kSmemAlign to its size)
constexpr size_t kSmemAlign = 1024;

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t pad = (uint32_t)(kSmemAlign - (smem_u32(raw) & (kSmemAlign - 1))) &
                       (uint32_t)(kSmemAlign - 1);
  return raw + pad;
}

}  // namespace sm90
}  // namespace merlot
