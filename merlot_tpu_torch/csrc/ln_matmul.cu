// LayerNorm fused into its consumer matmuls, for Hopper (sm_90a), plain C
// interface.
//
// Replaces merlot_tpu/ops/pallas_ln_matmul.py `_ln_mm_pallas` /
// `_ln_mm_kernel` (the Pallas TPU kernel, K5). Per row of x [M, K] (bf16):
//   mean = sum(x) / K,  var = sum((x - mean)^2) / K        fp32, two terms
//   rstd = rsqrt(var + eps),  s_k = rstd * gamma_k
//   z_k  = bf16(x_k * s_k - mean * s_k + beta_k)
// then for each consumer j and column n:
//   y[j, m, n] = bf16(bf16(sum_k z[m, k] * W[j*N + n, k]) + bias[j*N + n])
// with the sum in fp32. The fp32 steps of z are the plain version's
// (norms.layer_norm), one rounding each (_rn intrinsics, so nvcc contracts
// none into an FMA); only the order of the sums differs. z is never
// written to device memory. W is the J consumers' [N, K] weights stacked
// (the port's DenseTN.weight is [out, in]: K-major, wgmma's B operand as it
// stands, so there is no transpose).
//
// Design: a persistent, warp-specialized wgmma kernel on clusters of two
// blocks that share W through TMA multicast.
//   - Work: the (128-row pair block, 256-column tile) units of the output in
//     row-major order, cut into one contiguous range per cluster (the launch
//     plan, cuda_ln_matmul.launch_plan, picks the cluster count: as many as
//     the card holds at once). Both blocks of a cluster walk the same units;
//     block rank r takes rows 64 r .. 64 r + 63 of each pair block. A block
//     computes z of its rows once per pair block and keeps it for all the
//     columns of its range in that pair block.
//   - Block: a producer warpgroup (one thread issues every TMA load; its
//     registers lowered to 40 by setmaxnreg) and two consumer warpgroups
//     (raised to 232), each 64 rows x 128 of the tile's 256 columns.
//   - z: the producer loads the block's 64 x rows by TMA straight into z's
//     place in shared memory, in wgmma's K-major layout with the 128-byte
//     swizzle (64-column blocks of 64 rows, as K1's Q and K tiles); the
//     consumer warps normalize the rows in place (a warp takes two rows at
//     a time: lane sums over two accumulators, then a butterfly, a fixed
//     order; the loops stay rolled, since unrolled they bloated the kernel
//     and cost more than the LayerNorm itself), so z is written once per
//     pair block and read by wgmma as the A operand for every column tile. Rows
//     past M arrive as zeros (the tensor map's bound), are not normalized
//     and never written. 64 rows of z take 96 KB at K = 768, 128 KB at 1024.
//   - W: 256 rows x 64 k per stage (32 KB), a ring of the most stages that
//     fit beside z and the output tiles (3 at K = 768; 4 up to K = 512, 2
//     past 768) with full/empty mbarriers. Each block's producer loads half
//     of a stage (128 W rows) and multicasts it to both blocks, so each W
//     byte read from L2 serves 128 rows; a stage is refilled only when the
//     consumers of both blocks have released it (every consumer warp
//     arrives on the empty barrier of both blocks). Each consumer
//     warpgroup runs 4 wgmma m64n128k16 per stage, keeping one stage's
//     products in flight while it issues the next. The producer issues the
//     next pair block's first W stages before it waits for z to be free.
//   - Epilogue: fp32 sums rounded to bf16, the bf16 bias added in fp32 and
//     rounded again, into the warpgroup's 64 x 128 tile in shared memory
//     (two 64-column boxes in the 128-byte swizzle), which one thread
//     stores to out [J, M, N] by TMA (rows past M dropped by the map) and
//     which drains while the next unit's products run. Where N is not a
//     multiple of 64 (a box would straddle two consumers) the threads store
//     from registers instead. No atomics: every output element is one
//     block's fixed-order sum, so runs are deterministic.
//
// What bounds it on the H100: operations, 2*M*K*J*N (120.5 GFLOP at the
// pretrain ViT's q/k/v, 0.122 ms at 989 TFLOP/s). In practice the stream
// of W into shared memory does: each SM takes a 32 KB stage per 64 x 256 x
// 64 products (64 flops per delivered byte), and the LayerNorm phase and
// the epilogue stall that stream, since the ring beside 96 KB of z cannot
// cover them. Builds of this file without its products, without its
// LayerNorm and without its stores, timed on an H100, showed the products
// costing the least of the three. A single block of 128 rows
// (z 192 KB) left room for two 16 KB stages and ran at ~21% of the peak. A
// form that streamed x with W and made z stage by stage (128 rows per
// block, 87 flops per delivered byte) needed two 128-column accumulators
// per thread, spilled at the 168 registers a 384-thread block allows and
// ran slower. The first design (mma.sync, cp.async from every thread, the
// LayerNorm recomputed for every 768-column group) ran ~10x its bound.
// fp32 inputs and K > 1024 are refused.

#include "attention_common.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

using namespace merlot;
using namespace merlot::sm90;

constexpr int kCluster = 2;                 // blocks sharing each W stage
constexpr int kRows = 64;                   // rows of x per block
constexpr int kTileN = 256;                 // output columns per tile
constexpr int kWgN = kTileN / 2;            // columns per consumer warpgroup
constexpr int kKBlock = 64;                 // k per W stage and per z column block
constexpr int kMaxStages = 4;               // W stages in the ring, at most
constexpr int kMaxK = 1024;

constexpr int kThreads = 384;               // producer + two consumer warpgroups
constexpr uint32_t kZBlock = kRows * 128;   // [64 rows][64 k] bf16, swizzled
constexpr uint32_t kWStage = kTileN * 128;  // [256 rows][64 k] bf16, swizzled
constexpr uint32_t kWHalf = kWStage / kCluster;  // the part one block loads
constexpr uint32_t kOutBox = 64 * 128;      // [64 rows][64 columns] bf16, swizzled
constexpr uint32_t kOutStage = 2 * kOutBox * 2;  // both warpgroups' 64 x 128 tiles

// dynamic shared memory of a block: z, the W ring, the output tiles, the
// barriers (full and empty per stage, x landed, z free)
size_t smem_bytes(int stages, int K) {
  return kSmemAlign + (size_t)(K / kKBlock) * kZBlock + (size_t)stages * kWStage +
         kOutStage + (2 * kMaxStages + 2) * sizeof(uint64_t);
}

// the 16-byte chunk q (k = 8q .. 8q + 7) of z's row r, in the swizzled
// blocks: column block q / 8, chunk q % 8 XOR row % 8
__device__ __forceinline__ uint8_t* z_chunk(uint8_t* s_z, int r, int q) {
  return s_z + (size_t)(q / 8) * kZBlock + r * 128 + (((q % 8) ^ (r % 8)) << 4);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// rows r and r + 8 (if real1) of the staged x, normalized into z in place
// by one warp: the two rows' steps interleaved, each row's sums in lane
// order over two accumulators, then a butterfly (a fixed order). Each pass
// reads the rows again from shared memory, so the loops stay rolled and
// the kernel's code small.
__device__ __forceinline__ void layer_norm_rows(uint8_t* s_z, int r, bool real1, int K,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta,
                                                float eps) {
  const int lane = threadIdx.x % 32, nq = K / 8;
  const int r1 = real1 ? r + 8 : r;  // a lone row computes itself twice
  const float kf = (float)K;
  float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll 1
  for (int q = lane; q < nq; q += 32) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(z_chunk(s_z, u ? r1 : r, q)), v);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        s0[u] += v[e];
        s1[u] += v[e + 1];
      }
    }
  }
  float mean[2], q0[2] = {0.f, 0.f}, q1[2] = {0.f, 0.f}, rstd[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) mean[u] = __fdiv_rn(warp_sum(s0[u] + s1[u]), kf);
#pragma unroll 1
  for (int q = lane; q < nq; q += 32) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(z_chunk(s_z, u ? r1 : r, q)), v);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float d0 = __fsub_rn(v[e], mean[u]);
        const float d1 = __fsub_rn(v[e + 1], mean[u]);
        q0[u] += d0 * d0;
        q1[u] += d1 * d1;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    rstd[u] = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q0[u] + q1[u]), kf), eps));
#pragma unroll 1
  for (int q = lane; q < nq; q += 32) {
    const int c = 8 * q;
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(beta + c);
    const float4 b1 = *reinterpret_cast<const float4*>(beta + c + 4);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !real1) break;
      uint8_t* chunk = z_chunk(s_z, u ? r1 : r, q);
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(chunk), v);
      uint4 out;
      uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float z[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sc = __fmul_rn(rstd[u], g[e + h]);
          z[h] = __fadd_rn(__fsub_rn(__fmul_rn(v[e + h], sc), __fmul_rn(mean[u], sc)),
                           b[e + h]);
        }
        w[e / 2] = pack_bf16(z[0], z[1]);
      }
      *reinterpret_cast<uint4*>(chunk) = out;
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    ln_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_out, int tma_out,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int K,
                     int N, int JN, int stages, float eps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_z = aligned_smem(smem_raw);
  const int nkb = K / kKBlock;
  uint8_t* s_w = s_z + (size_t)nkb * kZBlock;
  uint8_t* s_out = s_w + (size_t)stages * kWStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_out + kOutStage);
  uint64_t* empty = full + kMaxStages;
  uint64_t* x_full = empty + kMaxStages;
  uint64_t* z_free = x_full + 1;

  const int rank = (int)(blockIdx.x % kCluster);
  const int cluster = (int)(blockIdx.x / kCluster), n_clusters = gridDim.x / kCluster;
  const int col_tiles = (JN + kTileN - 1) / kTileN;
  const long long total = (long long)((M + kCluster * kRows - 1) / (kCluster * kRows)) *
                          col_tiles;
  const long long t0 = total * cluster / n_clusters;
  const long long t1 = total * (cluster + 1) / n_clusters;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCluster * 8);  // every consumer warp of the cluster
    }
    mbar_init(x_full, 1);
    mbar_init(z_free, 1);
    mbar_init_fence();
  }
  // both blocks' barriers exist before either block touches the other's
  cluster_arrive();
  cluster_wait();

  if (threadIdx.x < 128) {
    // ---- producer: thread 0 issues the loads in the consumers' order
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int first = stages < nkb ? stages : nkb;  // W stages before x
      int stage = 0, n_x = 0;
      uint32_t phase = 0;
      for (long long i = t0; i < t1; ++i) {
        const int rp = (int)(i / col_tiles), ct = (int)(i % col_tiles);
        const bool new_rows = i == t0 || ct == 0;
        for (int kb = 0; kb < nkb; ++kb) {
          // the stage is free in both blocks; this block's half of it goes
          // to both
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kWStage);
          uint8_t* dst = s_w + (size_t)stage * kWStage + rank * kWHalf;
          const int w_row = ct * kTileN + rank * (kTileN / kCluster);
          tma_load_multicast(dst, &tm_w, &full[stage], kb * kKBlock, w_row, 0, 0x3);
          tma_load_multicast(dst + kWHalf / 2, &tm_w, &full[stage], kb * kKBlock,
                             w_row + 64, 0, 0x3);
          if (++stage == stages) stage = 0, phase ^= 1;
          if (new_rows && kb == first - 1) {
            // x of the block's rows into z's place, once its consumers are
            // done with the previous pair block's z
            if (n_x > 0) mbar_wait(z_free, (n_x - 1) & 1);
            mbar_expect_tx(x_full, (uint32_t)nkb * kZBlock);
            for (int b = 0; b < nkb; ++b)
              tma_load(s_z + (size_t)b * kZBlock, &tm_x, x_full, b * kKBlock,
                       rp * kCluster * kRows + rank * kRows, 0);
            ++n_x;
          }
        }
      }
    }
    __syncwarp();
    cluster_arrive();  // the peer is done with this block's barriers and ring
    cluster_wait();
  } else {
    // ---- consumers: warpgroup wg owns columns kWgN wg .. of each tile
    setmaxnreg_inc<232>();
    const int ctid = threadIdx.x - 128, wg = ctid / 128, tid = ctid % 128;
    const int cwarp = ctid / 32, lane = ctid % 32;
    int stage = 0, n_x = 0;
    uint32_t phase = 0;
    float acc[kWgN / 2];
    for (long long i = t0; i < t1; ++i) {
      const int rp = (int)(i / col_tiles), ct = (int)(i % col_tiles);
      const int m0 = rp * kCluster * kRows + rank * kRows;
      if (i == t0 || ct == 0) {
        if (n_x > 0) {
          // every consumer is done with z (its products waited for)
          fence_async_shared();
          named_sync(1, 256);
          if (ctid == 0) mbar_arrive(z_free);
        }
        mbar_wait(x_full, n_x & 1);
        ++n_x;
        // warp w: rows w + 16 p and w + 16 p + 8
        for (int r = cwarp; r < kRows; r += 16)
          if (m0 + r < M)
            layer_norm_rows(s_z, r, m0 + r + 8 < M, K, gamma, beta, eps);
        fence_async_shared();  // z's writes, seen by wgmma
        named_sync(1, 256);
      }
      // one stage's products stay in flight while the next stage's issue:
      // a stage is released once the products after it were issued and
      // its own are done
      zero(acc);
      int prev = -1;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* w_wg = s_w + (size_t)stage * kWStage + wg * (kWgN * 128);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kKBlock / 16; ++ks)
          Wgmma<kWgN>::ss<0, 0>(acc,
                                desc(s_z + kb * kZBlock + 32 * ks, 16, 1024, kSwizzle128),
                                desc(w_wg + 32 * ks, 16, 1024, kSwizzle128));
        wg_commit();
        if (prev >= 0) {
          wg_wait<1>();
          if (lane == 0)
            for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[prev], r);
        }
        prev = stage;
        if (++stage == stages) stage = 0, phase ^= 1;
      }
      wg_wait_all();
      reg_fence(acc);
      if (lane == 0)
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[prev], r);

      // round, add the bias, round, and write [J, M, N]: where N is a
      // multiple of 64, through the warpgroup's tile in shared memory (the
      // 128-byte swizzle of K1's tiles) and two TMA stores, which drain
      // while the next unit's products run; else straight from registers
      const int n0 = ct * kTileN + wg * kWgN;
      uint8_t* s_tile = s_out + wg * 2 * kOutBox;
      if (tma_out) {
        if (tid == 0) bulk_wait_read<0>();  // the last unit's stores read it
        named_sync(2 + wg, 128);
      }
#pragma unroll
      for (int j = 0; j < kWgN / 8; ++j) {
        const int col = n0 + acc_col(tid, j, 0);
        const float2 b2 = col < JN ? __bfloat1622float2(
                                         *reinterpret_cast<const __nv_bfloat162*>(bias + col))
                                   : make_float2(0.f, 0.f);
        const int cons = col / N, n = col - cons * N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = acc_row(tid, half), row = m0 + r;
          const uint32_t y = pack_bf16(__fadd_rn(round_as<bf16>(acc[4 * j + 2 * half]), b2.x),
                                       __fadd_rn(round_as<bf16>(acc[4 * j + 2 * half + 1]), b2.y));
          if (tma_out)
            *reinterpret_cast<uint32_t*>(s_tile + (j / 8) * kOutBox + r * 128 +
                                         (((j % 8) ^ (r % 8)) << 4) + 4 * (tid % 4)) = y;
          else if (row < M && col < JN)
            *reinterpret_cast<uint32_t*>(out + ((size_t)cons * M + row) * N + n) = y;
        }
      }
      if (tma_out) {
        fence_async_shared();  // the tile's writes, seen by the TMA store
        named_sync(2 + wg, 128);
        if (tid == 0) {
          for (int b = 0; b < 2; ++b) {
            const int col = n0 + 64 * b;
            if (col >= JN) break;
            const int cons = col / N;
            tma_store(&tm_out, s_tile + b * kOutBox, col - cons * N, m0, cons);
          }
          bulk_commit();
        }
      }
    }
    if (tma_out && tid == 0) bulk_wait<0>();
    cluster_arrive();
    cluster_wait();
  }
}

// W stages of the ring at depth K (the deepest that fits beside z), or 0
// for a K the kernel refuses
int stages_for(int K) {
  if (K <= 0 || K % kKBlock != 0 || K > kMaxK) return 0;
  for (int s = kMaxStages; s >= 2; --s)
    if (smem_bytes(s, K) <= kMaxSmem) return s;
  return 0;
}

}  // namespace

extern "C" {

// The dynamic shared memory of a block at depth K (the launch plan's
// check), or 0 for a K the kernel refuses
long merlot_ln_matmul_smem(int K) {
  const int s = stages_for(K);
  return s == 0 ? 0 : (long)smem_bytes(s, K);
}

// Clusters of two blocks the card holds at once (0: none), or -1 if the
// query failed
int merlot_ln_matmul_max_clusters(int K) {
  const long smem = merlot_ln_matmul_smem(K);
  if (smem == 0 ||
      cudaFuncSetAttribute(ln_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, ln_matmul_kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// x: [M, K] bf16; w: [J*N, K] bf16 (the J consumers' [N, K] weights
// stacked); bias: [J*N] bf16; gamma/beta: [K] fp32; out: [J, M, N] bf16. All
// contiguous, x and w 16-byte aligned; K a multiple of 64 up to 1024, N a
// multiple of 8. clusters (persistent clusters of two blocks, at most the
// number of (pair block, column tile) units) comes from the launch plan.
// Launches on `stream` and returns a cudaError_t (0 on success).
int merlot_ln_matmul(const void* x, const void* gamma, const void* beta, const void* w,
                     const void* bias, void* out, int M, int K, int N, int J, float eps,
                     int clusters, void* stream) {
  const long smem = merlot_ln_matmul_smem(K);
  if (M <= 0 || smem == 0 || N <= 0 || N % 8 != 0 || J <= 0 || (long)J * N > (1L << 30))
    return (int)cudaErrorInvalidValue;
  const int JN = J * N;
  const long long units = (long long)((M + kCluster * kRows - 1) / (kCluster * kRows)) *
                          ((JN + kTileN - 1) / kTileN);
  if (clusters <= 0 || clusters > units) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, to = {};
  const int tma_out = N % 64 == 0;
  cudaError_t err = make_tile_map(&tx, x, 1, M, K, kKBlock);
  if (err == cudaSuccess) err = make_tile_map(&tw, w, 1, JN, K, kKBlock);
  if (err == cudaSuccess && tma_out) err = make_tile_map(&to, out, J, M, N, 64);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(ln_matmul_kernel, dim3(kCluster * clusters), kThreads, (size_t)smem,
                     static_cast<cudaStream_t>(stream), tx, tw, to, tma_out,
                     static_cast<const float*>(gamma), static_cast<const float*>(beta),
                     static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, K, N, JN,
                     stages_for(K), eps);
}

}  // extern "C"
