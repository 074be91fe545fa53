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
// (the port's DenseTN.weight is [out, in], which is the column-major B
// operand of mma.sync as it stands, so there is no transpose).
//
// Design. One block of 8 warps per (64-row block of x, group of up to six
// 128-column tiles of the J*N outputs):
//   1. the block's 64 rows of x go to shared memory with cp.async (rows past
//      M zero-filled and never written back), with the first W chunks;
//   2. one warp per row computes the row's mean and variance from shared
//      memory (lane sums, then a butterfly: a fixed order) and overwrites
//      the row with z in place: 64 x (K + 8) bf16, 99 KB at K = 768, held
//      for all the block's tiles (dynamic shared memory above 48 KB);
//   3. W streams through three 128 x 64 bf16 buffers (cp.async, two chunks
//      ahead, on across the tiles), one barrier per chunk, while each warp
//      runs mma.sync.m16n8k16 bf16 -> fp32 on a 32 x 32 tile of the output,
//      fragments read from shared memory with 32-bit loads (row strides of
//      4 words mod 32 banks: no conflicts);
//   4. at a tile's last chunk the fp32 sums are rounded to bf16, the bf16
//      bias added in fp32 and rounded again, and written to out [J, M, N].
// Rows past M are masked: not read, not written.
//
// What bounds it on the H100: operations, 2*M*K*J*N (120.5 GFLOP at the
// pretrain ViT's q/k/v, 0.122 ms at 989 TFLOP/s). This simple form keeps
// one block per SM (151 KB of shared memory) and reads each W tile from L2
// once per 64 rows (about 2 bytes per 43 flops): it is bound by L2 traffic
// and mma.sync issue, far from the tensor cores' peak. A first form with
// one tile per block recomputed the LayerNorm 18 to 24 times per row and
// kept one W chunk in flight; it ran 20x its bound. wgmma on 64-row tiles
// with TMA-staged W and a persistent grid is the open speed work. fp32
// inputs are refused (no config on the port's paths runs them).

#include "attention_common.cuh"

namespace {

using namespace merlot;

constexpr int kRows = 64;          // rows of x per block
constexpr int kCols = 128;         // output columns per block
constexpr int kKChunk = 64;        // depth of one staged W chunk
constexpr int kThreads = 256;      // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int kMaxK = 1024;
constexpr int kWLd = kKChunk + 8;  // W chunk row stride: 36 words, 4 mod 32
constexpr int kStages = 3;         // W chunks in flight or in use
constexpr int kMaxTilesPerBlock = 6;  // column tiles one block's z serves

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// W rows [n0, n0 + kCols) x depth [k0, k0 + kKChunk) into ws (row stride
// kWLd); rows past JN are zero-filled
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* W, int n0, int k0, int JN,
                                        int K) {
  constexpr int vecs = kKChunk / 8;
  for (int i = threadIdx.x; i < kCols * vecs; i += kThreads) {
    const int r = i / vecs, c = 8 * (i % vecs);
    const bool valid = n0 + r < JN;
    cp_async16(ws + r * kWLd + c, valid ? W + (size_t)(n0 + r) * K + k0 + c : W, valid);
  }
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

__global__ void __launch_bounds__(kThreads, 1)
    ln_matmul_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const bf16* __restrict__ W,
                     const bf16* __restrict__ bias, bf16* __restrict__ out, int M,
                     int K, int N, int JN, int tiles_per_block, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int zld = K + 8;  // z row stride: K/2 + 4 words, 4 mod 32
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][zld]
  bf16* wbuf = zs + kRows * zld;                 // [kStages][kCols][kWLd]
  const int m0 = blockIdx.y * kRows;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int n_tiles = min(tiles_per_block, (JN + kCols - 1) / kCols - tile0);
  const int nk = K / kKChunk;
  const int n_chunks = n_tiles * nk;  // W chunks over the block's tiles, in order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // chunk c: W rows of tile tile0 + c / nk, depth (c % nk) * kKChunk
  auto stage = [&](int c) {
    if (c < n_chunks)
      stage_w(wbuf + (c % kStages) * kCols * kWLd, W, (tile0 + c / nk) * kCols,
              (c % nk) * kKChunk, JN, K);
    cp_async_commit();  // an empty group past the end keeps the counts even
  };

  // 1. x rows, then the first kStages - 1 W chunks
  const int kvecs = K / 8;
  for (int i = threadIdx.x; i < kRows * kvecs; i += kThreads) {
    const int r = i / kvecs, c = 8 * (i % kvecs);
    const bool valid = m0 + r < M;
    cp_async16(zs + r * zld + c, valid ? x + (size_t)(m0 + r) * K + c : x, valid);
  }
  cp_async_commit();
  for (int c = 0; c < kStages - 1; ++c) stage(c);
  cp_async_wait<kStages - 1>();  // x has landed
  __syncthreads();

  // 2. LayerNorm in place, one warp per row
  const float kf = (float)K;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    if (m0 + r >= M) continue;  // a zero row stays zero
    bf16* row = zs + r * zld;
    float s = 0.f;
    for (int c = 8 * lane; c < K; c += 256) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(row + c), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[i];
    }
    const float mean = __fdiv_rn(warp_sum(s), kf);
    float q = 0.f;
    for (int c = 8 * lane; c < K; c += 256) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(row + c), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = __fsub_rn(v[i], mean);
        q += d * d;
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), kf), eps));
    for (int c = 8 * lane; c < K; c += 256) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(row + c), v);
      uint4 u;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sc = __fmul_rn(rstd, gamma[c + i + e]);
          z[e] = __fadd_rn(__fsub_rn(__fmul_rn(v[i + e], sc), __fmul_rn(mean, sc)),
                           beta[c + i + e]);
        }
        w[i / 2] = pack_bf16(z[0], z[1]);
      }
      *reinterpret_cast<uint4*>(row + c) = u;
    }
  }

  // 3. the products, tile after tile, W streamed through kStages buffers
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  float acc[2][4][4];
  for (int c = 0; c < n_chunks; ++c) {
    const int kc = c % nk;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    cp_async_wait<kStages - 2>();  // chunk c has landed
    // every warp is done with chunk c - 1, whose buffer the next stage
    // refills (and, the first time, z is written)
    __syncthreads();
    stage(c + kStages - 1);
    const bf16* wcur = wbuf + (c % kStages) * kCols * kWLd;
#pragma unroll
    for (int ks = 0; ks < kKChunk / 16; ++ks) {
      const int kz = kc * kKChunk + ks * 16;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* p = zs + (wm * 32 + mt * 16 + g) * zld + kz + 2 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * zld);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * zld + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* q = wcur + (wn * 32 + nt * 8 + g) * kWLd + ks * 16 + 2 * t;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    if (kc != nk - 1) continue;

    // 4. the tile is done: round, add the bias, write [J, M, N]
    const int n0 = (tile0 + c / nk) * kCols;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
      if (col >= JN) continue;
      const int j = col / N, n = col % N;
      const float b0 = to_float(bias[col]), b1 = to_float(bias[col + 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm * 32 + mt * 16 + g + 8 * half;
          if (row >= M) continue;
          const float y0 = __fadd_rn(round_as<bf16>(acc[mt][nt][2 * half]), b0);
          const float y1 = __fadd_rn(round_as<bf16>(acc[mt][nt][2 * half + 1]), b1);
          *reinterpret_cast<uint32_t*>(out + ((size_t)j * M + row) * N + n) =
              pack_bf16(y0, y1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: [M, K] bf16; w: [J*N, K] bf16 (the J consumers' [N, K] weights
// stacked); bias: [J*N] bf16; gamma/beta: [K] fp32; out: [J, M, N] bf16. All
// contiguous, x and w 16-byte aligned; K a multiple of 64 up to 1024, N a
// multiple of 8. Launches on `stream` and returns a cudaError_t (0 on
// success).
int merlot_ln_matmul(const void* x, const void* gamma, const void* beta, const void* w,
                     const void* bias, void* out, int M, int K, int N, int J, float eps,
                     void* stream) {
  if (M <= 0 || K <= 0 || K % kKChunk != 0 || K > kMaxK || N <= 0 || N % 8 != 0 ||
      J <= 0 || (long)J * N > (1L << 30))
    return (int)cudaErrorInvalidValue;
  const int JN = J * N;
  // column tiles per block: groups of at most kMaxTilesPerBlock, as even as
  // they can be (18 tiles of q/k/v: 3 groups of 6; 24 of the MLP: 4 of 6)
  const int tiles = (JN + kCols - 1) / kCols;
  const int groups = (tiles + kMaxTilesPerBlock - 1) / kMaxTilesPerBlock;
  const int per_block = (tiles + groups - 1) / groups;
  const dim3 grid((tiles + per_block - 1) / per_block, (M + kRows - 1) / kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kRows * (K + 8) + (size_t)kStages * kCols * kWLd) * sizeof(bf16);
  return (int)launch(ln_matmul_kernel, grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream), static_cast<const bf16*>(x),
                     static_cast<const float*>(gamma), static_cast<const float*>(beta),
                     static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
                     static_cast<bf16*>(out), M, K, N, JN, per_block, eps);
}

}  // extern "C"
