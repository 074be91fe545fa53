// Fused multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces merlot_tpu/ops/pallas_attention.py `_flash_fwd` / `_attn_kernel`
// (the Pallas TPU kernel). It computes the same function:
//   per head h:  s   = (q_h . k_h^T) * scale        fp32 dot products
//                s   = round_sm(s)                  softmax dtype (fp32 or bf16)
//                s   = round_sm(s*m - 1e10*(1-m))   if a mask is given
//                p   = round_sm(softmax(s))         fp32 max/exp/sum
//                ctx = round_T(p) . v_h             fp32 accumulation, stored as T
//   colsum[b, k] = (1/H) * sum_h sum_{real q rows} p   (optional, fp32)
// on the natural [B, S, H*D] layout of q/k/v/ctx, so no transposes happen
// outside. The rounding points are the TPU kernel's: in the bf16-softmax
// mode the scores are rounded to bf16 before the mask and the softmax.
// That is why each tile keeps its full score rows (no online rescaling,
// which would move those rounding points).
//
// Design. One thread block per (q tile, head, batch element):
//   1. scores: K is streamed through shared memory in chunks of 64 keys,
//      and the tile's rounded, masked scores are written to shared memory
//      as full fp32 rows [tile rows, Sk];
//   2. softmax: one warp per row over the full row (max, exp, sum);
//   3. colsum: per-tile column sums go to a [B, H, n_tiles, Sk] buffer,
//      reduced by a second, deterministic kernel (no atomics); the probs
//      are rounded to T in place, since the value product's operand is
//      probs.astype(q.dtype);
//   4. ctx: V is streamed in chunks of 64 keys, accumulating in fp32.
// Two kernels share phases 2 and 3, both on 16-row tiles with 8 warps:
//   - attention_fwd_mma (bf16, head dim a multiple of 16): both products
//     run on the tensor cores as mma.sync.m16n8k16 bf16 -> fp32, with Q
//     held in registers and K/V staged row-major in shared memory with
//     16-byte loads (V's fragments are transposed by ldmatrix.trans);
//   - attention_fwd_fma (fp32): both products as fp32 FMAs from shared
//     memory. bf16 with another head dim is refused.
//
// What bounds it on the H100. Per head the two products cost
// 4*Sq*Sk*D flops against ~Sq*Sk exponentials, and the full score rows of
// a tile take rows*Sk*4 bytes of shared memory (57 KB at 16 rows and
// Sk=885). That caps the tile height, so each K/V chunk staged in shared
// memory serves only 16 query rows and K/V are re-read from L2 once per
// tile; the softmax makes three passes over the score rows in shared
// memory. With the products on mma.sync, the kernel is bound by those
// shared-memory passes and the per-tile K/V staging rather than by the
// tensor cores: it is latency-bound, so occupancy decides its speed. The
// 16-row tile keeps the score rows small; 8 warps per block (4 blocks, 32
// warps per SM) beat 4 warps at the zero-shot shapes, and 128- or 256-key
// staging chunks lost to 64 by costing resident blocks. wgmma on 64-row
// tiles with TMA-staged K/V is the next step.

#include "attention_common.cuh"

namespace {

using namespace merlot;

constexpr int kFmaThreads = 256;
constexpr int kFmaRowsPerThread = kQRows / 4;  // 4 row groups of 64 threads
constexpr int kFmaCols = kMaxHeadDim / 64;     // output columns per thread

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaWarpKeyTiles = kKeyChunk / 8 / kMmaWarps;  // 8-key tiles per warp
constexpr int kMmaMaxKSteps = kMaxHeadDim / 16;
constexpr int kMmaMaxTilesPerWarp = kMaxHeadDim / 8 / kMmaWarps;

// phase 3: per-tile colsum over real rows (softmax-dtype probs) into
// `part` (may be null), then the probs rounded to T in place
template <typename T>
__device__ void colsum_and_round(float* s_p, int ld, int rows, int Sk, float* part) {
  for (int j = threadIdx.x; j < Sk; j += blockDim.x) {
    float c = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float p = s_p[(size_t)r * ld + j];
      c += p;
      s_p[(size_t)r * ld + j] = round_as<T>(p);
    }
    if (part != nullptr) part[j] = c;
  }
}

// ---------------------------------------------------------------------------
// FMA kernel, fp32 (the softmax is fp32 too). Score rows have stride Sk.
__global__ void __launch_bounds__(kFmaThreads)
attention_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ colsum_part,
                  int Sq, int Sk, int H, int D, float scale) {
  constexpr int BQ = kQRows, RPT = kFmaRowsPerThread, NCOL = kFmaCols;
  extern __shared__ float smem[];
  float* s_q = smem;                          // [BQ][D]
  float* s_kv = s_q + BQ * D;                 // [kKeyChunk][D + 1]
  float* s_p = s_kv + kKeyChunk * (D + 1);    // [BQ][Sk]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);
  const size_t hd = (size_t)H * D;
  const int tid = threadIdx.x;
  const int col = tid % kKeyChunk;  // key column (phase 1) / d column (phase 4)
  const int rg = tid / kKeyChunk;   // row group; one per pair of warps
  const float* qb = q + ((size_t)b * Sq + q0) * hd + (size_t)h * D;
  const float* kb = k + (size_t)b * Sk * hd + (size_t)h * D;
  const float* vb = v + (size_t)b * Sk * hd + (size_t)h * D;

  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D, d = i % D;
    s_q[i] = r < rows ? qb[(size_t)r * hd + d] : 0.f;
  }

  // 1. scores of the tile, rounded and masked, into s_p
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    for (int i = tid; i < kKeyChunk * D; i += kFmaThreads) {
      const int j = i / D, d = i % D;
      s_kv[j * (D + 1) + d] = k0 + j < Sk ? kb[(size_t)(k0 + j) * hd + d] : 0.f;
    }
    __syncthreads();
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    const float* krow = s_kv + col * (D + 1);
    const float* qrow = s_q + rg * RPT * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(qrow[r * D + d], kv, acc[r]);
    }
    const int kk = k0 + col;
    if (kk < Sk) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = rg * RPT + r;
        s_p[row * Sk + kk] = masked_score(
            acc[r], row < rows ? mask : nullptr, ((size_t)b * Sq + q0 + row) * Sk,
            kk, scale, false);
      }
    }
  }
  __syncthreads();

  softmax_rows(s_p, Sk, rows, Sk, false);
  __syncthreads();
  colsum_and_round<float>(
      s_p, Sk, rows, Sk,
      colsum_part == nullptr
          ? nullptr
          : colsum_part + (((size_t)b * H + h) * gridDim.x + qt) * Sk);

  // 4. ctx = P . V, fp32 accumulation
  float acc[RPT][NCOL];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    const int n = min(kKeyChunk, Sk - k0);
    for (int i = tid; i < n * D; i += kFmaThreads) {
      const int j = i / D, d = i % D;
      s_kv[j * (D + 1) + d] = vb[(size_t)(k0 + j) * hd + d];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* vrow = s_kv + j * (D + 1);
      float vv[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int d = col + c * 64;
        vv[c] = d < D ? vrow[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float p = s_p[(rg * RPT + r) * Sk + k0 + j];
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }
  float* ob = out + ((size_t)b * Sq + q0) * hd + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = rg * RPT + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int d = col + c * 64;
      if (d < D) ob[(size_t)row * hd + d] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, D a multiple of 16, 16 query rows per block.
// Fragment layouts are those of mma.sync.m16n8k16 (row.col): lane = 4*g + t.

__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ mask,
                  bf16* __restrict__ out, float* __restrict__ colsum_part,
                  int Sq, int Sk, int H, int D, float scale, bool sm_bf16) {
  extern __shared__ float smem[];
  const int ld = mma_score_ld(Sk), kpad = mma_key_pad(Sk);
  const int ldt = D + 8;  // bf16 tile row stride: 16-byte rows, no bank conflicts
  float* s_p = smem;                                        // [16][ld] fp32
  bf16* s_q = reinterpret_cast<bf16*>(s_p + kQRows * ld);   // [16][ldt]
  bf16* s_kv = s_q + kQRows * ldt;                  // [kKeyChunk][ldt], K or V

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kQRows;
  const int rows = min(kQRows, Sq - q0);
  const size_t hd = (size_t)H * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)b * Sk * hd + (size_t)h * D;
  const bf16* vb = v + (size_t)b * Sk * hd + (size_t)h * D;
  const size_t mask_row0 = ((size_t)b * Sq + q0) * Sk;

  stage_rows(s_q, ldt, q + ((size_t)b * Sq + q0) * hd + (size_t)h * D, hd,
             kQRows, rows, D);
  __syncthreads();
  const int ksteps = D / 16;
  uint32_t qa[kMmaMaxKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kMmaMaxKSteps; ++ks) {
    if (ks < ksteps) {
      const bf16* p = s_q + g * ldt + ks * 16 + 2 * t;
      qa[ks][0] = ld32(p);
      qa[ks][1] = ld32(p + 8 * ldt);
      qa[ks][2] = ld32(p + 8);
      qa[ks][3] = ld32(p + 8 * ldt + 8);
    }
  }

  // 1. scores: warp w takes the w-th slice of each chunk's keys
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    stage_rows(s_kv, ldt, kb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kMmaWarpKeyTiles; ++nt) {
      const int key = (kKeyChunk / kMmaWarps) * warp + 8 * nt;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kMmaMaxKSteps; ++ks) {
        if (ks < ksteps) {
          const bf16* p = s_kv + (key + g) * ldt + ks * 16 + 2 * t;
          mma_bf16(c, qa[ks], ld32(p), ld32(p + 8));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e / 2);
        const int kk = k0 + key + 2 * t + (e % 2);
        if (kk < kpad) {
          s_p[row * ld + kk] =
              kk < Sk ? masked_score(c[e], row < rows ? mask : nullptr,
                                     mask_row0 + (size_t)row * Sk, kk, scale,
                                     sm_bf16)
                      : 0.f;
        }
      }
    }
  }
  __syncthreads();

  softmax_rows(s_p, ld, rows, Sk, sm_bf16);
  __syncthreads();
  colsum_and_round<bf16>(
      s_p, ld, rows, Sk,
      colsum_part == nullptr
          ? nullptr
          : colsum_part + (((size_t)b * H + h) * gridDim.x + qt) * Sk);

  // 4. ctx = P . V: warp w takes the 8-column output tiles w, w + kMmaWarps, ...
  const int d_tiles = D / 8;
  float acc[kMmaMaxTilesPerWarp][4];
#pragma unroll
  for (int i = 0; i < kMmaMaxTilesPerWarp; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int k0 = 0; k0 < kpad; k0 += kKeyChunk) {
    __syncthreads();
    stage_rows(s_kv, ldt, vb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    const int n_ks = min(kKeyChunk, kpad - k0) / 16;
    for (int ks = 0; ks < n_ks; ++ks) {
      const float* p0 = s_p + g * ld + k0 + ks * 16 + 2 * t;
      const float* p1 = p0 + 8 * ld;
      const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p1[0], p1[1]),
                             pack_bf16(p0[8], p0[9]), pack_bf16(p1[8], p1[9])};
      const bf16* vrow = s_kv + (ks * 16 + lane % 16) * ldt;
#pragma unroll
      for (int i = 0; i < kMmaMaxTilesPerWarp; ++i) {
        const int nt = warp + kMmaWarps * i;
        if (nt < d_tiles) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + nt * 8);
          mma_bf16(acc[i], a, b0, b1);
        }
      }
    }
  }
  bf16* ob = out + ((size_t)b * Sq + q0) * hd + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < kMmaMaxTilesPerWarp; ++i) {
    const int nt = warp + kMmaWarps * i;
    if (nt >= d_tiles) continue;
    const int c = nt * 8 + 2 * t;
    if (g < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)g * hd + c) = pack_bf16(acc[i][0], acc[i][1]);
    if (g + 8 < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(g + 8) * hd + c) =
          pack_bf16(acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------------------
// colsum[b, k] = (1/H) * sum over heads and q tiles of the per-tile sums
__global__ void colsum_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ colsum, int B, int H,
                                     int n_tiles, int Sk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * Sk) return;
  const int b = idx / Sk, j = idx % Sk;
  float total = 0.f;
  for (int h = 0; h < H; ++h) {
    const float* p = part + ((size_t)b * H + h) * n_tiles * Sk + j;
    float hs = 0.f;
    for (int t = 0; t < n_tiles; ++t) hs += p[(size_t)t * Sk];
    total += hs;
  }
  colsum[idx] = total / H;
}

size_t fma_smem(int Sk, int D) {
  return sizeof(float) *
         ((size_t)kQRows * D + (size_t)kKeyChunk * (D + 1) + (size_t)kQRows * Sk);
}

size_t mma_smem(int Sk, int D) {
  return sizeof(float) * kQRows * mma_score_ld(Sk) +
         sizeof(bf16) * (size_t)(kQRows + kKeyChunk) * (D + 8);
}

}  // namespace

extern "C" {

// Query rows per block; the caller sizes the colsum workspace as
// B * H * ceil(Sq / tile) * Sk floats.
int merlot_attention_fwd_q_tile(void) { return kQRows; }

// q/out: [B, Sq, H*D]; k/v: [B, Sk, H*D], all contiguous, fp32 (is_bf16=0)
// or bf16 (is_bf16=1, D a multiple of 16). mask: [B, Sq, Sk] fp32 or NULL.
// colsum_part/colsum: workspace and [B, Sk] fp32 output, both NULL when no
// colsum is wanted. Launches on `stream` and returns a cudaError_t (0 on
// success).
int merlot_attention_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* colsum_part,
                         void* colsum, int B, int Sq, int Sk, int H, int D,
                         int is_bf16, int softmax_fp32, float scale,
                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || Sq > kMaxSeq ||
      Sk > kMaxSeq || D > kMaxHeadDim || B > 65535 || H > 65535 ||
      (is_bf16 && D % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if ((colsum_part == nullptr) != (colsum == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = is_bf16 ? mma_smem(Sk, D) : fma_smem(Sk, D);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* part = static_cast<float*>(colsum_part);
  const dim3 grid((Sq + kQRows - 1) / kQRows, H, B);
  cudaError_t err;
  if (is_bf16) {
    err = launch(attention_fwd_mma, grid, kMmaThreads, smem, st,
                 static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), m, static_cast<bf16*>(out), part,
                 Sq, Sk, H, D, scale, softmax_fp32 == 0);
  } else {
    err = launch(attention_fwd_fma, grid, kFmaThreads, smem, st,
                 static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), m, static_cast<float*>(out), part,
                 Sq, Sk, H, D, scale);
  }
  if (err != cudaSuccess || colsum == nullptr) return (int)err;
  const int n_tiles = (Sq + kQRows - 1) / kQRows;
  const int threads = 256;
  const int blocks = (B * Sk + threads - 1) / threads;
  colsum_reduce_kernel<<<blocks, threads, 0, st>>>(
      part, static_cast<float*>(colsum), B, H, n_tiles, Sk);
  return (int)cudaGetLastError();
}

}  // extern "C"
