// The tiled attention-forward kernels, shared by K1 (attention_fwd.cu) and
// the prefill path of K3 (attention_stacked.cu). attention_fwd.cu's header
// comment describes the design; the two callers differ only in layout:
//   - K/V rows are `kv_ld` elements apart: H*D for K1's separate k and v
//     tensors, 2*H*D for K3's stacked cache, whose values start at column
//     H*D of the same rows (the caller passes v = kv + H*D);
//   - the mask of batch element b starts at b * mask_bs: Sq*Sk for a
//     [B, Sq, Sk] mask, 0 for one [1, Sq, Sk] mask shared by the batch.

#pragma once

#include "attention_common.cuh"

namespace merlot {

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
                  int Sq, int Sk, int H, int D, int kv_ld, size_t mask_bs,
                  float scale) {
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
  const float* kb = k + (size_t)b * Sk * kv_ld + (size_t)h * D;
  const float* vb = v + (size_t)b * Sk * kv_ld + (size_t)h * D;
  const size_t mask_row0 = (size_t)b * mask_bs + (size_t)q0 * Sk;

  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D, d = i % D;
    s_q[i] = r < rows ? qb[(size_t)r * hd + d] : 0.f;
  }

  // 1. scores of the tile, rounded and masked, into s_p
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    for (int i = tid; i < kKeyChunk * D; i += kFmaThreads) {
      const int j = i / D, d = i % D;
      s_kv[j * (D + 1) + d] = k0 + j < Sk ? kb[(size_t)(k0 + j) * kv_ld + d] : 0.f;
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
            acc[r], row < rows ? mask : nullptr, mask_row0 + (size_t)row * Sk,
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
      s_kv[j * (D + 1) + d] = vb[(size_t)(k0 + j) * kv_ld + d];
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
                  int Sq, int Sk, int H, int D, int kv_ld, size_t mask_bs,
                  float scale, bool sm_bf16) {
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
  const bf16* kb = k + (size_t)b * Sk * kv_ld + (size_t)h * D;
  const bf16* vb = v + (size_t)b * Sk * kv_ld + (size_t)h * D;
  const size_t mask_row0 = (size_t)b * mask_bs + (size_t)q0 * Sk;

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
    stage_rows(s_kv, ldt, kb + (size_t)k0 * kv_ld, kv_ld, kKeyChunk, Sk - k0, D);
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
    stage_rows(s_kv, ldt, vb + (size_t)k0 * kv_ld, kv_ld, kKeyChunk, Sk - k0, D);
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

inline size_t fma_smem(int Sk, int D) {
  return sizeof(float) *
         ((size_t)kQRows * D + (size_t)kKeyChunk * (D + 1) + (size_t)kQRows * Sk);
}

inline size_t mma_smem(int Sk, int D) {
  return sizeof(float) * kQRows * mma_score_ld(Sk) +
         sizeof(bf16) * (size_t)(kQRows + kKeyChunk) * (D + 8);
}

// One launch of the tiled kernels over q [B, Sq, H*D] (grid: q tiles x
// heads x batch); k/v rows kv_ld apart; colsum_part may be null.
inline cudaError_t launch_fwd_tiles(const void* q, const void* k, const void* v,
                                    const float* mask, void* out, float* colsum_part,
                                    int B, int Sq, int Sk, int H, int D, int kv_ld,
                                    size_t mask_bs, bool is_bf16, bool sm_bf16,
                                    float scale, cudaStream_t st) {
  const size_t smem = is_bf16 ? mma_smem(Sk, D) : fma_smem(Sk, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((Sq + kQRows - 1) / kQRows, H, B);
  if (is_bf16) {
    return launch(attention_fwd_mma, grid, kMmaThreads, smem, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), mask, static_cast<bf16*>(out),
                  colsum_part, Sq, Sk, H, D, kv_ld, mask_bs, scale, sm_bf16);
  }
  return launch(attention_fwd_fma, grid, kFmaThreads, smem, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), mask, static_cast<float*>(out),
                colsum_part, Sq, Sk, H, D, kv_ld, mask_bs, scale);
}

}  // namespace merlot
