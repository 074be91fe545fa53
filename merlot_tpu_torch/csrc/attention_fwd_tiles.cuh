// The tiled attention-forward kernels, shared by K1 (attention_fwd.cu) and
// the prefill path of K3 (attention_stacked.cu). attention_fwd.cu's header
// comment describes the design; the two callers differ only in layout:
//   - K/V rows are `kv_ld` elements apart: H*D for K1's separate k and v
//     tensors, 2*H*D for K3's stacked cache, whose values start at column
//     v_col0 = H*D of the same rows (the caller passes v = kv);
//   - the mask of batch element b starts at b * mask_bs: Sq*Sk for a
//     [B, Sq, Sk] mask, 0 for one [1, Sq, Sk] mask shared by the batch.
// K2 (attention_bwd.cu) launches the bf16 kernel in its stats-only form
// when it is called without the forward's row max and sum.

#pragma once

#include "attention_common.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace merlot {

constexpr int kFmaThreads = 256;
constexpr int kFmaRowsPerThread = kQRows / 4;  // 4 row groups of 64 threads
constexpr int kFmaCols = kMaxHeadDim / 64;     // output columns per thread

constexpr int kWgThreads = 128;             // threads of a warpgroup
constexpr int kKvTile = sm90::kTileRows;    // keys per staged K/V tile

constexpr int kFwdStages = 2;     // K/V tile pairs in flight
constexpr int kFwdMinBlocks = 4;  // blocks per SM the registers are capped for (128)

// K1's compile-time variants: the production kernel and the ablation
// probe's two (wrong on purpose, for timing only): the softmax removed (p =
// round(s)), and the softmax without its stats pass (max = 0, sum = 1)
enum FwdVariant { kProd = 0, kMmOnly = 1, kNoMax = 2 };

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
// Tensor-core kernel (bf16, D a multiple of 16 up to 128): one warpgroup per
// (64-row q tile, head, batch element), two passes over the K stream.

struct FwdArgs {
  const float* mask;   // [B or 1, Sq, Sk] fp32, or null
  bf16* out;           // [B, Sq, H*D]
  float* colsum_part;  // [B, H, q tiles, Sk], or null
  float* stats;        // [2, B, H, Sq]: row max, row sum; or null
  int Sq, Sk, H;
  int k_col0, v_col0;  // column of head 0's keys / values in the K/V maps
  size_t mask_bs;
  float scale;
  bool sm_bf16;
  bool stats_only;     // pass 1 only: the stats, no ctx
};

// shared memory for the mask as bits: one word per thread and 64-key tile
inline size_t mask_bits_bytes(int Sk, int threads) {
  return sizeof(uint32_t) * threads * ((Sk + kKvTile - 1) / kKvTile);
}

// Q, kFwdStages x (K, V), colsum scratch [warps][64], barriers, mask bits
// (one word per thread and key tile)
template <int D>
size_t fwd_smem(int Sk) {
  return sm90::kSmemAlign + (1 + 2 * kFwdStages) * sm90::tile_bytes<D>() +
         4 * kKvTile * sizeof(float) + (kFwdStages + 1) * sizeof(uint64_t) +
         mask_bits_bytes(Sk, kWgThreads);
}

// the score tile S = Q . K^T of the staged K tile: 64 q rows x 64 keys
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[32], const uint8_t* s_q,
                                           const uint8_t* s_k) {
  using namespace sm90;
  zero(s);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    Wgmma<64>::ss<0, 0>(s, desc_kmajor<D>(s_q, ks), desc_kmajor<D>(s_k, ks));
  wg_commit();
  wg_wait_all();
  reg_fence(s);
}

// The rounded, masked scores of this thread's 32 elements of the tile at
// keys k0.. in place; in the edge tile (EDGE) keys at or past Sk become
// -inf (no part in max or sum). A pass that revisits a tile reads the mask
// from `bits`, this thread's word of the tile in shared memory: bit x says
// m = 1 at element x, else m = 0 (use_bits only when the block's mask holds
// nothing but 0 and 1). Reading the mask from memory, with `bits` given, it
// writes that word; `other` notes a value that is neither 0 nor 1. m = 1
// leaves the rounded score as it is and m = 0 gives round_sm(-1e10): the
// general formula's values for those m, exactly.
template <bool EDGE>
__device__ __forceinline__ void mask_tile(float (&s)[32], const float* const (&mrow)[2],
                                          int k0, int Sk, float scale, bool sm_bf16,
                                          uint32_t* bits, bool use_bits, bool& other) {
  const int t = threadIdx.x % 4;
  const float masked = round_sm(-kMaskPenalty, sm_bf16);
  uint32_t word = use_bits ? *bits : 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * half + e, key = k0 + 8 * j + 2 * t + e;
        float v = round_sm(s[x] * scale, sm_bf16);
        if (EDGE && key >= Sk) {
          v = -INFINITY;
        } else if (mrow[half] != nullptr) {
          if (use_bits) {
            if (!((word >> x) & 1u)) v = masked;
          } else {
            const float m = mrow[half][key];
            if (m == 1.f) {
              word |= 1u << x;
            } else if (m == 0.f) {
              v = masked;
            } else {
              v = round_sm(v * m - kMaskPenalty * (1.f - m), sm_bf16);
              other = true;
            }
          }
        }
        s[x] = v;
      }
  if (bits != nullptr && !use_bits) *bits = word;
}

// mask_tile with the edge test only where the tile crosses Sk
__device__ __forceinline__ void mask_any_tile(float (&s)[32], const float* const (&mrow)[2],
                                              int k0, int Sk, float scale, bool sm_bf16,
                                              uint32_t* bits, bool use_bits, bool& other) {
  if (k0 + kKvTile <= Sk)
    mask_tile<false>(s, mrow, k0, Sk, scale, sm_bf16, bits, use_bits, other);
  else
    mask_tile<true>(s, mrow, k0, Sk, scale, sm_bf16, bits, use_bits, other);
}

// exp(x) for x <= 0 as 2^(x log2 e) on the special-function unit: a few
// fp32 ulps from exp, in 2 instructions instead of expf's ~8 (the element
// work bounds these kernels)
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// e / sum, correctly rounded, from r = 1/sum correctly rounded: one FMA
// correction of e * r (Markstein) instead of a division per element. K1
// and K2 both take p from it, so K2's P is K1's bit for bit.
__device__ __forceinline__ float div_rn(float e, float sum, float r) {
  const float q = __fmul_rn(e, r);
  return fmaf(fmaf(-q, sum, e), r, q);
}

__device__ __forceinline__ float prob_rcp(float s, float mx, float sum, float r,
                                          bool sm_bf16) {
  return round_sm(div_rn(exp_sfu(s - mx), sum, r), sm_bf16);
}

// a 64-row tile's bf16 A fragments of one 64-key product (4 k16 steps) from
// fp32 values in the accumulator layout
__device__ __forceinline__ void a_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, int VAR>
__global__ void __launch_bounds__(kWgThreads, kFwdMinBlocks)
attention_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const FwdArgs a) {
  using namespace sm90;
  constexpr uint32_t kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = aligned_smem(smem_raw);
  uint8_t* s_kv = s_q + kTile;               // stage st: K at 2 st, V at 2 st + 1
  float* s_cs = reinterpret_cast<float*>(s_kv + 2 * kFwdStages * kTile);  // [warps][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_cs + 4 * kKvTile);  // stages, Q
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(bar + kFwdStages + 1);  // [n_kt][threads]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTileRows;
  const int tid = threadIdx.x, t = tid % 4;
  const int Sq = a.Sq, Sk = a.Sk;
  const int n_kt = (Sk + kKvTile - 1) / kKvTile;
  // passes: 1 the row max and sum (the probe's variants skip it), 2 the
  // probs, colsum and ctx
  const int p0 = VAR == kProd ? 1 : 2;
  const int p1 = a.stats_only ? 1 : 2;
  const int n_loads = (p1 - p0 + 1) * n_kt;

  // load i of the block's stream: key tile i % n_kt, with V in pass 2
  auto fetch = [&](int i) {
    if (i >= n_loads) return;
    const int st = i % kFwdStages, k0 = (i % n_kt) * kKvTile;
    const bool with_v = p0 + i / n_kt == 2;
    uint8_t* dst = s_kv + 2 * st * kTile;
    mbar_expect_tx(&bar[st], (with_v ? 2 : 1) * kTile);
    tma_tile<D>(dst, &tm_k, &bar[st], a.k_col0 + h * D, k0, b);
    if (with_v) tma_tile<D>(dst + kTile, &tm_v, &bar[st], a.v_col0 + h * D, k0, b);
  };
  if (tid == 0) {
    for (int i = 0; i <= kFwdStages; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[kFwdStages], kTile);
    tma_tile<D>(s_q, &tm_q, &bar[kFwdStages], h * D, q0, b);
    for (int i = 0; i < kFwdStages; ++i) fetch(i);
  }

  int qrow[2];
  bool real[2];
  const float* mrow[2];
  for (int half = 0; half < 2; ++half) {
    qrow[half] = q0 + acc_row(tid, half);
    real[half] = qrow[half] < Sq;
    mrow[half] = a.mask != nullptr && real[half]
                     ? a.mask + b * a.mask_bs + (size_t)qrow[half] * Sk
                     : nullptr;
  }
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, rcp[2] = {1.f, 1.f};
  if (VAR == kNoMax) mx[0] = mx[1] = 0.f, sum[0] = sum[1] = 1.f;
  float* part = a.colsum_part == nullptr
                    ? nullptr
                    : a.colsum_part + (((size_t)b * a.H + h) * gridDim.x + qt) * Sk;

  mbar_wait(&bar[kFwdStages], 0);
  // the first pass reads the mask from memory and keeps it as bits; the
  // second reads the bits when the block's mask is all 0 and 1
  bool binary = false, other = false;
  int i = 0;
  if (p0 == 1) {
    // pass 1: the running max, and the sum of exp(s - max) rescaled when
    // the max grows (exp(-inf) = 0: keys past Sk add nothing). Its own loop,
    // so that ctx's accumulator is not live here
    for (int kt = 0; kt < n_kt; ++kt, ++i) {
      const int st = i % kFwdStages;
      uint32_t* bits = a.mask != nullptr ? &s_bits[kt * kWgThreads + tid] : nullptr;
      float s[32];
      mbar_wait(&bar[st], (i / kFwdStages) & 1);
      score_tile<D>(s, s_q, s_kv + 2 * st * kTile);
      mask_any_tile(s, mrow, kt * kKvTile, Sk, a.scale, a.sm_bf16, bits, false, other);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float m = mx[half];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          m = fmaxf(m, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
        if (m != mx[half]) {
          sum[half] *= exp_sfu(mx[half] - m);
          mx[half] = m;
        }
        if (mx[half] != -INFINITY) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum[half] += exp_sfu(s[4 * j + 2 * half] - mx[half]) +
                         exp_sfu(s[4 * j + 2 * half + 1] - mx[half]);
        }
      }
      // every warp is done with this stage: refill it
      __syncthreads();
      if (tid == 0) fetch(i + kFwdStages);
    }
    binary = !__syncthreads_or(other);
    // the row's four threads: their sums rescaled to the row's max
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m = quad_max(mx[half]);
      const float part_sum = mx[half] == -INFINITY ? 0.f
                             : mx[half] == m      ? sum[half]
                                                  : sum[half] * exp_sfu(mx[half] - m);
      mx[half] = m;
      sum[half] = quad_sum(part_sum);
      rcp[half] = __frcp_rn(sum[half]);
    }
    if (a.stats != nullptr && t == 0) {
      const size_t n = (size_t)gridDim.z * a.H * Sq, r0 = ((size_t)b * a.H + h) * Sq;
      for (int half = 0; half < 2; ++half)
        if (real[half]) {
          a.stats[r0 + qrow[half]] = mx[half];
          a.stats[n + r0 + qrow[half]] = sum[half];
        }
    }
    if (a.stats_only) return;
  }

  // pass 2: p in the softmax dtype (0 past Sk), the colsum partials, and
  // ctx += round_bf16(p) . V
  float o[D / 2];
  zero(o);
  for (int kt = 0; kt < n_kt; ++kt, ++i) {
    const int st = i % kFwdStages, k0 = kt * kKvTile;
    const uint8_t* s_k = s_kv + 2 * st * kTile;
    // the variants read the mask here for the first time
    uint32_t* bits = a.mask != nullptr && (p0 == 2 || binary)
                         ? &s_bits[kt * kWgThreads + tid]
                         : nullptr;
    float s[32];
    mbar_wait(&bar[st], (i / kFwdStages) & 1);
    score_tile<D>(s, s_q, s_k);
    mask_any_tile(s, mrow, k0, Sk, a.scale, a.sm_bf16, bits, p0 == 1 && binary, other);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int half = (x / 2) % 2;
      if (VAR == kMmOnly)
        s[x] = s[x] == -INFINITY ? 0.f : round_as<bf16>(s[x]);
      else
        s[x] = prob_rcp(s[x], mx[half], sum[half], rcp[half], a.sm_bf16);
    }
    if (part != nullptr) {
      // this tile's column sums over the real rows, in a fixed order:
      // the thread's two rows, the warp's 8 row pairs, the warps
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = (real[0] ? s[4 * j + e] : 0.f) + (real[1] ? s[4 * j + 2 + e] : 0.f);
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          if (tid % 32 < 4) s_cs[(tid / 32) * kKvTile + acc_col(tid, j, e)] = c;
        }
      __syncthreads();
      if (tid < kKvTile && k0 + tid < Sk) {
        float c = s_cs[tid];
        for (int w = 1; w < 4; ++w) c += s_cs[w * kKvTile + tid];
        part[k0 + tid] = c;
      }
    }
    uint32_t pa[4][4];
    a_frags(pa, s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<D>::template rs<1>(o, pa[kk], desc_mnmajor<D>(s_k + kTile, kk));
    wg_commit();
    wg_wait_all();
    reg_fence(o);
    // every warp is done with this stage: refill it
    __syncthreads();
    if (tid == 0) fetch(i + kFwdStages);
  }

  const size_t hd = (size_t)a.H * D;
  bf16* ob = a.out + (size_t)b * Sq * hd + (size_t)h * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!real[half]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qrow[half] * hd + acc_col(tid, j, 0)) =
          pack_bf16(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
  }
}

template <int D, int VAR>
cudaError_t launch_fwd_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                             const CUtensorMap& tv, const FwdArgs& a, int B,
                             cudaStream_t st) {
  const dim3 grid((a.Sq + sm90::kTileRows - 1) / sm90::kTileRows, a.H, B);
  return launch(attention_fwd_wgmma<D, VAR>, grid, kWgThreads, fwd_smem<D>(a.Sk), st, tq, tk,
                tv, a);
}

inline size_t fma_smem(int Sk, int D) {
  return sizeof(float) *
         ((size_t)kQRows * D + (size_t)kKeyChunk * (D + 1) + (size_t)kQRows * Sk);
}

// query rows per block of the tiled kernels: the colsum workspace holds
// B * H * ceil(Sq / rows) * Sk floats
inline int fwd_q_tile(bool is_bf16) { return is_bf16 ? sm90::kTileRows : kQRows; }

// One launch of the tiled kernels over q [B, Sq, H*D] (grid: q tiles x
// heads x batch): K rows are kv_ld elements apart starting at k, V rows too
// starting at v + v_col0; colsum_part and stats may be null (stats: bf16
// only). variant: FwdVariant (bf16, D = 64 only for the probe's two).
inline cudaError_t launch_fwd_tiles(const void* q, const void* k, const void* v,
                                    int v_col0, const float* mask, void* out,
                                    float* colsum_part, float* stats, int B, int Sq,
                                    int Sk, int H, int D, int kv_ld, size_t mask_bs,
                                    bool is_bf16, bool sm_bf16, float scale,
                                    cudaStream_t st, int variant = kProd,
                                    bool stats_only = false) {
  if (!is_bf16) {
    if (stats != nullptr || variant != kProd || stats_only) return cudaErrorInvalidValue;
    const size_t smem = fma_smem(Sk, D);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const dim3 grid((Sq + kQRows - 1) / kQRows, H, B);
    return launch(attention_fwd_fma, grid, kFmaThreads, smem, st,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v) + v_col0, mask, static_cast<float*>(out),
                  colsum_part, Sq, Sk, H, D, kv_ld, mask_bs, scale);
  }
  if (D % 16 != 0 || D > kMaxHeadDim) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_tile_map(&tq, q, B, Sq, H * D, D);
  if (err == cudaSuccess) err = sm90::make_tile_map(&tk, k, B, Sk, kv_ld, D);
  if (err == cudaSuccess) err = sm90::make_tile_map(&tv, v, B, Sk, kv_ld, D);
  if (err != cudaSuccess) return err;
  const FwdArgs a{mask,   static_cast<bf16*>(out), colsum_part, stats, Sq, Sk, H, 0,
                  v_col0, mask_bs, scale, sm_bf16, stats_only};
  if (variant != kProd) {
    if (D != 64) return cudaErrorInvalidValue;
    switch (variant) {
      case kMmOnly: return launch_fwd_wgmma<64, kMmOnly>(tq, tk, tv, a, B, st);
      case kNoMax: return launch_fwd_wgmma<64, kNoMax>(tq, tk, tv, a, B, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return launch_fwd_wgmma<16, kProd>(tq, tk, tv, a, B, st);
    case 32: return launch_fwd_wgmma<32, kProd>(tq, tk, tv, a, B, st);
    case 48: return launch_fwd_wgmma<48, kProd>(tq, tk, tv, a, B, st);
    case 64: return launch_fwd_wgmma<64, kProd>(tq, tk, tv, a, B, st);
    case 80: return launch_fwd_wgmma<80, kProd>(tq, tk, tv, a, B, st);
    case 96: return launch_fwd_wgmma<96, kProd>(tq, tk, tv, a, B, st);
    case 112: return launch_fwd_wgmma<112, kProd>(tq, tk, tv, a, B, st);
    default: return launch_fwd_wgmma<128, kProd>(tq, tk, tv, a, B, st);
  }
}

}  // namespace merlot
