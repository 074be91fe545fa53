// The tiled attention-forward kernels, shared by K1 (attention_fwd.cu) and
// the prefill path of K3 (attention_stacked.cu): the bf16 kernel
// (attention_fwd_tiles.cu; attention_fwd.cu's header comment describes its
// design) and the fp32 kernels of attention_fp32.cuh (attention_fwd_f32.cu).
// This header declares their one launch, launch_fwd_tiles; each of those
// translation units compiles once and links into K1's, K2's and K3's
// libraries (_build.py), so the head-dim instantiations are not compiled
// three times. The two callers differ only in layout:
//   - K/V rows are `kv_ld` elements apart: H*D for K1's separate k and v
//     tensors, 2*H*D for K3's stacked cache, whose values start at column
//     v_col0 = H*D of the same rows (the caller passes v = kv);
//   - the mask of batch element b starts at b * mask_bs: Sq*Sk for a
//     [B, Sq, Sk] mask, 0 for one [1, Sq, Sk] mask shared by the batch.
// K2 (attention_bwd.cu) launches them in their stats-only form when it is
// called without the forward's row max and sum.

#pragma once

#include "attention_common.cuh"
#include "attention_fp32.cuh"
#include "sm90.cuh"
#include "wgmma.cuh"

namespace merlot {

constexpr int kWgThreads = 128;             // threads of a warpgroup
constexpr int kKvTile = sm90::kTileRows;    // keys per staged K/V tile

constexpr int kFwdStages = 2;     // K/V tile pairs in flight
constexpr int kFwdMinBlocks = 4;  // blocks per SM the registers are capped for (128)

// K1's compile-time variants: the production kernel and the ablation
// probe's two (wrong on purpose, for timing only): the softmax removed (p =
// round(s)), and the softmax without its stats pass (max = 0, sum = 1)
enum FwdVariant { kProd = 0, kMmOnly = 1, kNoMax = 2 };

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

// One launch of the tiled kernels over q [B, Sq, H*D] (grid: q tiles x
// heads x batch): K rows are kv_ld elements apart starting at k, V rows too
// starting at v + v_col0; colsum_part and stats may be null. fp32 runs
// attention_fp32.cuh's kernels and, with a mask, first sorts its tiles into
// tile_class ([B or 1][q tiles][key tiles] bytes; the bf16 kernels ignore
// it). variant: FwdVariant (bf16, D = 64 only for the probe's two).
cudaError_t launch_fwd_tiles(const void* q, const void* k, const void* v,
                             int v_col0, const float* mask, void* out,
                             float* colsum_part, float* stats, uint8_t* tile_class,
                             int B, int Sq, int Sk, int H, int D, int kv_ld,
                             size_t mask_bs, bool is_bf16, bool sm_bf16, float scale,
                             cudaStream_t st, int variant = kProd,
                             bool stats_only = false);

}  // namespace merlot
