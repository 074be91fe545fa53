// Fused multi-head attention backward for Hopper (sm_90a), plain C interface:
// K2.
//
// Replaces merlot_tpu/ops/pallas_attention.py `_flash_bwd_pallas` (:456,
// its pallas_call at :504) and its body `_attn_bwd_kernel` (:293), the
// Pallas TPU kernel. It computes the same function: per head h, with P
// exactly as the forward (attention_fwd.cu) builds it (scores rounded to
// the softmax dtype, then the multiplicative mask, then the softmax, P held
// in fp32):
//   dV = P^T . dO
//   dP = dO . V^T  (+ g_colsum / H on every real row when colsum was taken)
//   dS = P * (dP - rowsum(dP * P)) * m * scale     fp32, never rounded
//   dQ = dS . K,   dK = dS^T . Q
// with every product on fp32 operands and fp32 sums, and dQ/dK/dV rounded
// once to the input dtype. D is rowsum(dP * P), as the TPU kernel takes it,
// not dO . O (O was rounded to the input dtype, so that is another number).
// A fully masked row has m = 0 at every key: its dS and its dQ are 0.
//
// Design (bf16, D a multiple of 16 up to 128, templated on D). The TPU
// kernel walks the q blocks in order and adds into revisited dK/dV blocks;
// blocks of a grid run in no order here, so two deterministic kernels, no
// atomics and no [B, H, Sq, Sk] buffer. Both run one warpgroup per block
// with every product on wgmma, and take the forward's saved row max and sum
// (K1's stats), so P is K1's bit for bit and no softmax is recomputed; when
// they are not given, K1's stats-only pass (its passes 1-2) runs first.
//   1. rows kernel, per (64-row q tile, head, batch element): Q and dO
//      staged once, K/V streamed through a 2-stage TMA ring, two passes:
//      S, P and dP = dO . V^T for D (written for the column kernel), then
//      S, P and dP again for dS, and dQ += dS . K with dS in registers as
//      three bf16 terms (wgmma A from registers, B = the K tile).
//   2. column kernel, per (64-key tile, head, batch element): K and V
//      resident, the q tiles walked 64 rows at a time with Q and dO
//      double-buffered by TMA and the three stats prefetched a tile ahead.
//      S and dP on wgmma; P and dS go through shared memory (bf16 terms in
//      wgmma's interleaved layout) as the transposed A operands of
//      dV += P^T . dO and dK += dS^T . Q, accumulated in registers.
// Precision of the products: dO, Q, K, V are bf16, and so is P in the
// bf16-softmax mode, so those operands are exact. dS is fp32 and so is P in
// the fp32-softmax mode: each is split into three bf16 terms hi + mid + lo,
// which hold its 24 significant bits exactly, and the product is the sum of
// three products. Rounding dS to bf16 instead would compute another
// function (the TPU's ATTN_BWD_BF16_DOTS=1). fp32 inputs run the FMA
// kernels below on attention_fp32.cuh's tiles (64-row blocks, 4 x 4 register
// blocks, cp.async rings): the same two kernels, K1's saved row max and sum
// and the mask's tile classes. The rows kernel's second pass skips every
// all-0 tile (dS is 0 there); its first pass and the column kernel skip
// them unless a row of the q tile has p0 != 0 (D and dV take P). The fp32
// route runs 9 products of the 64 x 64 tiles it visits (S and dP twice in
// the rows kernel, once more in the column kernel, dQ, dV, dK) on the FMA
// pipes: the operations bound it (5 products at 67 TFLOP/s).
//
// What bounds it on the H100. At the train step's shapes the bytes (q, k,
// v, dO, the mask and three grads once each) take 0.016-0.109 ms and the
// 10*Sq*Sk*D flops 0.016-0.070 ms at the bf16 peak. The kernels run about
// 3.2x those flops (S twice and dP twice in the rows kernel, S and dP again
// in the column kernel, dQ and dK on three terms each) and re-read K/V per
// 64 q rows and Q/dO per 64 keys from L2; one warpgroup per block makes the
// per-tile latency (barriers, wgmma, the element work) the limit.

#include "attention_fwd_tiles.cuh"

namespace {

using namespace merlot;

constexpr int kRowStages = 2;  // rows kernel: K/V tile pairs in flight
constexpr int kColStages = 2;  // column kernel: Q/dO tile pairs in flight
constexpr uint32_t kTermBytes = 64 * 64 * sizeof(bf16);  // one 64x64 bf16 A operand

// the three bf16 terms hi + mid + lo of an fp32 pair, packed as operands:
// together they hold the pair's 24 significant bits exactly
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&out)[3]) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  const float r0 = x0 - __bfloat162float(h0), r1 = x1 - __bfloat162float(h1);
  const bf16 m0 = __float2bfloat16(r0), m1 = __float2bfloat16(r1);
  out[0] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  out[1] = pack_bf16(__bfloat162float(m0), __bfloat162float(m1));
  out[2] = pack_bf16(r0 - __bfloat162float(m0), r1 - __bfloat162float(m1));
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: bf16, D a multiple of 16 up to 128, one warpgroup per
// block, every product on wgmma.

struct BwdArgs {
  const float* mask;  // [B, Sq, Sk] fp32 or null
  const float* gcol;  // [B, Sk] fp32 or null
  bf16 *dq, *dk, *dv;
  const float* row_max;  // [B, H, Sq] each: the forward's stats
  const float* row_sum;
  float* row_d;  // D = rowsum(dP * P), written by the rows kernel
  int Sq, Sk, H;
  float scale;
  bool sm_bf16;
};

// S = Q . K^T and dP = dO . V^T of one 64-row q tile and one 64-key tile
// (Q and K D wide, dO and V DV wide)
template <int D, int DV = D>
__device__ __forceinline__ void score_and_dp(float (&s)[32], float (&dp)[32],
                                             const uint8_t* s_q, const uint8_t* s_k,
                                             const uint8_t* s_do, const uint8_t* s_v) {
  using namespace sm90;
  zero(s);
  zero(dp);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    Wgmma<64>::ss<0, 0>(s, desc_kmajor<D>(s_q, ks), desc_kmajor<D>(s_k, ks));
#pragma unroll
  for (int ks = 0; ks < DV / 16; ++ks)
    Wgmma<64>::ss<0, 0>(dp, desc_kmajor<DV>(s_do, ks), desc_kmajor<DV>(s_v, ks));
  wg_commit();
  wg_wait_all();
  reg_fence(s);
  reg_fence(dp);
}

// Q and dO, kRowStages x (K, V), barriers, mask bits (MLA's launches leave
// them out without a mask)
template <int D, int DV = D>
size_t rows_smem(int Sk, bool bits = true) {
  return sm90::kSmemAlign +
         (1 + kRowStages) * (sm90::tile_bytes<D>() + sm90::tile_bytes<DV>()) +
         (kRowStages + 1) * sizeof(uint64_t) + (bits ? mask_bits_bytes(Sk, kWgThreads) : 0);
}

// one warpgroup per (64 q rows, head, batch element): two passes over the
// K/V stream, the first for D, the second for dS and dQ = dS . K. DV: V's
// and dO's head dim (D's but for MLA); CAUSAL as in K1 (the q tiles last
// first, each over its key tiles up to its own).
template <int D, int DV = D, bool CAUSAL = false>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_bwd_rows_wgmma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using namespace sm90;
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr uint32_t kVTile = tile_bytes<DV>();
  constexpr uint32_t kStage = kTile + kVTile;  // a K tile and its V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = aligned_smem(smem_raw);    // Q, then dO
  uint8_t* s_kv = s_q + kStage;             // stage st: K at st kStage, then V
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_kv + kRowStages * kStage);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(bar + kRowStages + 1);  // [n_kt][threads]

  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTileRows;
  const int tid = threadIdx.x, t = tid % 4;
  uint8_t* s_do = s_q + kTile;
  const int Sq = a.Sq, Sk = a.Sk, H = a.H;
  const int n_kt = CAUSAL ? qt + 1 : (Sk + kKvTile - 1) / kKvTile, n_loads = 2 * n_kt;

  auto fetch = [&](int i) {
    if (i >= n_loads) return;
    const int st = i % kRowStages, k0 = (i % n_kt) * kKvTile;
    uint8_t* dst = s_kv + st * kStage;
    mbar_expect_tx(&bar[st], kStage);
    tma_tile<D>(dst, &tm_k, &bar[st], h * D, k0, b);
    tma_tile<DV>(dst + kTile, &tm_v, &bar[st], h * DV, k0, b);
  };
  if (tid == 0) {
    for (int i = 0; i <= kRowStages; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[kRowStages], kStage);
    tma_tile<D>(s_q, &tm_q, &bar[kRowStages], h * D, q0, b);
    tma_tile<DV>(s_do, &tm_do, &bar[kRowStages], h * DV, q0, b);
    for (int i = 0; i < kRowStages; ++i) fetch(i);
  }

  const size_t stat0 = ((size_t)b * H + h) * Sq;
  const float* gb = a.gcol == nullptr ? nullptr : a.gcol + (size_t)b * Sk;
  int qrow[2];
  bool real[2];
  const float* mrow[2];
  float mx[2], sm[2], rcp[2], dd[2] = {0.f, 0.f};
  for (int half = 0; half < 2; ++half) {
    qrow[half] = q0 + acc_row(tid, half);
    real[half] = qrow[half] < Sq;
    mrow[half] = a.mask != nullptr && real[half]
                     ? a.mask + ((size_t)b * Sq + qrow[half]) * Sk
                     : nullptr;
    mx[half] = real[half] ? a.row_max[stat0 + qrow[half]] : 0.f;
    sm[half] = real[half] ? a.row_sum[stat0 + qrow[half]] : 1.f;
    rcp[half] = __frcp_rn(sm[half]);
  }
  float dq[D / 2];
  zero(dq);

  mbar_wait(&bar[kRowStages], 0);
  // pass 1 keeps the mask as bits, pass 2 reads them if it is all 0 and 1
  bool binary = false, other = false;
  int i = 0;
  for (int pass = 1; pass <= 2; ++pass) {
    for (int kt = 0; kt < n_kt; ++kt, ++i) {
      const int st = i % kRowStages, k0 = kt * kKvTile;
      const uint8_t* s_k = s_kv + st * kStage;
      const bool use_bits = pass == 2 && binary;
      uint32_t* bits = a.mask != nullptr && (pass == 1 || binary)
                           ? &s_bits[kt * kWgThreads + tid]
                           : nullptr;
      mbar_wait(&bar[st], (i / kRowStages) & 1);
      float s[32], dp[32];
      score_and_dp<D, DV>(s, dp, s_q, s_k, s_do, s_k + kTile);
      mask_any_tile(s, mrow, k0, Sk, a.scale, a.sm_bf16, bits, use_bits, other);
      if (CAUSAL && kt == qt) causal_tile(s, qrow, k0, Sk, a.sm_bf16);
      const uint32_t word = use_bits ? *bits : 0u;
      // P as the forward computed it, and dP + g_colsum / H, at real rows and keys
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * half + e, key = k0 + acc_col(tid, j, e);
            const bool ok = real[half] && key < Sk;
            const float p = ok ? prob_rcp(s[x], mx[half], sm[half], rcp[half], a.sm_bf16)
                               : 0.f;
            const float g = ok ? dp[x] + gcol_term(gb, key, H) : 0.f;
            if (pass == 1) {
              if (ok) dd[half] += g * p;
            } else {
              float ds = 0.f;
              if (ok) {
                ds = p * (g - dd[half]);
                if (mrow[half] != nullptr)
                  ds *= use_bits ? (float)((word >> x) & 1u) : mrow[half][key];
                ds *= a.scale;
              }
              s[x] = ds;
            }
          }
      if (pass == 2) {
        // dQ += dS . K, dS (fp32) as three exact bf16 terms
        uint32_t ds3[3][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t sp[3];
            split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], sp);
            ds3[0][kk][r] = sp[0];
            ds3[1][kk][r] = sp[1];
            ds3[2][kk][r] = sp[2];
          }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int term = 0; term < 3; ++term)
            Wgmma<D>::template rs<1>(dq, ds3[term][kk], desc_mnmajor<D>(s_k, kk));
        wg_commit();
        wg_wait_all();
        reg_fence(dq);
      }
      __syncthreads();
      if (tid == 0) fetch(i + kRowStages);
    }
    if (pass == 1) {
      binary = !__syncthreads_or(other);
      dd[0] = quad_sum(dd[0]);
      dd[1] = quad_sum(dd[1]);
      if (t == 0)
        for (int half = 0; half < 2; ++half)
          if (real[half]) a.row_d[stat0 + qrow[half]] = dd[half];
    }
  }

  const size_t hd = (size_t)H * D;
  bf16* ob = a.dq + (size_t)b * Sq * hd + (size_t)h * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!real[half]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qrow[half] * hd + acc_col(tid, j, 0)) =
          pack_bf16(dq[4 * j + 2 * half], dq[4 * j + 2 * half + 1]);
  }
}

// K and V, kColStages x (Q, dO), P's and dS's bf16 terms, barriers
template <int D, int DV = D>
constexpr size_t cols_smem() {
  return sm90::kSmemAlign + (1 + kColStages) * (sm90::tile_bytes<D>() + sm90::tile_bytes<DV>()) +
         6 * kTermBytes + (kColStages + 1) * sizeof(uint64_t);
}

// one warpgroup per (64 keys, head, batch element) with its K and V
// resident: walks the q tiles 64 rows at a time and accumulates dV += P^T .
// dO and dK += dS^T . Q, P and dS passed to wgmma through shared memory.
// DV as in the rows kernel; CAUSAL: the q tiles from the block's own key
// tile on (the earlier ones see none of its keys). MLA's heads (D != DV)
// take no colsum: its cotangent is read where it is used, not kept in
// registers.
template <int D, bool SM_BF16, int DV = D, bool CAUSAL = false>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_bwd_cols_wgmma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const BwdArgs a) {
  using namespace sm90;
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr uint32_t kStage = kTile + tile_bytes<DV>();  // a Q tile and its dO tile
  constexpr bool kKeepGcol = D == DV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_k = aligned_smem(smem_raw);        // K, then V
  const uint8_t* s_v = s_k + kTile;
  uint8_t* s_qdo = s_k + kStage;                 // stage st: Q at st kStage, then dO
  uint8_t* s_pt = s_qdo + kColStages * kStage;   // P's 3 terms, then dS's 3
  uint8_t* s_ds = s_pt + 3 * kTermBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_pt + 6 * kTermBytes);

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kKvTile;  // the block's first key
  const int Sq = a.Sq, Sk = a.Sk, H = a.H;
  const int n_qt = (Sq + kTileRows - 1) / kTileRows;
  const int it0 = CAUSAL ? (int)blockIdx.x : 0;  // the first q tile that sees a key here
  constexpr int kPTerms = SM_BF16 ? 1 : 3;  // P is exact in bf16 only in that mode

  auto fetch = [&](int i) {  // the block's i-th q tile, it0 + i
    if (it0 + i >= n_qt) return;
    const int st = i % kColStages, q0 = (it0 + i) * kTileRows;
    uint8_t* dst = s_qdo + st * kStage;
    mbar_expect_tx(&bar[st], kStage);
    tma_tile<D>(dst, &tm_q, &bar[st], h * D, q0, b);
    tma_tile<DV>(dst + kTile, &tm_do, &bar[st], h * DV, q0, b);
  };
  if (tid == 0) {
    for (int i = 0; i <= kColStages; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[kColStages], kStage);
    tma_tile<D>(s_k, &tm_k, &bar[kColStages], h * D, k0, b);
    tma_tile<DV>(s_k + kTile, &tm_v, &bar[kColStages], h * DV, k0, b);
    for (int i = 0; i < kColStages; ++i) fetch(i);
  }

  const size_t stat0 = ((size_t)b * H + h) * Sq;
  const float* gb = a.gcol == nullptr ? nullptr : a.gcol + (size_t)b * Sk;
  float gt[16];  // g_colsum / H at this thread's 16 keys
  if constexpr (kKeepGcol) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + acc_col(tid, j, e);
        gt[2 * j + e] = key < Sk ? gcol_term(gb, key, H) : 0.f;
      }
  }
  // the stats of this thread's two rows of a q tile, fetched a tile ahead
  auto stats_of = [&](int q0, float (&st3)[2][4]) {
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + acc_row(tid, half);
      const bool real = r < Sq;
      st3[half][0] = real ? a.row_max[stat0 + r] : 0.f;
      st3[half][1] = real ? a.row_sum[stat0 + r] : 1.f;
      st3[half][2] = real ? a.row_d[stat0 + r] : 0.f;
      st3[half][3] = __frcp_rn(st3[half][1]);
    }
  };
  float next[2][4];
  stats_of(it0 * kTileRows, next);
  float dv[DV / 2], dk[D / 2];
  zero(dv);
  zero(dk);

  mbar_wait(&bar[kColStages], 0);
  for (int it = it0, n = 0; it < n_qt; ++it, ++n) {
    const int st = n % kColStages, q0 = it * kTileRows;
    const uint8_t* s_q = s_qdo + st * kStage;
    const uint8_t* s_do = s_q + kTile;
    float cur[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int c = 0; c < 4; ++c) cur[half][c] = next[half][c];
    if (it + 1 < n_qt) stats_of(q0 + kTileRows, next);
    int qrow[2];
    bool real[2];
    const float* mrow[2];
    for (int half = 0; half < 2; ++half) {
      qrow[half] = q0 + acc_row(tid, half);
      real[half] = qrow[half] < Sq;
      mrow[half] = a.mask != nullptr && real[half]
                       ? a.mask + ((size_t)b * Sq + qrow[half]) * Sk
                       : nullptr;
    }
    mbar_wait(&bar[st], (n / kColStages) & 1);
    float s[32], dp[32];
    score_and_dp<D, DV>(s, dp, s_q, s_k, s_do, s_v);
    // the mask read once: its 0/1 values kept as bits for dS (a thread that
    // meets another value reads it again)
    uint32_t word = 0u;
    bool other = false;
    mask_any_tile(s, mrow, k0, Sk, a.scale, SM_BF16, &word, false, other);
    if (CAUSAL && it == it0) causal_tile(s, qrow, k0, Sk, SM_BF16);
    // P and dS of the tile into shared memory as bf16 terms, [q row][key]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * half + e, key = k0 + acc_col(tid, j, e);
          p[e] = ds[e] = 0.f;
          if (real[half] && key < Sk) {
            p[e] = prob_rcp(s[x], cur[half][0], cur[half][1], cur[half][3], SM_BF16);
            const float g = kKeepGcol ? gt[2 * j + e] : gcol_term(gb, key, H);
            ds[e] = p[e] * (dp[x] + g - cur[half][2]);
            if (mrow[half] != nullptr)
              ds[e] *= other ? mrow[half][key] : (float)((word >> x) & 1u);
            ds[e] *= a.scale;
          }
        }
        const uint32_t off = interleave_offset(acc_row(tid, half), acc_col(tid, j, 0));
        uint32_t terms[3];
        if (SM_BF16) {
          *reinterpret_cast<uint32_t*>(s_pt + off) = pack_bf16(p[0], p[1]);
        } else {
          split3(p[0], p[1], terms);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            *reinterpret_cast<uint32_t*>(s_pt + c * kTermBytes + off) = terms[c];
        }
        split3(ds[0], ds[1], terms);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<uint32_t*>(s_ds + c * kTermBytes + off) = terms[c];
      }
    fence_async_shared();
    __syncthreads();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kPTerms; ++c)
        Wgmma<DV>::template ss<1, 1>(dv, desc_interleave_mn(s_pt + c * kTermBytes, kk),
                                     desc_mnmajor<DV>(s_do, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Wgmma<D>::template ss<1, 1>(dk, desc_interleave_mn(s_ds + c * kTermBytes, kk),
                                    desc_mnmajor<D>(s_q, kk));
    wg_commit();
    wg_wait_all();
    reg_fence(dv);
    reg_fence(dk);
    __syncthreads();
    if (tid == 0) fetch(n + kColStages);
  }

  const size_t hd = (size_t)H * D, hdv = (size_t)H * DV;
  constexpr int kCols = (D > DV ? D : DV) / 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + acc_row(tid, half);
    if (key >= Sk) continue;
    const size_t off = ((size_t)b * Sk + key) * hd + (size_t)h * D;
    const size_t off_v = ((size_t)b * Sk + key) * hdv + (size_t)h * DV;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = acc_col(tid, j, 0);
      if (j < DV / 8)
        *reinterpret_cast<uint32_t*>(a.dv + off_v + c) =
            pack_bf16(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      if (j < D / 8)
        *reinterpret_cast<uint32_t*>(a.dk + off + c) =
            pack_bf16(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
    }
  }
}

template <int D, int DV = D, bool CAUSAL = false>
cudaError_t launch_bwd_wgmma(const CUtensorMap (&tm)[4], const BwdArgs& a, int B,
                             cudaStream_t st) {
  const dim3 rgrid((a.Sq + sm90::kTileRows - 1) / sm90::kTileRows, a.H, B);
  const dim3 cgrid((a.Sk + kKvTile - 1) / kKvTile, a.H, B);
  // MLA's launches hold the mask bits only with a mask
  const bool bits = DV == D || a.mask != nullptr;
  cudaError_t err = launch(attention_bwd_rows_wgmma<D, DV, CAUSAL>, rgrid, kWgThreads,
                           rows_smem<D, DV>(a.Sk, bits), st, tm[0], tm[1], tm[2], tm[3], a);
  if (err != cudaSuccess) return err;
  return launch(a.sm_bf16 ? attention_bwd_cols_wgmma<D, true, DV, CAUSAL>
                           : attention_bwd_cols_wgmma<D, false, DV, CAUSAL>,
                cgrid, kWgThreads, cols_smem<D, DV>(), st, tm[0], tm[1], tm[2], tm[3], a);
}

}  // namespace

extern "C" {

// q/dq: [B, Sq, H*D]; k/dk: [B, Sk, H*D]; v/dv and dout as k and q with Dv
// (D's but for MLA's heads: bf16, D 192, Dv 128), all contiguous and
// 16-byte aligned, fp32 (is_bf16=0) or bf16 (is_bf16=1, D a multiple of 16).
// causal: as K1's (MLA's heads, Sq = Sk, no gcol).
// mask: [B, Sq, Sk] fp32 or NULL. gcol: [B, Sk] fp32 cotangent of the
// colsum, or NULL. stats: 3 * B * H * Sq fp32, [row max, row sum, D] by
// [B, H, Sq]: with stats_saved=1 its first two planes hold the forward's
// (K1's) row max and sum, else they are computed first by K1's stats-only
// pass; D is written. tile_class: with fp32 inputs and a mask, the mask's
// tile classes ([B][ceil(Sq / 64)][ceil(Sk / 64)] bytes), K1's with
// stats_saved=1, else written here; ignored for bf16. Launches on `stream`
// and returns a cudaError_t (0 on success).
int merlot_attention_bwd(const void* q, const void* k, const void* v,
                         const void* mask, const void* dout, const void* gcol,
                         void* dq, void* dk, void* dv, void* stats, int stats_saved,
                         void* tile_class, int B, int Sq, int Sk, int H, int D, int Dv,
                         int is_bf16, int softmax_fp32, int causal, float scale,
                         void* stream) {
  const int max_seq = is_bf16 ? kMaxSeqBf16 : kMaxSeq;
  const bool mla = Dv != D || causal;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || Sq > max_seq ||
      Sk > max_seq || B > 65535 || H > 65535 ||
      (mla ? !is_bf16 || D != kMlaQkDim || Dv != kMlaVDim || gcol != nullptr ||
                 (causal && Sq != Sk)
           : D > kMaxHeadDim || (is_bf16 && D % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* gc = static_cast<const float*>(gcol);
  float* row_max = static_cast<float*>(stats);
  float* row_sum = row_max + (size_t)B * H * Sq;
  float* row_d = row_sum + (size_t)B * H * Sq;
  cudaError_t err;
  if (is_bf16) {
    const bool sm_bf16 = softmax_fp32 == 0;
    if (!stats_saved) {
      err = launch_fwd_tiles(q, k, v, 0, m, nullptr, nullptr, row_max, nullptr, B, Sq, Sk,
                             H, D, H * D, (size_t)Sq * Sk, true, sm_bf16, scale, st, kProd,
                             true, Dv, causal != 0);
      if (err != cudaSuccess) return (int)err;
    }
    CUtensorMap tm[4];
    err = sm90::make_tile_map(&tm[0], q, B, Sq, H * D, D);
    if (err == cudaSuccess) err = sm90::make_tile_map(&tm[1], k, B, Sk, H * D, D);
    if (err == cudaSuccess) err = sm90::make_tile_map(&tm[2], v, B, Sk, H * Dv, Dv);
    if (err == cudaSuccess) err = sm90::make_tile_map(&tm[3], dout, B, Sq, H * Dv, Dv);
    if (err != cudaSuccess) return (int)err;
    const BwdArgs a{m,       gc,      static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv), row_max, row_sum, row_d, Sq, Sk, H, scale,
                    sm_bf16};
    if (mla)
      return (int)(causal ? launch_bwd_wgmma<kMlaQkDim, kMlaVDim, true>(tm, a, B, st)
                          : launch_bwd_wgmma<kMlaQkDim, kMlaVDim, false>(tm, a, B, st));
    switch (D) {
      case 16: return (int)launch_bwd_wgmma<16>(tm, a, B, st);
      case 32: return (int)launch_bwd_wgmma<32>(tm, a, B, st);
      case 48: return (int)launch_bwd_wgmma<48>(tm, a, B, st);
      case 64: return (int)launch_bwd_wgmma<64>(tm, a, B, st);
      case 80: return (int)launch_bwd_wgmma<80>(tm, a, B, st);
      case 96: return (int)launch_bwd_wgmma<96>(tm, a, B, st);
      case 112: return (int)launch_bwd_wgmma<112>(tm, a, B, st);
      default: return (int)launch_bwd_wgmma<128>(tm, a, B, st);
    }
  }
  // fp32: the mask's tile classes and K1's stats, computed here when not saved
  uint8_t* cls = m == nullptr ? nullptr : static_cast<uint8_t*>(tile_class);
  if (m != nullptr && cls == nullptr) return (int)cudaErrorInvalidValue;
  if (!stats_saved) {
    err = launch_fwd_tiles(q, k, v, 0, m, nullptr, nullptr, row_max, cls, B, Sq, Sk, H, D,
                           H * D, (size_t)Sq * Sk, false, false, scale, st, kProd, true);
    if (err != cudaSuccess) return (int)err;
  }
  const f32::BwdF32Args a{static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dout),
                     m,
                     cls,
                     gc,
                     static_cast<float*>(dq),
                     static_cast<float*>(dk),
                     static_cast<float*>(dv),
                     row_max,
                     row_sum,
                     row_d,
                     Sq,
                     Sk,
                     H,
                     D,
                     scale};
  return (int)f32::launch_bwd_f32(a, B, st);
}

}  // extern "C"
