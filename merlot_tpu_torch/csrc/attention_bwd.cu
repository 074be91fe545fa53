// Fused multi-head attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces merlot_tpu/ops/pallas_attention.py `_flash_bwd_pallas` /
// `_attn_bwd_kernel` (the Pallas TPU kernel). It computes the same function:
// per head h, with P rebuilt exactly as the forward (attention_fwd.cu)
// builds it (scores rounded to the softmax dtype, then the multiplicative
// mask, then the softmax, P held in fp32):
//   dV = P^T . dO
//   dP = dO . V^T  (+ g_colsum / H on every real row when colsum was taken)
//   dS = P * (dP - rowsum(dP * P)) * m * scale     fp32, never rounded
//   dQ = dS . K,   dK = dS^T . Q
// with every product taking fp32 operands and fp32 sums, and dQ/dK/dV
// stored in the input dtype. On the natural [B, S, H*D] layout.
//
// Design. The TPU kernel walks the q blocks of a batch element in order and
// adds each block's dK/dV into revisited fp32 output blocks. Blocks of a
// grid run in no order on the H100, so the work splits into two kernels,
// deterministic, with no atomics and no [B, H, Sq, Sk] buffer:
//   1. rows kernel, one block per (16-row q tile, head, batch element): the
//      tile's full score rows in shared memory as the forward keeps them;
//      softmax, whose row max and sum go to a [3, B, H, Sq] workspace; dP
//      streamed over V twice, first for D = rowsum(dP * P) (also saved),
//      then for dS, written in place of P; then dQ = dS . K.
//   2. column kernel, one block per (64-key tile, head, batch element),
//      looping over all q tiles: it rebuilds each tile's P bit for bit from
//      the saved max and sum with the forward's fp32 operations, recomputes
//      dP and dS with the saved D, and accumulates dV and dK in registers.
// D is rowsum(dP * P) as the TPU kernel takes it, not dO . O (O was rounded
// to the input dtype, so that is another number). A fully masked row has
// m = 0 at every key, so its dS, and with it its dQ, is exactly 0.
//
// Precision of the products. bf16 inputs run every product on the tensor
// cores (mma.sync m16n8k16, fp32 sums). dO, Q, K, V are bf16, and so is P in
// the bf16-softmax mode, so those operands are exact. dS is fp32 and so is
// P in the fp32-softmax mode: each is split into three bf16 terms
// hi + mid + lo, which hold its 24 significant bits exactly, and the
// product is the sum of three products. Rounding dS to bf16 instead would
// compute another function (the TPU's ATTN_BWD_BF16_DOTS=1). fp32 inputs
// run fp32-FMA kernels on the same tiling.
//
// What bounds it on the H100. Per head the backward does ~2.5x the
// forward's products plus two recomputations of S and one of dP, against
// inputs read a few times from L2; like the forward it is latency-bound
// by the per-tile staging and the passes over the score rows in shared
// memory, not by the tensor cores or device memory. The three-term splits
// triple the dQ and dK products (and dV's in the fp32-softmax mode),
// which costs little beside that.

#include "attention_common.cuh"

namespace {

using namespace merlot;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTile = 64;  // keys per block of the column kernels
constexpr int kMaxKSteps = kMaxHeadDim / 16;
// rows kernel, dQ = dS . K: warp w owns the 8-column tiles w, w + 8, ...
constexpr int kRowNTiles = kMaxHeadDim / 8 / kWarps;
// column kernel, dV and dK: warp w owns the 16-key tile (w % 4) and the
// 8-column tiles (w / 4), (w / 4) + 2, ...
constexpr int kColMTiles = kKeyTile / 16;
constexpr int kColNGroups = kWarps / kColMTiles;
constexpr int kColNTiles = kMaxHeadDim / 8 / kColNGroups;
constexpr int kPLd = kKeyTile + 4;  // fp32 P / dS tile row stride (no bank conflicts)
// FMA kernels: 4 row groups of 64 threads; each thread takes 4 rows
constexpr int kFmaRows = kQRows / 4;
constexpr int kFmaCols = kMaxHeadDim / 64;  // dQ columns per thread
constexpr int kFmaKCols = kMaxHeadDim / 4;  // dK/dV columns per thread

static_assert(kKeyChunk == 8 * kWarps, "one 8-key tile of each chunk per warp");

// the three bf16 terms hi + mid + lo of an fp32 pair, packed as mma operands
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&out)[3]) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  const float r0 = x0 - __bfloat162float(h0), r1 = x1 - __bfloat162float(h1);
  const bf16 m0 = __float2bfloat16(r0), m1 = __float2bfloat16(r1);
  out[0] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  out[1] = pack_bf16(__bfloat162float(m0), __bfloat162float(m1));
  out[2] = pack_bf16(r0 - __bfloat162float(m0), r1 - __bfloat162float(m1));
}

// A fragments (terms 0..n-1) of a 16x16 tile of fp32 values read by `at`
// at (row, col): the pairs (row g, cols 2t, 2t+1), (g+8, ...), (g, 2t+8, ..),
// (g+8, 2t+8, ..); n = 1 when the values are exact in bf16
template <typename At>
__device__ __forceinline__ void a_terms(uint32_t (&a)[3][4], int n, int g, int t,
                                        At at) {
  const int rr[4] = {g, g + 8, g, g + 8};
  const int cc[4] = {2 * t, 2 * t, 2 * t + 8, 2 * t + 8};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = at(rr[i], cc[i]), x1 = at(rr[i], cc[i] + 1);
    if (n == 1) {
      a[0][i] = pack_bf16(x0, x1);
    } else {
      uint32_t s[3];
      split3(x0, x1, s);
      a[0][i] = s[0];
      a[1][i] = s[1];
      a[2][i] = s[2];
    }
  }
}

__device__ __forceinline__ void mma_terms(float (&c)[4], const uint32_t (&a)[3][4],
                                          int n, uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < n) mma_bf16(c, a[i], b0, b1);
}

// A fragments of rows g, g+8 of a bf16 tile in shared memory (row stride
// ld) at k step ks
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* s, int ld,
                                       int ks, int g, int t) {
  const bf16* p = s + g * ld + ks * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// the fp32 product of the 16 rows held in `a` with the 8 rows key..key+7 of
// a bf16 tile (row stride ld): c[e] is (row g + 8*(e/2), key + 2t + e%2)
__device__ __forceinline__ void dot_tile(float (&c)[4],
                                         const uint32_t (&a)[kMaxKSteps][4],
                                         const bf16* s, int ld, int key,
                                         int ksteps, int g, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
    if (ks < ksteps) {
      const bf16* p = s + (key + g) * ld + ks * 16 + 2 * t;
      mma_bf16(c, a[ks], ld32(p), ld32(p + 8));
    }
  }
}

__device__ __forceinline__ float gcol_term(const float* gcol, size_t i, int H) {
  return gcol == nullptr ? 0.f : gcol[i] / (float)H;
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: bf16, D a multiple of 16.

__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ mask,
                       const bf16* __restrict__ dout, const float* __restrict__ gcol,
                       bf16* __restrict__ dq, float* __restrict__ row_max,
                       float* __restrict__ row_sum, float* __restrict__ row_d,
                       int Sq, int Sk, int H, int D, float scale, bool sm_bf16) {
  extern __shared__ float smem[];
  const int ld = mma_score_ld(Sk), kpad = mma_key_pad(Sk);
  const int ldt = D + 8;
  float* s_p = smem;                               // [16][ld]: P, then dS
  float* s_red = s_p + kQRows * ld;                // [kWarps][16] row partials
  float* s_d = s_red + kWarps * kQRows;            // [16] D of each row
  bf16* s_t = reinterpret_cast<bf16*>(s_d + kQRows);  // [16][ldt]: Q, then dO
  bf16* s_kv = s_t + kQRows * ldt;                 // [kKeyChunk][ldt]: K or V

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kQRows;
  const int rows = min(kQRows, Sq - q0);
  const size_t hd = (size_t)H * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ksteps = D / 16;
  const int key = 8 * warp;  // this warp's 8 keys of each staged chunk
  const bf16* kb = k + (size_t)b * Sk * hd + (size_t)h * D;
  const bf16* vb = v + (size_t)b * Sk * hd + (size_t)h * D;
  const size_t row0 = (size_t)b * Sq + q0;
  const size_t mask_row0 = row0 * Sk;
  const size_t stat0 = ((size_t)b * H + h) * Sq + q0;
  const float* gb = gcol == nullptr ? nullptr : gcol + (size_t)b * Sk;

  // 1. P of the tile, as the forward computes it
  uint32_t fa[kMaxKSteps][4];
  stage_rows(s_t, ldt, q + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks)
    if (ks < ksteps) a_rows(fa[ks], s_t, ldt, ks, g, t);
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    stage_rows(s_kv, ldt, kb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    float c[4];
    dot_tile(c, fa, s_kv, ldt, key, ksteps, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2), kk = k0 + key + 2 * t + (e % 2);
      if (kk < kpad)
        s_p[row * ld + kk] =
            kk < Sk ? masked_score(c[e], row < rows ? mask : nullptr,
                                   mask_row0 + (size_t)row * Sk, kk, scale, sm_bf16)
                    : 0.f;
    }
  }
  __syncthreads();
  softmax_rows(s_p, ld, rows, Sk, sm_bf16, row_max + stat0, row_sum + stat0);
  __syncthreads();
  stage_rows(s_t, ldt, dout + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks)
    if (ks < ksteps) a_rows(fa[ks], s_t, ldt, ks, g, t);

  // 2. D = rowsum(dP * P), streaming dP over V
  float part[2] = {0.f, 0.f};  // rows g and g + 8
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    stage_rows(s_kv, ldt, vb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    float c[4];
    dot_tile(c, fa, s_kv, ldt, key, ksteps, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2), kk = k0 + key + 2 * t + (e % 2);
      if (row < rows && kk < Sk)
        part[e / 2] += (c[e] + gcol_term(gb, kk, H)) * s_p[row * ld + kk];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
  }
  if (t == 0) {
    s_red[warp * kQRows + g] = part[0];
    s_red[warp * kQRows + g + 8] = part[1];
  }
  __syncthreads();
  if (tid < kQRows) {
    float d = 0.f;
    for (int w = 0; w < kWarps; ++w) d += s_red[w * kQRows + tid];
    s_d[tid] = d;
    if (tid < rows) row_d[stat0 + tid] = d;
  }

  // 3. dS in place of P, streaming dP over V again
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    stage_rows(s_kv, ldt, vb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    float c[4];
    dot_tile(c, fa, s_kv, ldt, key, ksteps, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2), kk = k0 + key + 2 * t + (e % 2);
      if (kk >= kpad) continue;
      float ds = 0.f;
      if (row < rows && kk < Sk) {
        const float p = s_p[row * ld + kk];
        ds = p * (c[e] + gcol_term(gb, kk, H) - s_d[row]);
        if (mask != nullptr) ds *= mask[mask_row0 + (size_t)row * Sk + kk];
        ds *= scale;
      }
      s_p[row * ld + kk] = ds;
    }
  }

  // 4. dQ = dS . K, dS in three bf16 terms
  const int d_tiles = D / 8;
  float acc[kRowNTiles][4];
#pragma unroll
  for (int i = 0; i < kRowNTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int k0 = 0; k0 < kpad; k0 += kKeyChunk) {
    __syncthreads();
    stage_rows(s_kv, ldt, kb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    const int n_ks = min(kKeyChunk, kpad - k0) / 16;
    for (int ks = 0; ks < n_ks; ++ks) {
      uint32_t a[3][4];
      const float* base = s_p + k0 + ks * 16;
      a_terms(a, 3, g, t, [&](int r, int c) { return base[r * ld + c]; });
      const bf16* krow = s_kv + (ks * 16 + lane % 16) * ldt;
#pragma unroll
      for (int i = 0; i < kRowNTiles; ++i) {
        const int nt = warp + kWarps * i;
        if (nt < d_tiles) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, krow + nt * 8);
          mma_terms(acc[i], a, 3, b0, b1);
        }
      }
    }
  }
  bf16* ob = dq + row0 * hd + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < kRowNTiles; ++i) {
    const int nt = warp + kWarps * i;
    if (nt >= d_tiles) continue;
    const int c = nt * 8 + 2 * t;
    if (g < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)g * hd + c) = pack_bf16(acc[i][0], acc[i][1]);
    if (g + 8 < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(g + 8) * hd + c) =
          pack_bf16(acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_cols_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ mask,
                       const bf16* __restrict__ dout, const float* __restrict__ gcol,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       const float* __restrict__ row_max,
                       const float* __restrict__ row_sum,
                       const float* __restrict__ row_d,
                       int Sq, int Sk, int H, int D, float scale, bool sm_bf16) {
  extern __shared__ float smem[];
  const int ldt = D + 8;
  float* s_pt = smem;                        // [16][kPLd] P of the q tile
  float* s_ds = s_pt + kQRows * kPLd;        // [16][kPLd] dS of the q tile
  float* s_stat = s_ds + kQRows * kPLd;      // [3][16] row max, sum, D
  bf16* s_k = reinterpret_cast<bf16*>(s_stat + 3 * kQRows);  // [64][ldt]
  bf16* s_v = s_k + kKeyTile * ldt;          // [64][ldt]
  bf16* s_q = s_v + kKeyTile * ldt;          // [16][ldt]
  bf16* s_do = s_q + kQRows * ldt;           // [16][ldt]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kKeyTile;
  const size_t hd = (size_t)H * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ksteps = D / 16, d_tiles = D / 8;
  const int key = 8 * warp;  // this warp's 8 keys for S and dP
  const int mt = warp % kColMTiles, ng = warp / kColMTiles;
  const size_t stat_b = ((size_t)b * H + h) * Sq;
  const float* gb = gcol == nullptr ? nullptr : gcol + (size_t)b * Sk;
  const int p_terms = sm_bf16 ? 1 : 3;  // P is exact in bf16 only in that mode

  stage_rows(s_k, ldt, k + ((size_t)b * Sk + k0) * hd + (size_t)h * D, hd,
             kKeyTile, Sk - k0, D);
  stage_rows(s_v, ldt, v + ((size_t)b * Sk + k0) * hd + (size_t)h * D, hd,
             kKeyTile, Sk - k0, D);

  float acc_dv[kColNTiles][4], acc_dk[kColNTiles][4];
#pragma unroll
  for (int i = 0; i < kColNTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[i][e] = acc_dk[i][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kQRows) {
    const int rows = min(kQRows, Sq - q0);
    const size_t row0 = (size_t)b * Sq + q0;
    __syncthreads();
    stage_rows(s_q, ldt, q + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);
    stage_rows(s_do, ldt, dout + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);
    if (tid < kQRows) {
      const bool real = tid < rows;
      const size_t i = stat_b + q0 + tid;
      s_stat[tid] = real ? row_max[i] : 0.f;
      s_stat[kQRows + tid] = real ? row_sum[i] : 1.f;
      s_stat[2 * kQRows + tid] = real ? row_d[i] : 0.f;
    }
    __syncthreads();

    // S and dP at this warp's 8 keys (the rows kernel's products, step for
    // step), then P and dS
    float cs[4] = {0.f, 0.f, 0.f, 0.f}, cp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4];
      const int boff = (key + g) * ldt + ks * 16 + 2 * t;
      a_rows(a, s_q, ldt, ks, g, t);
      mma_bf16(cs, a, ld32(s_k + boff), ld32(s_k + boff + 8));
      a_rows(a, s_do, ldt, ks, g, t);
      mma_bf16(cp, a, ld32(s_v + boff), ld32(s_v + boff + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e / 2), j = key + 2 * t + (e % 2), kk = k0 + j;
      float p = 0.f, ds = 0.f;
      if (row < rows && kk < Sk) {
        const size_t mrow = (row0 + row) * Sk;
        const float s = masked_score(cs[e], mask, mrow, kk, scale, sm_bf16);
        p = prob_from_stats(s, s_stat[row], s_stat[kQRows + row], sm_bf16);
        ds = p * (cp[e] + gcol_term(gb, kk, H) - s_stat[2 * kQRows + row]);
        if (mask != nullptr) ds *= mask[mrow + kk];
        ds *= scale;
      }
      s_pt[row * kPLd + j] = p;
      s_ds[row * kPLd + j] = ds;
    }
    __syncthreads();

    // dV += P^T . dO and dK += dS^T . Q over the tile's 16 rows
    uint32_t ap[3][4], as[3][4];
    const int kc = mt * 16;
    a_terms(ap, p_terms, g, t, [&](int r, int c) { return s_pt[c * kPLd + kc + r]; });
    a_terms(as, 3, g, t, [&](int r, int c) { return s_ds[c * kPLd + kc + r]; });
    const int brow = (lane % 16) * ldt;
#pragma unroll
    for (int i = 0; i < kColNTiles; ++i) {
      const int nt = ng + kColNGroups * i;
      if (nt < d_tiles) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, s_do + brow + nt * 8);
        mma_terms(acc_dv[i], ap, p_terms, b0, b1);
        ldmatrix_x2_trans(b0, b1, s_q + brow + nt * 8);
        mma_terms(acc_dk[i], as, 3, b0, b1);
      }
    }
  }

  const int key0 = k0 + mt * 16 + g;
  const size_t col0 = (size_t)h * D;
#pragma unroll
  for (int i = 0; i < kColNTiles; ++i) {
    const int nt = ng + kColNGroups * i;
    if (nt >= d_tiles) continue;
    const size_t c = col0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kk = key0 + 8 * half;
      if (kk >= Sk) continue;
      const size_t off = ((size_t)b * Sk + kk) * hd + c;
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(acc_dv[i][2 * half], acc_dv[i][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(acc_dk[i][2 * half], acc_dk[i][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// FMA kernels: fp32 inputs (the softmax is fp32 too), the same tiling.
// Thread (rg = tid / 64, col = tid % 64) takes rows rg*4 .. rg*4+3.

// fp32 dots of kFmaRows rows of `rows` (stride D) with `col` (stride 1), d
// ascending: the forward's FMA kernel sums its scores in the same order
__device__ __forceinline__ void dot_rows(float (&acc)[kFmaRows], const float* rows,
                                         const float* col, int D) {
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kv = col[d];
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) acc[r] = fmaf(rows[r * D + d], kv, acc[r]);
  }
}

// rows x D fp32 into shared memory with row stride ld, zero past `valid`
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          size_t hd, int rows, int valid, int D) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = r < valid ? src[(size_t)r * hd + d] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_fma(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ dout, const float* __restrict__ gcol,
                       float* __restrict__ dq, float* __restrict__ row_max,
                       float* __restrict__ row_sum, float* __restrict__ row_d,
                       int Sq, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  float* s_t = smem;                           // [16][D]: Q, then dO
  float* s_kv = s_t + kQRows * D;              // [kKeyChunk][D + 1]: K or V
  float* s_red = s_kv + kKeyChunk * (D + 1);   // [kWarps][kFmaRows]
  float* s_d = s_red + kWarps * kFmaRows;      // [16]
  float* s_p = s_d + kQRows;                   // [16][Sk]: P, then dS

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kQRows;
  const int rows = min(kQRows, Sq - q0);
  const size_t hd = (size_t)H * D;
  const int tid = threadIdx.x, col = tid % kKeyChunk, rg = tid / kKeyChunk;
  const float* kb = k + (size_t)b * Sk * hd + (size_t)h * D;
  const float* vb = v + (size_t)b * Sk * hd + (size_t)h * D;
  const size_t row0 = (size_t)b * Sq + q0;
  const size_t stat0 = ((size_t)b * H + h) * Sq + q0;
  const float* gb = gcol == nullptr ? nullptr : gcol + (size_t)b * Sk;
  const float* my_rows = s_t + rg * kFmaRows * D;

  stage_f32(s_t, D, q + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    stage_f32(s_kv, D + 1, kb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    float acc[kFmaRows];
    dot_rows(acc, my_rows, s_kv + col * (D + 1), D);
    const int kk = k0 + col;
    if (kk < Sk) {
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        const int row = rg * kFmaRows + r;
        s_p[row * Sk + kk] = masked_score(acc[r], row < rows ? mask : nullptr,
                                          (row0 + row) * Sk, kk, scale, false);
      }
    }
  }
  __syncthreads();
  softmax_rows(s_p, Sk, rows, Sk, false, row_max + stat0, row_sum + stat0);
  __syncthreads();
  stage_f32(s_t, D, dout + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);

  // D = rowsum(dP * P)
  float part[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) part[r] = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    stage_f32(s_kv, D + 1, vb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    float dp[kFmaRows];
    dot_rows(dp, my_rows, s_kv + col * (D + 1), D);
    const int kk = k0 + col;
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      const int row = rg * kFmaRows + r;
      if (row < rows && kk < Sk)
        part[r] += (dp[r] + gcol_term(gb, kk, H)) * s_p[row * Sk + kk];
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
    const float s = warp_sum(part[r]);
    if (lane == 0) s_red[warp * kFmaRows + r] = s;
  }
  __syncthreads();
  if (tid < kQRows) {  // row tid: its group's two warps, in order
    const int g2 = tid / kFmaRows, r = tid % kFmaRows;
    const float d = s_red[(2 * g2) * kFmaRows + r] + s_red[(2 * g2 + 1) * kFmaRows + r];
    s_d[tid] = d;
    if (tid < rows) row_d[stat0 + tid] = d;
  }

  // dS in place of P
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    stage_f32(s_kv, D + 1, vb + (size_t)k0 * hd, hd, kKeyChunk, Sk - k0, D);
    __syncthreads();
    float dp[kFmaRows];
    dot_rows(dp, my_rows, s_kv + col * (D + 1), D);
    const int kk = k0 + col;
    if (kk >= Sk) continue;
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      const int row = rg * kFmaRows + r;
      float ds = 0.f;
      if (row < rows) {
        const float p = s_p[row * Sk + kk];
        ds = p * (dp[r] + gcol_term(gb, kk, H) - s_d[row]);
        if (mask != nullptr) ds *= mask[(row0 + row) * Sk + kk];
        ds *= scale;
      }
      s_p[row * Sk + kk] = ds;
    }
  }

  // dQ = dS . K
  float acc[kFmaRows][kFmaCols];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
    for (int c = 0; c < kFmaCols; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += kKeyChunk) {
    __syncthreads();
    const int n = min(kKeyChunk, Sk - k0);
    stage_f32(s_kv, D + 1, kb + (size_t)k0 * hd, hd, n, n, D);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* krow = s_kv + j * (D + 1);
      float kv[kFmaCols];
#pragma unroll
      for (int c = 0; c < kFmaCols; ++c) {
        const int d = col + c * 64;
        kv[c] = d < D ? krow[d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        const float ds = s_p[(rg * kFmaRows + r) * Sk + k0 + j];
#pragma unroll
        for (int c = 0; c < kFmaCols; ++c) acc[r][c] = fmaf(ds, kv[c], acc[r][c]);
      }
    }
  }
  float* ob = dq + row0 * hd + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) {
    const int row = rg * kFmaRows + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < kFmaCols; ++c) {
      const int d = col + c * 64;
      if (d < D) ob[(size_t)row * hd + d] = acc[r][c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_cols_fma(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ dout, const float* __restrict__ gcol,
                       float* __restrict__ dk, float* __restrict__ dv,
                       const float* __restrict__ row_max,
                       const float* __restrict__ row_sum,
                       const float* __restrict__ row_d,
                       int Sq, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  float* s_k = smem;                              // [64][D + 1]
  float* s_v = s_k + kKeyTile * (D + 1);          // [64][D + 1]
  float* s_q = s_v + kKeyTile * (D + 1);          // [16][D]
  float* s_do = s_q + kQRows * D;                 // [16][D]
  float* s_pt = s_do + kQRows * D;                // [16][64]
  float* s_ds = s_pt + kQRows * kKeyTile;         // [16][64]
  float* s_stat = s_ds + kQRows * kKeyTile;       // [3][16]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kKeyTile;
  const size_t hd = (size_t)H * D;
  const int tid = threadIdx.x, col = tid % kKeyTile, rg = tid / kKeyTile;
  const int kk = k0 + col;  // this thread's key for S/dP, and for dK/dV
  const size_t stat_b = ((size_t)b * H + h) * Sq;
  const float* gb = gcol == nullptr ? nullptr : gcol + (size_t)b * Sk;

  stage_f32(s_k, D + 1, k + ((size_t)b * Sk + k0) * hd + (size_t)h * D, hd,
            kKeyTile, Sk - k0, D);
  stage_f32(s_v, D + 1, v + ((size_t)b * Sk + k0) * hd + (size_t)h * D, hd,
            kKeyTile, Sk - k0, D);

  float acc_dv[kFmaKCols], acc_dk[kFmaKCols];  // columns rg, rg + 4, ...
#pragma unroll
  for (int c = 0; c < kFmaKCols; ++c) acc_dv[c] = acc_dk[c] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += kQRows) {
    const int rows = min(kQRows, Sq - q0);
    const size_t row0 = (size_t)b * Sq + q0;
    __syncthreads();
    stage_f32(s_q, D, q + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);
    stage_f32(s_do, D, dout + row0 * hd + (size_t)h * D, hd, kQRows, rows, D);
    if (tid < kQRows) {
      const bool real = tid < rows;
      const size_t i = stat_b + q0 + tid;
      s_stat[tid] = real ? row_max[i] : 0.f;
      s_stat[kQRows + tid] = real ? row_sum[i] : 1.f;
      s_stat[2 * kQRows + tid] = real ? row_d[i] : 0.f;
    }
    __syncthreads();
    float sc[kFmaRows], dp[kFmaRows];
    dot_rows(sc, s_q + rg * kFmaRows * D, s_k + col * (D + 1), D);
    dot_rows(dp, s_do + rg * kFmaRows * D, s_v + col * (D + 1), D);
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      const int row = rg * kFmaRows + r;
      float p = 0.f, ds = 0.f;
      if (row < rows && kk < Sk) {
        const size_t mrow = (row0 + row) * Sk;
        const float s = masked_score(sc[r], mask, mrow, kk, scale, false);
        p = prob_from_stats(s, s_stat[row], s_stat[kQRows + row], false);
        ds = p * (dp[r] + gcol_term(gb, kk, H) - s_stat[2 * kQRows + row]);
        if (mask != nullptr) ds *= mask[mrow + kk];
        ds *= scale;
      }
      s_pt[row * kKeyTile + col] = p;
      s_ds[row * kKeyTile + col] = ds;
    }
    __syncthreads();
    for (int r = 0; r < kQRows; ++r) {
      const float p = s_pt[r * kKeyTile + col], ds = s_ds[r * kKeyTile + col];
#pragma unroll
      for (int c = 0; c < kFmaKCols; ++c) {
        const int d = rg + 4 * c;
        if (d < D) {
          acc_dv[c] = fmaf(p, s_do[r * D + d], acc_dv[c]);
          acc_dk[c] = fmaf(ds, s_q[r * D + d], acc_dk[c]);
        }
      }
    }
  }
  if (kk >= Sk) return;
  const size_t off = ((size_t)b * Sk + kk) * hd + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < kFmaKCols; ++c) {
    const int d = rg + 4 * c;
    if (d < D) {
      dv[off + d] = acc_dv[c];
      dk[off + d] = acc_dk[c];
    }
  }
}

size_t rows_smem(int Sk, int D, bool is_bf16) {
  if (is_bf16)
    return sizeof(float) * ((size_t)kQRows * mma_score_ld(Sk) + kWarps * kQRows + kQRows) +
           sizeof(bf16) * (size_t)(kQRows + kKeyChunk) * (D + 8);
  return sizeof(float) * ((size_t)kQRows * D + (size_t)kKeyChunk * (D + 1) +
                          kWarps * kFmaRows + kQRows + (size_t)kQRows * Sk);
}

size_t cols_smem(int D, bool is_bf16) {
  if (is_bf16)
    return sizeof(float) * (2 * kQRows * kPLd + 3 * kQRows) +
           sizeof(bf16) * (size_t)(2 * kKeyTile + 2 * kQRows) * (D + 8);
  return sizeof(float) * (2 * (size_t)kKeyTile * (D + 1) + 2 * (size_t)kQRows * D +
                          2 * kQRows * kKeyTile + 3 * kQRows);
}

}  // namespace

extern "C" {

// q/dout/dq: [B, Sq, H*D]; k/v/dk/dv: [B, Sk, H*D], all contiguous, fp32
// (is_bf16=0) or bf16 (is_bf16=1, D a multiple of 16). mask: [B, Sq, Sk]
// fp32 or NULL. gcol: [B, Sk] fp32 cotangent of the colsum, or NULL.
// stats: 3 * B * H * Sq fp32 workspace (row max, row sum, D). Launches both
// kernels on `stream` and returns a cudaError_t (0 on success).
int merlot_attention_bwd(const void* q, const void* k, const void* v,
                         const void* mask, const void* dout, const void* gcol,
                         void* dq, void* dk, void* dv, void* stats, int B, int Sq,
                         int Sk, int H, int D, int is_bf16, int softmax_fp32,
                         float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || Sq > kMaxSeq ||
      Sk > kMaxSeq || D > kMaxHeadDim || B > 65535 || H > 65535 ||
      (is_bf16 && D % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t r_smem = rows_smem(Sk, D, is_bf16), c_smem = cols_smem(D, is_bf16);
  if (r_smem > kMaxSmem || c_smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* gc = static_cast<const float*>(gcol);
  float* row_max = static_cast<float*>(stats);
  float* row_sum = row_max + (size_t)B * H * Sq;
  float* row_d = row_sum + (size_t)B * H * Sq;
  const dim3 rgrid((Sq + kQRows - 1) / kQRows, H, B);
  const dim3 cgrid((Sk + kKeyTile - 1) / kKeyTile, H, B);
  cudaError_t err;
  if (is_bf16) {
    const bool sm_bf16 = softmax_fp32 == 0;
    err = launch(attention_bwd_rows_mma, rgrid, kThreads, r_smem, st,
                 static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), m, static_cast<const bf16*>(dout), gc,
                 static_cast<bf16*>(dq), row_max, row_sum, row_d, Sq, Sk, H, D,
                 scale, sm_bf16);
    if (err != cudaSuccess) return (int)err;
    err = launch(attention_bwd_cols_mma, cgrid, kThreads, c_smem, st,
                 static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), m, static_cast<const bf16*>(dout), gc,
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
                 static_cast<const float*>(row_d), Sq, Sk, H, D, scale, sm_bf16);
  } else {
    err = launch(attention_bwd_rows_fma, rgrid, kThreads, r_smem, st,
                 static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), m, static_cast<const float*>(dout), gc,
                 static_cast<float*>(dq), row_max, row_sum, row_d, Sq, Sk, H, D, scale);
    if (err != cudaSuccess) return (int)err;
    err = launch(attention_bwd_cols_fma, cgrid, kThreads, c_smem, st,
                 static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), m, static_cast<const float*>(dout), gc,
                 static_cast<float*>(dk), static_cast<float*>(dv),
                 static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
                 static_cast<const float*>(row_d), Sq, Sk, H, D, scale);
  }
  return (int)err;
}

}  // extern "C"
