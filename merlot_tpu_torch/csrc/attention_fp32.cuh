// The fp32 routes of K1 (the attention forward, launched by
// attention_fwd_tiles.cuh's launch_fwd_tiles for K1 and K3's prefill) and
// K2 (the backward, attention_bwd.cu): fp32 inputs, fp32 softmax, every
// product on the CUDA cores' fp32 FMAs. Hopper has no tensor-core mode
// with fp32 rounding (TF32 keeps 10 mantissa bits), so these kernels are
// built for the FMA pipes.
//
// Tiles. A block of 256 threads owns 64 rows of one side (query rows in K1
// and K2's rows kernel, keys in K2's column kernel) and streams the other
// side in 64-row tiles through a ring of shared memory, loaded with
// cp.async (16-byte copies where the head dim is a multiple of 4). Rows are
// padded to DP + 4 floats (DP: the head dim rounded up to 16, the pad
// columns zero) so that the float4 loads of a warp fall in distinct banks.
// Thread (tr, tc) holds a 4 x 4 register block of each 64 x 64 product,
// rows tr + 16 i and columns tc + 16 j: every step of the head-dim loop
// loads 4 + 4 float4 and issues 64 FMAs, summing over d in ascending order
// as the plain version's dot products do. A warp holds 4 values of tr and 8
// of tc, so each of its float4 loads touches 4 or 8 rows: one 128-byte
// wavefront. A row's 16 threads (8 lanes of two warps) combine its max and
// sums by shuffles and then through shared memory. The second product of a
// tile (P . V, dS . K, P^T . dO, dS^T . Q) takes its left operand through a
// 64 x 64 tile in shared memory (row stride 72, so the four rows a warp
// writes land in different banks) and gives each thread 4 rows x DP / 16
// contiguous output columns: no FMA on a zero column at D = 64. No score
// row is kept: K1 runs two passes over the keys (the row max and rescaled
// sum, then P and ctx), K2's rows kernel two (D = rowsum(dP * P), then dS
// and dQ), K2's column kernel one over the q tiles (dV and dK), all from
// K1's saved row max and sum. The warps an SM holds set the pace more than
// the loads per FMA do: on the H100 at Grover training's shape, 8 x 4
// register blocks on 128 threads (fewer loads per FMA, half the warps) ran
// slower in both kernels, and K2 on a one-stage ring with two blocks per
// SM ran faster than on two stages with one.
//
// Masked tiles. mask_tile_classes sorts the mask's 64 x 64 tiles once per call
// (not per head): all 0, all 1, mixed. All-1 tiles read no mask; mixed ones
// read it from memory. An all-0 tile's scores are all exactly -1e10
// (s * 0 - 1e10 * 1 for finite s), so K1's first pass adds it to the row
// max and sum without reading K, and every later product of it is skipped
// when its probabilities p0 = exp(-1e10 - max) / sum are exactly 0 on every
// real row of the q tile, which holds when each such row has a key whose
// score is not -1e10: then it adds exactly 0 to ctx, the colsum and dV,
// and dS = P (dP - D) m scale is 0 wherever m = 0, so dQ and dK never need
// an all-0 tile. A q tile with a fully masked row (uniform over Sk, p0 =
// 1/Sk) keeps all its tiles. The test is on p0 itself, read from the row
// max and sum, so it is exact for any mask values.
//
// What bounds them on the H100: the operations. At Grover training's shape
// (B 8 x S 1536, 16 heads of 64, causal) K1's 2 products over the causal
// pairs take 0.58 ms at the 67 TFLOP/s fp32 peak and its bytes 0.08 ms;
// the kernel runs 3 products (S twice) over the 300 of 576 tiles per head
// that the causal mask does not zero, exp and the division per element in
// both passes, and re-reads K/V from L2 per 64 query rows.

#pragma once

#include "attention_common.cuh"

namespace merlot {
namespace f32 {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRM = 4;         // a thread's rows of a 64 x 64 product: tr + 16 i
constexpr int kRS = 16;        // their stride
constexpr int kCN = 4;         // its columns: tc + 16 j
constexpr int kCS = 16;
constexpr int kTile = 64;    // rows and keys of a tile
constexpr int kStages = 2;   // ring stages
constexpr int kPLd = 72;     // row stride of a P / dS tile in shared memory
constexpr int kMaxTiles = kMaxSeq / kTile;
constexpr int kListInts = 2 * kMaxTiles + 2;  // a block's load list and its counts

enum TileClass : uint8_t { kZero = 0, kOne = 1, kMixed = 2 };

__host__ __device__ constexpr int pad16(int D) { return (D + 15) / 16 * 16; }
__host__ __device__ constexpr int row_ld(int DP) { return DP + 4; }
__host__ __device__ constexpr int tile_floats(int DP) { return kTile * row_ld(DP); }
constexpr int kPFloats = kTile * kPLd;
inline int n_tiles(int n) { return (n + kTile - 1) / kTile; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest N has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, 64) of a tile, row r at src + r * ld_g, D columns, into dst
// [64][DP + 4]; rows at or past n are zeros, columns D.. are left alone
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t ld_g, int n,
                                          int D, bool vec) {
  constexpr int LD = row_ld(DP);
  if (vec) {
    const int c4 = D / 4;
    for (int i = threadIdx.x; i < kTile * c4; i += kThreads) {
      const int r = i / c4, c = 4 * (i - r * c4);
      float* d = dst + r * LD + c;
      if (r < n)
        cp_async16(d, src + (size_t)r * ld_g + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      float* d = dst + r * LD + c;
      if (r < n)
        cp_async4(d, src + (size_t)r * ld_g + c);
      else
        *d = 0.f;
    }
  }
}

// zeros in the pad columns D..DP-1 of n_buf consecutive tiles (the copies
// never write them)
template <int DP>
__device__ __forceinline__ void zero_pad(float* tiles, int n_buf, int D) {
  constexpr int LD = row_ld(DP);
  const int w = DP - D;
  for (int i = threadIdx.x; i < n_buf * kTile * w; i += kThreads) {
    const int r = i / w;
    tiles[r * LD + D + (i - r * w)] = 0.f;
  }
}

// acc[i][j] = row tr + 8 i of A . row tc + 16 j of B (A, B: [64][DP + 4]),
// fp32 FMAs with d ascending
template <int DP>
__device__ __forceinline__ void dot_tile(float (&acc)[kRM][kCN], const float* A,
                                         const float* B, int tr, int tc) {
  constexpr int LD = row_ld(DP);
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    float4 a[kRM], b[kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (tr + kRS * i) * LD + d);
#pragma unroll
    for (int j = 0; j < kCN; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tc + kCS * j) * LD + d);
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// NC contiguous floats from shared memory, in the widest aligned loads
template <int NC>
__device__ __forceinline__ void load_cols(float (&v)[NC], const float* p) {
  if constexpr (NC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < NC; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      v[c] = x.x, v[c + 1] = x.y, v[c + 2] = x.z, v[c + 3] = x.w;
    }
  } else if constexpr (NC % 2 == 0) {
#pragma unroll
    for (int c = 0; c < NC; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + c);
      v[c] = x.x, v[c + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = p[c];
  }
}

__device__ __forceinline__ float comp(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// acc[i][c] += sum over the 64 keys of L[tr + 8 i][key] * R[key][tc * NC + c]
// (L: [64][kPLd], R: [64][DP + 4]), keys ascending
template <int DP>
__device__ __forceinline__ void acc_tile(float (&acc)[kRM][DP / 16], const float* L,
                                         const float* R, int tr, int tc) {
  constexpr int NC = DP / 16, LD = row_ld(DP);
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 l[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      l[i] = *reinterpret_cast<const float4*>(L + (tr + kRS * i) * kPLd + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float r[NC];
      load_cols<NC>(r, R + (k + u) * LD + tc * NC);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float x = comp(l[i], u);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(x, r[c], acc[i][c]);
      }
    }
  }
}

// the masked score of an element, as the plain version rounds it (no
// contraction into an FMA): s * m - 1e10 * (1 - m)
__device__ __forceinline__ float mask_score(float s, float m) {
  return __fsub_rn(__fmul_rn(s, m), __fmul_rn(kMaskPenalty, __fsub_rn(1.f, m)));
}

// p from a row's max and sum, as K1 and K2 both compute it
__device__ __forceinline__ float prob32(float s, float mx, float sum, float rcp) {
  return div_rn(expf(s - mx), sum, rcp);
}

// a row's probability at a key of an all-0 tile
__device__ __forceinline__ float zero_tile_prob(float mx, float sum, float rcp) {
  return prob32(-kMaskPenalty, mx, sum, rcp);
}

// thread tid's rows tr + 8 i and columns tc + 16 j of a 64 x 64 product:
// a warp holds tr in 4 consecutive values and tc in 8
__device__ __forceinline__ void place(int tid, int& tr, int& tc) {
  const int w = tid / 32, l = tid % 32;
  tr = (w / 2) * 4 + l / 8;
  tc = (w % 2) * 8 + l % 8;
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// x[r] of this thread's rows combined by op over each row's 16 threads, in
// a fixed order: a butterfly over its 8 lanes, then the two warps' halves;
// s_red: 2 x 64 floats of shared memory. Every thread of the block calls it.
template <class Op>
__device__ __forceinline__ void row_combine(float (&x)[kRM], Op op, float* s_red, int tr,
                                            int tc) {
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) x[r] = op(x[r], __shfl_xor_sync(0xffffffffu, x[r], o));
  __syncthreads();
  if (tc % 8 == 0)
#pragma unroll
    for (int r = 0; r < kRM; ++r) s_red[(tc / 8) * kTile + tr + kRS * r] = x[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRM; ++r) x[r] = op(s_red[tr + kRS * r], s_red[kTile + tr + kRS * r]);
}

// ---------------------------------------------------------------------------
// K1, fp32: one block per (64 q rows, head, batch element)

struct FwdArgs {
  const float *q, *k, *v;  // k, v: head 0's keys / values (v offset by v_col0)
  const float* mask;       // [B or 1, Sq, Sk], or null
  const uint8_t* cls;      // its tile classes [B or 1][n_qt][n_kt] (null: no mask)
  float* out;
  float* colsum_part;      // [B, H, n_qt, Sk], or null
  float* stats;            // [2.., B, H, Sq]: row max, row sum; or null
  int Sq, Sk, H, D, kv_ld;
  size_t mask_bs;          // Sq * Sk, or 0 for one mask shared by the batch
  float scale;
  bool stats_only;         // pass 1 only
};

// K1's fp32 route (attention_fwd_f32.cu): the mask's tile classes into cls
// (when there is a mask), then the kernel
cudaError_t launch_fwd_f32(FwdArgs a, uint8_t* cls, int B, cudaStream_t st);

// ---------------------------------------------------------------------------
// K2, fp32 (attention_bwd_f32.cu): the rows kernel (D, then dS and dQ) and
// the column kernel (dV, dK), from K1's saved row max and sum

struct BwdF32Args {
  const float *q, *k, *v, *dout;
  const float* mask;     // [B, Sq, Sk], or null
  const uint8_t* cls;    // its tile classes [B][n_qt][n_kt] (null: no mask)
  const float* gcol;     // [B, Sk], or null
  float *dq, *dk, *dv;
  const float* row_max;  // [B, H, Sq] each: the forward's stats
  const float* row_sum;
  float* row_d;          // D = rowsum(dP * P), written by the rows kernel
  int Sq, Sk, H, D;
  float scale;
};

cudaError_t launch_bwd_f32(const BwdF32Args& a, int B, cudaStream_t st);

}  // namespace f32
}  // namespace merlot
