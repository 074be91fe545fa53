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

// the class of each 64 x 64 tile of a [Bm, Sq, Sk] mask, [Bm][n_qt][n_kt]:
// its real elements all 0, all 1, or anything else. Grid (n_kt, n_qt, Bm).
__global__ void __launch_bounds__(kThreads)
mask_tile_classes(const float* __restrict__ mask, uint8_t* __restrict__ cls, int Sq, int Sk) {
  const int kt = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int r0 = qt * kTile, k0 = kt * kTile;
  const int rows = min(kTile, Sq - r0), keys = min(kTile, Sk - k0);
  const float* m = mask + ((size_t)b * Sq + r0) * Sk + k0;
  bool zero = true, one = true;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    if (r < rows && c < keys) {
      const float x = m[(size_t)r * Sk + c];
      zero &= x == 0.f;
      one &= x == 1.f;
    }
  }
  zero = __syncthreads_and(zero);
  one = __syncthreads_and(one);
  if (threadIdx.x == 0)
    cls[((size_t)b * gridDim.y + qt) * gridDim.x + kt] = zero ? kZero : one ? kOne : kMixed;
}

inline cudaError_t launch_tile_classes(const float* mask, uint8_t* cls, int Bm, int Sq,
                                       int Sk, cudaStream_t st) {
  const dim3 grid(n_tiles(Sk), n_tiles(Sq), Bm);
  mask_tile_classes<<<grid, kThreads, 0, st>>>(mask, cls, Sq, Sk);
  return cudaGetLastError();
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

// Q, kStages x (K, V), the P tile, the load list
template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((1 + 2 * kStages) * tile_floats(DP) + kPFloats) +
         sizeof(int) * kListInts;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2) attention_fwd_f32(const FwdArgs a) {
  constexpr int NC = DP / 16, TF = tile_floats(DP);
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_ring = s_q + TF;  // stage st: K at 2 st, V at 2 st + 1
  float* s_p = s_ring + 2 * kStages * TF;
  int* s_list = reinterpret_cast<int*>(s_p + kPFloats);  // key tiles: pass 1, then pass 2

  const int n_qt = gridDim.x, qt = n_qt - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  int tr, tc;
  place(tid, tr, tc);
  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int q0 = qt * kTile, rows = min(kTile, Sq - q0);
  const int n_kt = (Sk + kTile - 1) / kTile;
  const size_t hd = (size_t)a.H * D;
  const bool vec = D % 4 == 0;
  const uint8_t* cls = a.cls == nullptr ? nullptr
                       : a.cls + ((a.mask_bs != 0 ? (size_t)b : 0) * n_qt + qt) * n_kt;
  const float* mb = a.mask == nullptr ? nullptr : a.mask + b * a.mask_bs + (size_t)q0 * Sk;
  const float* kb = a.k + (size_t)b * Sk * a.kv_ld + (size_t)h * D;
  const float* vb = a.v + (size_t)b * Sk * a.kv_ld + (size_t)h * D;

  // pass 1 visits the tiles that are not all 0 (s_list[0..n1)), and so
  // does pass 2 (s_list[kMaxTiles..]) unless a row's p0 != 0: then pass 2
  // is rebuilt below over every tile, in order
  if (tid == 0) {
    int n = 0;
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls == nullptr || cls[kt] != kZero) s_list[kMaxTiles + n] = s_list[n] = kt, ++n;
    s_list[kListInts - 1] = n;
  }
  zero_pad<DP>(s_q, 1 + 2 * kStages, D);
  __syncthreads();
  const int n1 = s_list[kListInts - 1];
  int n_loads = a.stats_only ? n1 : 2 * n1;

  auto fetch = [&](int i) {  // load i: K of s_list[i], or in pass 2 K and V
    if (i < n_loads) {
      const int k0 = s_list[i < n1 ? i : kMaxTiles + i - n1] * kTile;
      float* dst = s_ring + 2 * (i % kStages) * TF;
      load_tile<DP>(dst, kb + (size_t)k0 * a.kv_ld, a.kv_ld, Sk - k0, D, vec);
      if (i >= n1) load_tile<DP>(dst + TF, vb + (size_t)k0 * a.kv_ld, a.kv_ld, Sk - k0, D, vec);
    }
    cp_async_commit();
  };
  load_tile<DP>(s_q, a.q + ((size_t)b * Sq + q0) * hd + (size_t)h * D, hd, rows, D, vec);
  for (int i = 0; i < kStages; ++i) fetch(i);

  // the rounded, masked score of element (i, j) of the tile at k0 (class c)
  auto score = [&](float s, int c, int i, int key) {
    s *= a.scale;
    return c == kOne || tr + kRS * i >= rows ? s
                                            : mask_score(s, mb[(size_t)(tr + kRS * i) * Sk + key]);
  };

  // pass 1: each thread's running max and rescaled sum for its 8 rows over
  // its 4 keys of each tile; an all-0 tile adds -1e10 at its real keys
  float mx[kRM], sum[kRM], rcp[kRM];
  int zero_keys = 0;
  if (cls != nullptr)
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls[kt] == kZero)
        for (int j = 0; j < kCN; ++j) zero_keys += kt * kTile + tc + kCS * j < Sk;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    mx[i] = zero_keys > 0 ? -kMaskPenalty : -INFINITY;
    sum[i] = (float)zero_keys;
  }
  for (int i = 0; i < n1; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int kt = s_list[i], k0 = kt * kTile, c = cls == nullptr ? kOne : cls[kt];
    float s[kRM][kCN];
    dot_tile<DP>(s, s_q, s_ring + 2 * (i % kStages) * TF, tr, tc);
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      float v[kCN], m = mx[r];
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int key = k0 + tc + kCS * j;
        v[j] = key < Sk ? score(s[r][j], c, r, key) : -INFINITY;
        m = fmaxf(m, v[j]);
      }
      if (m != mx[r]) {
        sum[r] *= expf(mx[r] - m);
        mx[r] = m;
      }
      if (m != -INFINITY)
#pragma unroll
        for (int j = 0; j < kCN; ++j) sum[r] += expf(v[j] - m);
    }
    __syncthreads();
    fetch(i + kStages);
  }
  // the row's 16 threads combined (s_p is free until pass 2)
  float m[kRM];
#pragma unroll
  for (int r = 0; r < kRM; ++r) m[r] = mx[r];
  row_combine(m, Max(), s_p, tr, tc);
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    sum[r] = mx[r] == -INFINITY ? 0.f : mx[r] == m[r] ? sum[r] : sum[r] * expf(mx[r] - m[r]);
    mx[r] = m[r];
  }
  row_combine(sum, Sum(), s_p, tr, tc);
  bool nz = false;  // some real row's p0 != 0: pass 2 needs the all-0 tiles
  const bool any_zero = n1 < n_kt;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    rcp[r] = __frcp_rn(sum[r]);
    nz |= tr + kRS * r < rows && any_zero && zero_tile_prob(mx[r], sum[r], rcp[r]) != 0.f;
  }
  nz = __syncthreads_or(nz);
  if (a.stats != nullptr && tc == 0) {
    const size_t n = (size_t)gridDim.z * a.H * Sq, r0 = ((size_t)b * a.H + h) * Sq + q0;
    for (int r = 0; r < kRM; ++r)
      if (tr + kRS * r < rows) {
        a.stats[r0 + tr + kRS * r] = mx[r];
        a.stats[n + r0 + tr + kRS * r] = sum[r];
      }
  }
  if (a.stats_only) return;

  float* part = a.colsum_part == nullptr
                    ? nullptr
                    : a.colsum_part + (((size_t)b * a.H + h) * n_qt + qt) * Sk;
  if (nz) {
    // a row is fully masked, or its max is -1e10: pass 2 takes every tile,
    // the all-0 ones with their mask read; the ring restarts on that list
    cp_async_wait<0>();
    __syncthreads();
    if (tid == 0)
      for (int kt = 0; kt < n_kt; ++kt) s_list[kMaxTiles + kt] = kt;
    n_loads = n1 + n_kt;
    __syncthreads();
    for (int i = n1; i < n1 + kStages; ++i) fetch(i);
  } else if (part != nullptr && cls != nullptr) {
    // the skipped tiles' colsum partials are 0
    for (int kt = 0; kt < n_kt; ++kt)
      if (cls[kt] == kZero)
        for (int j = tid; j < kTile && kt * kTile + j < Sk; j += kThreads) part[kt * kTile + j] = 0.f;
  }

  // pass 2: P (0 at keys past Sk and on rows past Sq) into s_p, its column
  // sums, and ctx += P . V
  float o[kRM][NC];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  for (int i = n1; i < n_loads; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int kt = s_list[kMaxTiles + i - n1], k0 = kt * kTile;
    const int c = cls == nullptr ? kOne : cls[kt] == kZero ? kMixed : cls[kt];
    const float* s_k = s_ring + 2 * (i % kStages) * TF;
    float s[kRM][kCN];
    dot_tile<DP>(s, s_q, s_k, tr, tc);
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int key = k0 + tc + kCS * j;
        s_p[(tr + kRS * r) * kPLd + tc + kCS * j] =
            key < Sk && tr + kRS * r < rows ? prob32(score(s[r][j], c, r, key), mx[r], sum[r], rcp[r])
                                           : 0.f;
      }
    __syncthreads();
    if (part != nullptr && tid < kTile && k0 + tid < Sk) {
      float cs = 0.f;
      for (int r = 0; r < kTile; ++r) cs += s_p[r * kPLd + tid];
      part[k0 + tid] = cs;
    }
    acc_tile<DP>(o, s_p, s_k + TF, tr, tc);
    __syncthreads();
    fetch(i + kStages);
  }

  float* ob = a.out + ((size_t)b * Sq + q0) * hd + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    if (tr + kRS * r >= rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc * NC + c;
      if (col < D) ob[(size_t)(tr + kRS * r) * hd + col] = o[r][c];
    }
  }
}

template <int DP>
cudaError_t launch_fwd_f32_dp(const FwdArgs& a, int B, cudaStream_t st) {
  const dim3 grid(n_tiles(a.Sq), a.H, B);
  return launch(attention_fwd_f32<DP>, grid, kThreads, fwd_smem<DP>(), st, a);
}

// K1's fp32 route: the mask's tile classes (into cls, when there is a
// mask), then the kernel
inline cudaError_t launch_fwd_f32(FwdArgs a, uint8_t* cls, int B, cudaStream_t st) {
  if (a.mask != nullptr) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err =
        launch_tile_classes(a.mask, cls, a.mask_bs != 0 ? B : 1, a.Sq, a.Sk, st);
    if (err != cudaSuccess) return err;
    a.cls = cls;
  } else {
    a.cls = nullptr;
  }
  switch (pad16(a.D)) {
    case 16: return launch_fwd_f32_dp<16>(a, B, st);
    case 32: return launch_fwd_f32_dp<32>(a, B, st);
    case 48: return launch_fwd_f32_dp<48>(a, B, st);
    case 64: return launch_fwd_f32_dp<64>(a, B, st);
    case 80: return launch_fwd_f32_dp<80>(a, B, st);
    case 96: return launch_fwd_f32_dp<96>(a, B, st);
    case 112: return launch_fwd_f32_dp<112>(a, B, st);
    case 128: return launch_fwd_f32_dp<128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32
}  // namespace merlot
