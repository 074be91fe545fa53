// Cached attention over the stacked KV cache for Hopper (sm_90a), plain C
// interface: K3.
//
// Replaces merlot_tpu/ops/pallas_attention.py `flash_attention_stacked`
// (`_flash_fwd` with v3=None: the Pallas kernel `_attn_kernel` reading keys
// and values from one buffer). It computes the function of K1
// (attention_fwd.cu) over Grover's serving cache:
//   q   [B, Sq, H*D]
//   kv  [B, Sk, 2*H*D]   keys in columns [:H*D], values in [H*D:]
//   mask fp32 [B or 1, Sq, Sk], multiplicative (1 = attend), or none
//   per head h:  s   = (q_h . k_h^T) * scale   fp32 dot products
//                s   = s*m - 1e10*(1-m)        (rounded to the softmax dtype)
//                p   = softmax(s)              fp32 max/exp/sum
//                ctx = round_T(p) . v_h        fp32 accumulation, stored as T
// T is fp32 or bf16; the server always asks for the fp32 softmax.
//
// The live length kv_len (1 <= kv_len <= Sk). The caller promises that the
// mask is 0 at every slot >= kv_len for every query row and that every
// query row attends to some slot below kv_len. A masked score is -1e10, so
// its exp(s - max) is exactly 0 in fp32 and its value adds nothing: the
// decode kernel reads only the slots below kv_len and gives the result over
// all Sk slots. Slots past kv_len are never read (they may hold anything).
//
// What bounds it on the H100. A decode step (Sq = 1) does 4*kv_len*D flops
// per head against 4*kv_len*D bytes of bf16 cache: one flop per byte, far
// below the ~295 at which the tensor cores would be the limit. So it is
// bound by reading the live part of the cache once: at B=8, kv_len=1101,
// H*D=1024 bf16 that is 36 MB, ~11 us at 3.35 TB/s, and the server makes 24
// such launches per token. Each head's key and value rows are 128-byte
// pieces of 4 KB cache rows.
//
// Design. Two paths, by the number of query rows:
//   - Sq <= 8 (decode): attention_decode, one thread-block cluster of C
//     blocks per (batch element, head), grid (C, H, B), 4 warps a block. C
//     comes from the launch plan (cuda_attention.decode_plan, the shape
//     alone: the smallest that gives every SM a block, 2 at B=8 and 16 at
//     B=1 with 16 heads). Block r of the cluster takes the keys
//     [r*n, min((r+1)*n, kv_len)), n = ceil(kv_len / C) rounded up to 8,
//     computed in the kernel from kv_len, so neither the grid nor the
//     shared memory depends on it.
//     Its key rows, then its value rows, of head h stream through a ring of
//     32-row stages (32 KB; 8-row boxes of a 3-D TMA map over the cache, row
//     stride 2*H*D, the values at column H*D + h*D; the last < 8 rows below
//     kv_len by 1-D bulk copies), one mbarrier per stage. Load i goes to
//     stage i % S and is read by warp i % 4 alone, which copies the stage
//     into registers and refills it at once: no block-wide barrier per
//     stage, and the value rows stream in while the softmax runs. A bigger
//     ring was slower: with more bytes requested at once every stage lands
//     later, as the memory system shares its rate among them.
//     Scores: LANES threads per key row (16 bytes each); a warp takes a
//     stage in LANES steps of 32 / LANES rows, all its loads issued
//     together, and a transposing sum (LANES - 1 shuffles) leaves each lane
//     one row's dot product, which it rounds and masks with the block's
//     slice of the mask (loaded while K streams in) into shared memory.
//     The softmax across the cluster at the TPU kernel's rounding points:
//     each block's row max m_r and sum of exp(s - m_r) (warps in order),
//     written into every rank's shared memory (DSMEM); after a cluster
//     barrier the cluster's max M (exact in any order) and sum, the C sums
//     rescaled by exp(m_r - M) and added in rank order (every block the
//     same bits; K1 rescales its running sum the same way); p =
//     round_sm(exp(s - M) / sum), rounded to T, by the warp that reads the
//     value stage. P.V with fp32 partials per thread, warps summed in a
//     fixed order; the block's partial context element e goes to rank
//     e % C, which adds the C partials in rank order after a second barrier
//     and stores them as T. Every remote access is a store before a
//     barrier, so no block reads another's memory after the last one.
//     Deterministic, no atomics.
//   - Sq > 8 (prefill): K1's tiled kernels (attention_fwd_tiles.cuh): for
//     bf16 the wgmma kernel (64-row q tiles, two passes over TMA-staged
//     64-key tiles, no score rows in shared memory), its K and V tensor
//     maps both over the cache (row stride 2*H*D, values from column H*D)
//     and one mask for the batch (mask_bs = 0); for fp32 the FMA kernel of
//     attention_fp32.cuh (the same strides; the mask's all-0 tiles, the
//     slots past the last query row, are skipped). kv_len does not change
//     its result.
// The first design (commit 83510f1) ran the decode as one 8-warp block per
// (head, batch element) over all Sk slots, scores, softmax and P.V in three
// serial phases: 16 blocks at B=1, and a block's value rows requested only
// after its softmax.

#include <cooperative_groups.h>

#include "attention_fwd_tiles.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace merlot;

constexpr int kDecodeRows = 8;   // Sq at or below this takes the decode kernel
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kBoxRows = 8;      // rows of a TMA box
constexpr int kStageRows = 32;   // key rows of a ring stage
constexpr int kRingBytes = 32 * 1024;  // the ring's size, at most (kDecWarps stages at least)
constexpr int kMaxStages = 32;   // a multiple of kDecWarps
constexpr int kMaxCluster = 16;
constexpr size_t kDecAlign = 128;  // TMA destinations are 128-byte aligned

__host__ __device__ inline size_t align_up(size_t n) {
  return (n + kDecAlign - 1) / kDecAlign * kDecAlign;
}

// rows of a block's key range at live length len: ceil(len / C), rounded up
// to a whole box
__host__ __device__ inline int chunk_rows(int len, int cluster) {
  const int n = (len + cluster - 1) / cluster;
  return (n + kBoxRows - 1) / kBoxRows * kBoxRows;
}

// stages of the ring: enough for all of a block's key and value rows at
// kv_len = Sk, at most kRingBytes, a multiple of kDecWarps (stage s is always
// read by warp s % kDecWarps)
__host__ __device__ inline int ring_stages(int Sk, int D, int elem, int cluster) {
  const int need = 2 * ((chunk_rows(Sk, cluster) + kStageRows - 1) / kStageRows);
  const int fit = kRingBytes / (kStageRows * D * elem);
  int n = need < fit ? need : fit;
  n = (n + kDecWarps - 1) / kDecWarps * kDecWarps;
  return n > kMaxStages ? kMaxStages : n;
}

// a decode block's shared memory; its score rows are sized for kv_len = Sk
struct DecodeLayout {
  size_t ring, p, red, gather, stat, wstat, bars, total;
  int stages, gather_ld;
};

__host__ __device__ inline DecodeLayout decode_layout(int Sq, int Sk, int D, int elem,
                                                      int cluster) {
  DecodeLayout l;
  l.stages = ring_stages(Sk, D, elem, cluster);
  l.gather_ld = (Sq * D + cluster - 1) / cluster;
  size_t o = 0;
  l.ring = o;   o += align_up((size_t)l.stages * kStageRows * D * elem);  // K, then V
  l.p = o;      o += align_up((size_t)Sq * chunk_rows(Sk, cluster) * 4);  // [Sq][rows]
  l.red = o;    o += align_up((size_t)kDecWarps * Sq * D * 4);           // warps' ctx
  l.gather = o; o += align_up((size_t)cluster * l.gather_ld * 4);        // ranks' ctx
  l.stat = o;   o += align_up(kMaxCluster * kDecodeRows * sizeof(float2));  // ranks' stats
  l.wstat = o;  o += align_up((kDecWarps + 1) * kDecodeRows * sizeof(float2));  // warps'
  l.bars = o;   o += kMaxStages * sizeof(uint64_t);
  l.total = o + kDecAlign;  // the dynamic base rounded up to kDecAlign
  return l;
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// the first half of a cluster barrier with no memory ordering
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

// Lane `sub` of a group of N lanes (N a power of two, consecutive lanes)
// holds its share v[k] of the dot products of N keys; afterwards it holds
// the whole dot product of key `sub`. Each round keeps half the values and
// trades the other half with the lane `half` away: N - 1 shuffles, not
// N log2 N, and the same pairs of partial sums as a butterfly over the
// group.
template <int N>
__device__ __forceinline__ float transpose_sum(float* v, int sub) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    constexpr int half = N / 2;
    const bool upper = (sub & half) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float keep = upper ? v[k + half] : v[k];
      const float send = upper ? v[k] : v[k + half];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
    return transpose_sum<half>(v, sub);
  }
}

// One cluster per (batch element, head), every query row (Sq <= MAXQ). A
// key row of the head is D elements = D / VE 16-byte vectors, read by
// LANES threads of a warp (that count rounded up to a power of two; the
// extra lanes read nothing), so a warp reads 32 / LANES rows at a time and
// a 32-row stage in LANES steps, all of whose loads are issued together.
template <typename T, int MAXQ, int LANES>
__global__ void __launch_bounds__(kDecThreads)
attention_decode(const __grid_constant__ CUtensorMap tm_kv, const T* __restrict__ q,
                 const T* __restrict__ kv, const float* __restrict__ mask,
                 T* __restrict__ out, int Sq, int Sk, int kv_len, int H, int D,
                 size_t mask_bs, float scale, bool sm_bf16) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int W = kDecWarps;
  constexpr int KPW = 32 / LANES;  // rows a warp reads at a time
  static_assert(kStageRows == 32, "a stage is LANES steps of KPW rows");
  extern __shared__ uint8_t dec_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // no block writes another's shared memory before every block has started
  cluster_arrive_relaxed();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const DecodeLayout l = decode_layout(Sq, Sk, D, (int)sizeof(T), C);
  const uint32_t pad = (uint32_t)(kDecAlign - (sm90::smem_u32(dec_smem) & (kDecAlign - 1))) &
                       (uint32_t)(kDecAlign - 1);
  uint8_t* base = dec_smem + pad;
  T* ring = reinterpret_cast<T*>(base + l.ring);
  float* s_p = reinterpret_cast<float*>(base + l.p);
  float* s_red = reinterpret_cast<float*>(base + l.red);
  float* s_gather = reinterpret_cast<float*>(base + l.gather);
  float2* s_stat = reinterpret_cast<float2*>(base + l.stat);    // [C][rows]: ranks' (max, sum)
  float2* s_wstat = reinterpret_cast<float2*>(base + l.wstat);  // [W][rows]: warps'; [W]: the row's
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + l.bars);

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = l.stages;
  const int ld = chunk_rows(Sk, C);          // row stride of s_p
  const int n = chunk_rows(kv_len, C);
  const int k0 = min(rank * n, kv_len);
  const int len = min(k0 + n, kv_len) - k0;  // this block's keys (may be 0)
  const int n_st = (len + kStageRows - 1) / kStageRows;  // stages of K, and of V
  const size_t hd = (size_t)H * D, row = 2 * hd;
  const uint32_t row_bytes = (uint32_t)(D * sizeof(T));
  const size_t stage_elems = (size_t)kStageRows * D;

  // 1. the block's stream: K's stages, then V's, through a ring of S stages,
  // each on its own barrier. Load i goes to stage i % S and is read by warp
  // i % W alone, which refills the stage with load i + S when done
  auto fetch = [&](int i) {
    if (i >= 2 * n_st) return;
    const int half = i >= n_st ? 1 : 0;
    const int r0 = (i - half * n_st) * kStageRows, rows = min(kStageRows, len - r0);
    T* dst = ring + (size_t)(i % S) * stage_elems;
    uint64_t* full = &bar[i % S];
    const int col = (int)(half * hd) + h * D;
    sm90::mbar_expect_tx(full, (uint32_t)rows * row_bytes);
    const int boxes = rows / kBoxRows;
    for (int x = 0; x < boxes; ++x)
      sm90::tma_load(dst + (size_t)x * kBoxRows * D, &tm_kv, full, col,
                     k0 + r0 + x * kBoxRows, b);
    for (int r = boxes * kBoxRows; r < rows; ++r)  // the last rows below kv_len
      sm90::bulk_load(dst + (size_t)r * D, kv + ((size_t)b * Sk + k0 + r0 + r) * row + col,
                      row_bytes, full);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) sm90::mbar_init(&bar[s], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < S; ++i) fetch(i);

  const int sub = lane % LANES;           // this thread's vector of the row
  const int grp = lane / LANES;           // this thread's row within the warp's
  const bool active = sub * VE < D;
  const size_t mask_b = (size_t)b * mask_bs;

  // the block's slice of the mask into s_p, its loads in flight with K's
  if (mask != nullptr) {
    for (int i = tid; i < Sq * len; i += kDecThreads) {
      const int r = i / len, j = i % len;
      s_p[(size_t)r * ld + j] = mask[mask_b + (size_t)r * Sk + k0 + j];
    }
  }
  float qf[MAXQ][VE];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) {
    if (r < Sq && active) {
      unpack(__ldg(reinterpret_cast<const uint4*>(q + ((size_t)b * Sq + r) * hd +
                                                   (size_t)h * D + sub * VE)),
             qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) qf[r][e] = 0.f;
    }
  }
  __syncthreads();

  // 2. the scores, each warp its stages: rounded, masked (by the slice in
  // s_p), into s_p. Step t of a stage reads rows t * KPW + grp; after the
  // transposing sum lane `sub` holds row sub * KPW + grp
  for (int i = warp; i < n_st; i += W) {
    const T* s_k = ring + (size_t)(i % S) * stage_elems;
    const int r0 = i * kStageRows, rows = min(kStageRows, len - r0);
    sm90::mbar_wait(&bar[i % S], (i / S) & 1);
    uint4 raw[LANES];
#pragma unroll
    for (int t = 0; t < LANES; ++t) {
      const int j = t * KPW + grp;
      raw[t] = active && j < rows
                   ? *reinterpret_cast<const uint4*>(s_k + (size_t)j * D + sub * VE)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    if (lane == 0) fetch(i + S);  // the stage is in registers
    const int jm = sub * KPW + grp;
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r < Sq) {
        float v[LANES];
#pragma unroll
        for (int t = 0; t < LANES; ++t) {
          float kf[VE];
          unpack(raw[t], kf);
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < VE; ++e) a = fmaf(qf[r][e], kf[e], a);
          v[t] = a;
        }
        const float sc = transpose_sum<LANES>(v, sub);
        if (jm < rows)
          s_p[(size_t)r * ld + r0 + jm] = masked_score(
              sc, mask != nullptr ? s_p : nullptr, (size_t)r * ld, r0 + jm, scale, sm_bf16);
      }
    }
  }
  __syncthreads();

  // 3. the softmax across the cluster: each block's row max m_r (warps in
  // order) and its sum of exp(s - m_r) (warps in order), written into every
  // rank's shared memory (slot: its rank) before a cluster barrier; after
  // it the cluster's max M (exact in any order) and sum, the ranks' sums
  // rescaled by exp(m_r - M) and added in rank order (as K1 rescales its
  // running sum); p = round_sm(exp(s - M) / sum), rounded to T for the
  // value product
  for (int r = 0; r < Sq; ++r) {
    float mx = -INFINITY;
    for (int j = tid; j < len; j += kDecThreads) mx = fmaxf(mx, s_p[(size_t)r * ld + j]);
    mx = warp_max(mx);
    if (lane == 0) s_wstat[warp * kDecodeRows + r].x = mx;
  }
  __syncthreads();
  for (int r = 0; r < Sq; ++r) {
    float mx = -INFINITY;
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, s_wstat[w * kDecodeRows + r].x);
    float sum = 0.f;
    for (int j = tid; j < len; j += kDecThreads) sum += expf(s_p[(size_t)r * ld + j] - mx);
    sum = warp_sum(sum);
    if (lane == 0) s_wstat[warp * kDecodeRows + r].y = sum;
  }
  __syncthreads();
  sm90::cluster_wait();  // every block of the cluster has started
  if (tid < Sq * C) {
    const int r = tid / C, k = tid % C;
    float mx = -INFINITY, sum = 0.f;
    for (int w = 0; w < W; ++w) {
      mx = fmaxf(mx, s_wstat[w * kDecodeRows + r].x);
      sum += s_wstat[w * kDecodeRows + r].y;
    }
    cluster.map_shared_rank(s_stat, k)[rank * kDecodeRows + r] = make_float2(mx, sum);
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
  for (int r = warp; r < Sq; r += W) {
    // ranks past C, and ranks with no keys, add exp(-inf) * 0 = 0
    const float2 st = lane < C ? s_stat[lane * kDecodeRows + r] : make_float2(-INFINITY, 0.f);
    const float mx = warp_max(st.x);
    const float part = st.y * expf(st.x - mx);
    float sum = 0.f;
    for (int k = 0; k < C; ++k) sum += __shfl_sync(0xffffffffu, part, k);
    if (lane == 0) s_wstat[W * kDecodeRows + r] = make_float2(mx, sum);
  }
  __syncthreads();

  // 4. the block's ctx = P . V, each warp its stages: first the stage's
  // probs (a lane per row, into s_p; the warp alone reads them), then
  // per-thread fp32 partials
  float acc[MAXQ][VE];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[r][e] = 0.f;
  for (int i = n_st + (warp - n_st % W + W) % W; i < 2 * n_st; i += W) {
    const T* s_v = ring + (size_t)(i % S) * stage_elems;
    const int r0 = (i - n_st) * kStageRows, rows = min(kStageRows, len - r0);
    sm90::mbar_wait(&bar[i % S], (i / S) & 1);
    uint4 raw[LANES];
#pragma unroll
    for (int t = 0; t < LANES; ++t) {
      const int j = t * KPW + grp;
      raw[t] = active && j < rows
                   ? *reinterpret_cast<const uint4*>(s_v + (size_t)j * D + sub * VE)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    if (lane == 0) fetch(i + S);  // the stage is in registers
    if (lane < rows) {
      for (int r = 0; r < Sq; ++r) {
        const float2 st = s_wstat[W * kDecodeRows + r];
        float* p = s_p + (size_t)r * ld + r0 + lane;
        *p = round_as<T>(prob_from_stats(*p, st.x, st.y, sm_bf16));
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < LANES; ++t) {
      const int j = t * KPW + grp;
      float vf[VE];
      unpack(raw[t], vf);
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        if (r < Sq) {
          const float p = j < rows ? s_p[(size_t)r * ld + r0 + j] : 0.f;
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
  }
  // the warp's row groups meet by shuffles (lanes with the same `sub`) ...
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < MAXQ; ++r)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  }
  if (grp == 0 && active) {
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r < Sq) {
#pragma unroll
        for (int e = 0; e < VE; ++e)
          s_red[((size_t)warp * Sq + r) * D + sub * VE + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  // ... the warps' sums are added in a fixed order, and element e of the
  // block's partial context goes to rank e % C ...
  for (int e = tid; e < Sq * D; e += kDecThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) t += s_red[(size_t)w * Sq * D + e];
    cluster.map_shared_rank(s_gather, e % C)[rank * l.gather_ld + e / C] = t;
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
  // ... which adds the cluster's partials of its elements in rank order.
  // Nothing reads another block's memory after the last barrier, so a
  // block may exit
  T* ob = out + (size_t)b * Sq * hd + (size_t)h * D;
  for (int j = tid; j * C + rank < Sq * D; j += kDecThreads) {
    float t = 0.f;
    for (int k = 0; k < C; ++k) t += s_gather[k * l.gather_ld + j];
    const int e = j * C + rank;
    ob[(size_t)(e / D) * hd + e % D] = from_float<T>(t);
  }
}

// The 3-D map of the cache [B, Sk, 2*H*D] of T in boxes of kBoxRows rows x
// D columns, no swizzle (the box lands as dense [8][D] rows)
template <typename T>
cudaError_t make_rows_map(CUtensorMap* map, const void* kv, int B, int Sk, int cols, int D) {
  static const sm90::EncodeTiledFn encode = sm90::load_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * sizeof(T),
                                 (cuuint64_t)Sk * cols * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(kv), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
using DecodeKernel = void (*)(CUtensorMap, const T*, const T*, const float*, T*, int, int,
                              int, int, int, size_t, float, bool);

// the decode kernel for Sq query rows and LANES = lanes per key row
template <typename T, int MAXQ>
DecodeKernel<T> decode_kernel_q(int lanes) {
  switch (lanes) {
    case 2: return attention_decode<T, MAXQ, 2>;
    case 4: return attention_decode<T, MAXQ, 4>;
    case 8: return attention_decode<T, MAXQ, 8>;
    case 16: return attention_decode<T, MAXQ, 16>;
    default: break;
  }
  if constexpr (sizeof(T) == 4) {  // bf16 rows are 2 to 16 vectors
    if (lanes == 1) return attention_decode<T, MAXQ, 1>;
    if (lanes == 32) return attention_decode<T, MAXQ, 32>;
  }
  return nullptr;
}

template <typename T>
DecodeKernel<T> decode_kernel(int Sq, int D) {
  constexpr int VE = 16 / sizeof(T);
  if (D % VE != 0 || D / VE > 32) return nullptr;
  int lanes = 1;
  while (lanes < D / VE) lanes <<= 1;
  return Sq == 1 ? decode_kernel_q<T, 1>(lanes) : decode_kernel_q<T, kDecodeRows>(lanes);
}

cudaLaunchConfig_t decode_config(int cluster, int B, int H, size_t smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t set_decode_attributes(DecodeKernel<T> kernel, int cluster, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

bool valid_cluster(int cluster) {
  return cluster >= 1 && cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0;
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* kv, const float* mask, void* out,
                          int B, int Sq, int Sk, int kv_len, int H, int D, size_t mask_bs,
                          float scale, bool sm_bf16, int cluster, cudaStream_t st) {
  const DecodeKernel<T> kernel = decode_kernel<T>(Sq, D);
  if (kernel == nullptr || !valid_cluster(cluster)) return cudaErrorInvalidValue;
  const size_t smem = decode_layout(Sq, Sk, D, (int)sizeof(T), cluster).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap tm;
  cudaError_t err = make_rows_map<T>(&tm, kv, B, Sk, 2 * H * D, D);
  if (err == cudaSuccess) err = set_decode_attributes<T>(kernel, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = decode_config(cluster, B, H, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, tm, static_cast<const T*>(q),
                           static_cast<const T*>(kv), mask, static_cast<T*>(out), Sq, Sk,
                           kv_len, H, D, mask_bs, scale, sm_bf16);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int max_clusters(int Sq, int Sk, int D, int cluster) {
  const DecodeKernel<T> kernel = decode_kernel<T>(Sq, D);
  const size_t smem = decode_layout(Sq, Sk, D, (int)sizeof(T), cluster).total;
  if (kernel == nullptr || smem > kMaxSmem ||
      set_decode_attributes<T>(kernel, cluster, smem) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = decode_config(cluster, 1, 1, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

bool valid_decode_shape(int Sq, int Sk, int D, int is_bf16, int cluster) {
  return Sq > 0 && Sq <= kDecodeRows && Sk > 0 && Sk <= kMaxSeq && D > 0 &&
         D <= kMaxHeadDim && (is_bf16 ? D % 16 == 0 : D % 4 == 0) && valid_cluster(cluster);
}

}  // namespace

extern "C" {

// Shared memory of one decode block (Sq <= 8 query rows, cache length Sk,
// head dim D, clusters of `cluster` blocks), or -1 for a shape the decode
// kernel does not take (the launch plan's check)
long merlot_attention_decode_smem(int Sq, int Sk, int D, int is_bf16, int cluster) {
  if (!valid_decode_shape(Sq, Sk, D, is_bf16, cluster)) return -1;
  return (long)decode_layout(Sq, Sk, D, is_bf16 ? 2 : 4, cluster).total;
}

// Clusters of that plan the card can hold at once (0: the cluster cannot be
// scheduled), or -1 if the query failed
int merlot_attention_decode_max_clusters(int Sq, int Sk, int D, int is_bf16, int cluster) {
  if (!valid_decode_shape(Sq, Sk, D, is_bf16, cluster)) return -1;
  return is_bf16 ? max_clusters<bf16>(Sq, Sk, D, cluster)
                 : max_clusters<float>(Sq, Sk, D, cluster);
}

// q/out: [B, Sq, H*D]; kv: [B, Sk, 2*H*D] with keys in columns [:H*D] and
// values in [H*D:]; all contiguous and 16-byte aligned, fp32 (is_bf16=0,
// D a multiple of 4) or bf16 (is_bf16=1, D a multiple of 16). mask: fp32
// [B, Sq, Sk] (mask_batched=1), one [1, Sq, Sk] for every batch element
// (mask_batched=0), or NULL. kv_len (1..Sk): the live slots; the mask must
// be 0 at every slot >= kv_len and leave every query row a slot below it
// (Sq <= 8 reads only the live slots; Sq > 8 reads all). cluster: the
// decode launch plan's blocks per (batch element, head), a power of two up
// to 16 (unused when Sq > 8). tile_class: for the fp32 prefill (Sq > 8)
// with a mask, (B or 1) * ceil(Sq / 64) * ceil(Sk / 64) bytes that receive
// the mask's tile classes; else ignored. Launches on `stream` and returns a
// cudaError_t (0 on success).
int merlot_attention_stacked_fwd(const void* q, const void* kv, const void* mask,
                                 void* out, void* tile_class, int B, int Sq, int Sk,
                                 int kv_len, int H, int D, int mask_batched, int is_bf16,
                                 int softmax_fp32, int cluster, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || Sq > kMaxSeq ||
      Sk > kMaxSeq || D > kMaxHeadDim || B > 65535 || H > 65535 || kv_len < 1 ||
      kv_len > Sk || (is_bf16 ? D % 16 != 0 : D % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const size_t mask_bs = mask_batched ? (size_t)Sq * Sk : 0;
  const bool sm_bf16 = is_bf16 && softmax_fp32 == 0;
  cudaError_t err;
  if (Sq <= kDecodeRows) {
    err = is_bf16 ? launch_decode<bf16>(q, kv, m, out, B, Sq, Sk, kv_len, H, D, mask_bs,
                                        scale, sm_bf16, cluster, st)
                  : launch_decode<float>(q, kv, m, out, B, Sq, Sk, kv_len, H, D, mask_bs,
                                         scale, sm_bf16, cluster, st);
  } else {
    err = launch_fwd_tiles(q, kv, kv, H * D, m, out, nullptr, nullptr,
                           static_cast<uint8_t*>(tile_class), B, Sq, Sk, H, D, 2 * H * D,
                           mask_bs, is_bf16 != 0, sm_bf16, scale, st);
  }
  return (int)err;
}

}  // extern "C"
